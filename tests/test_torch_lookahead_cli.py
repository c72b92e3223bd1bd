"""The CLI with the window program's look-ahead: which runs take it, the
``-latency`` preset's lines and ``-samplefile`` dump against the JAX
package's CLI, and a ``-checkpoint`` interrupted after an early emission
and resumed."""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from rtlamr_tpu.cli.flags import build_flagset as jax_flagset
from rtlamr_tpu.cli.main import run as jax_run
from rtlamr_tpu_torch.cli.flags import build_flagset
from rtlamr_tpu_torch.cli.main import Receiver, main
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder.checkpoint import load_checkpoint
from rtlamr_tpu_torch.io.capture import FileSource
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import TRACER

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SAMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "sample.bin")
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")
# SCM with IDM registered: PacketLength is IDM's, so SCM packets have a
# look-ahead (the golden capture is at chip length 78)
GOLDEN = ["-msgtype=scm,idm", "-symbollength=78", "-latency", "-format=json",
          f"-fromfile={SAMPLE}"]
NB_ALL = ("scm", "scm+", "idm", "r900")


def port_cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, device="cpu")
    return rc, [TIMESTAMP.sub("<time>", ln) for ln in out.getvalue().splitlines()]


def jax_cli(argv):
    out = io.StringIO()
    fs = jax_flagset()
    fs.parse(argv)
    fs.env_override(log=lambda *a: None)
    rc = jax_run(fs, out=out)
    return rc, [TIMESTAMP.sub("<time>", ln) for ln in out.getvalue().splitlines()]


def receiver(argv):
    fs = build_flagset()
    fs.parse(argv)
    return Receiver(fs, device="cpu")


@pytest.mark.parametrize("argv, takes", [
    (["-msgtype=all", "-latency"], True),
    (["-msgtype=all", "-latency", "-windowblocks=16"], True),
    (["-msgtype=all", "-latency", "-samplefile=DUMP"], True),
    (["-msgtype=all"], True),
    (["-msgtype=scm", "-latency"], False),  # PacketLength is SCM's own: nothing to look ahead
])
def test_which_runs_take_the_lookahead(argv, takes, tmp_path):
    """A single-card receiver looks ahead, in either preset, when some
    group's packets are shorter than PacketLength."""
    argv = [a.replace("DUMP", str(tmp_path / "dump.bin")) for a in argv]
    dec = receiver(argv).decoder
    assert type(dec) is WindowDecoder and dec.lookahead == takes


@pytest.mark.parametrize("samplefile", [False, True])
def test_lines_and_dump_match_jax(samplefile, tmp_path):
    """Under ``-latency``, with the look-ahead engaged (its span entered,
    in no window's root), the lines, every Offset and Length among them, and the
    ``-samplefile`` dump's bytes are the JAX package's CLI's: the dump
    after a block is written once its bytes are read."""
    extra = [f"-samplefile={tmp_path / 'dump.bin'}"] if samplefile else []
    jextra = [f"-samplefile={tmp_path / 'jdump.bin'}"] if samplefile else []
    TRACER.reset()
    observability.enable()
    try:
        rc, got = port_cli(GOLDEN + extra)
        engaged = TRACER.snapshot().totals.get("pipeline.lookahead", (0,))[0]
        roots = [r.window for r in TRACER.records if r.name == "cli.window"]
        ahead = [r for r in TRACER.records if r.name == "pipeline.lookahead"]
    finally:
        observability.disable()
        TRACER.reset()
    jrc, want = jax_cli(GOLDEN + jextra)
    assert rc == jrc == 0 and got == want and len(got) >= 8
    # The look-ahead's span lies in no window: each window's root opens and
    # closes once.
    assert engaged == len(ahead) > 0 and {(r.window, r.parent) for r in ahead} == {(-1, None)}
    assert roots == sorted(set(roots)) and len(roots) > engaged
    if samplefile:
        assert {json.loads(ln)["Offset"] for ln in got} != {0}
        assert (tmp_path / "dump.bin").read_bytes() == (tmp_path / "jdump.bin").read_bytes()


def capture(chip=8, blocks=24 * 8):
    """The four types in turn, a packet every PacketLength + a block."""
    cfg = build_decoder_config([new_parser(n, chip) for n in NB_ALL])
    rng = np.random.default_rng(41)
    bursts, q, i = [], 2 * cfg.block_size, 0
    lead = cfg.packet_length + cfg.symbol_length
    while q + cfg.packet_length < (blocks - 2) * cfg.block_size:
        kind, at = NB_ALL[i % 4], q + int(rng.integers(cfg.block_size)) - lead
        if kind == "scm":
            b = synth.bits_to_burst(synth.make_scm_bits(meter_id=100000 + i, consumption=i), at)
        elif kind == "scm+":
            b = synth.bits_to_burst(synth.make_scmplus_bits(endpoint_id=200000 + i), at)
        elif kind == "idm":
            b = synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), at)
        else:
            b = synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), at)
        bursts.append(b)
        q += cfg.packet_length + cfg.block_size
        i += 1
    return synth.render_iq(blocks * cfg.block_size, bursts, chip, noise=2.0, seed=41)


def test_checkpoint_interrupt_after_an_early_emission(tmp_path, monkeypatch):
    """``-latency -checkpoint`` (4-block windows, a 20-block look-ahead at
    chip length 8): interrupted right after the look-ahead emitted a block
    of the window under way, the run saves the window boundary before that
    block and the last block it emitted; the resumed run reads that block
    again and neither repeats nor loses a line, Offset and Length
    included."""
    data = capture()
    cap = tmp_path / "cap.bin"
    data.tofile(cap)
    argv = [f"-msgtype={','.join(NB_ALL)}", "-symbollength=8", "-latency", "-format=json",
            f"-fromfile={cap}", f"-checkpoint={tmp_path / 'ck'}", "-ingest=python"]
    rc, want = port_cli(argv)
    assert rc == 0 and len(want) >= 5 and not os.path.exists(tmp_path / "ck.meta.json")

    # The first read after which a message of the window under way is out.
    dec = WindowDecoder([new_parser(n, 8) for n in NB_ALL], window_blocks=4, device="cpu")
    step = dec.cfg.block_size2
    out = [dec.feed(data[k * step : (k + 1) * step]) + dec.drain()
           for k in range(data.size // step)]
    reads = next(k + 1 for k, msgs in enumerate(out) if msgs and k % 4 != 3)
    orig_read = FileSource.read
    calls = {"n": 0}

    def flaky_read(self, n):
        calls["n"] += 1
        if calls["n"] > reads:
            raise KeyboardInterrupt
        return orig_read(self, n)

    with monkeypatch.context() as mp:
        mp.setattr(FileSource, "read", flaky_read)
        rc, got = port_cli(argv)
    saved = load_checkpoint(str(tmp_path / "ck"))
    assert rc == 0 and saved.byte_offset == (reads - 1) // 4 * 4 * step  # the window boundary
    assert saved.lookahead_mark is not None and saved.lookahead_mark >= reads - 1
    rc, rest = port_cli(argv)
    assert rc == 0 and got + rest == want and 0 < len(got) < len(want)
    assert not os.path.exists(tmp_path / "ck.meta.json")
