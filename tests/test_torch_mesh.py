"""The port's time-sharded ``MeshDecoder`` (rtlamr_tpu_torch/parallel/mesh.py)
and ``-mesh`` in its CLI: exact (block, message) streams equal to the JAX
package's ``MeshDecoder`` on conftest's virtual CPU devices and to the port's
``WindowDecoder``, for packets on shard boundaries, a carry over several
super-batches, every protocol, a partial last super-batch and an overflowed
window at a shard's first position; ``dryrun`` at 2, 4 and 8 shards; the
mesh checkpoint both ways with the JAX package and its refusals; the CLI's
``-mesh`` and ``-mesh -checkpoint``.

The port runs ``n`` shards on ``["cpu"] * n``. The JAX package is imported
inside the tests that use it, so the ``cuda`` test runs on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_mesh.py -m cuda``."""

from __future__ import annotations

import contextlib
import io
import os
import re
import signal

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder.checkpoint import (
    Checkpoint,
    capture_checkpoint,
    load_checkpoint,
    restore_checkpoint,
)
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.parallel.mesh import MeshDecoder, dryrun, stage_superbatch
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

CHIP = 8  # the smallest chip length keeps shapes tiny on the CPU
ALL = ("scm", "scm+", "idm", "r900")
SAMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "sample.bin")
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")


def as_list(msgs):
    return [(b, str(m)) for b, m in msgs]


def port_mesh(names, n, window_blocks=None, max_hits=256, device="cpu"):
    return MeshDecoder([new_parser(x, CHIP) for x in names], devices=[device] * n,
                       window_blocks=window_blocks, max_hits=max_hits)


def port_window(names, window_blocks, max_hits=256, device="cpu"):
    return WindowDecoder([new_parser(x, CHIP) for x in names], window_blocks=window_blocks,
                         max_hits=max_hits, device=device)


def jax_mesh(names, n, window_blocks=None, max_hits=256):
    import jax

    from rtlamr_tpu.parallel.mesh import MeshDecoder as JaxMesh
    from rtlamr_tpu.protocols import new_parser as jax_parser

    return JaxMesh([jax_parser(x, CHIP) for x in names], devices=jax.devices()[:n],
                   window_blocks=window_blocks, max_hits=max_hits)


def scm(meter_id, offset):
    return synth.bits_to_burst(synth.make_scm_bits(meter_id=meter_id, consumption=meter_id % 97),
                               offset)


def cap_boundary_packets(dec):
    """SCM packets across every window boundary of two super-batches."""
    w = dec.spec.window
    half = 96 * dec.cfg.symbol_length // 2
    n_win = 2 * dec.n_devices * dec.scan_windows
    bursts = [scm(1000 + i, i * w - half) for i in range(1, n_win)]
    return synth.render_iq(n_win * w, bursts, CHIP, noise=2.0, seed=9)


def cap_carry(dec):
    """3.5 super-batches, an SCM packet straddling each super-batch boundary
    and one inside each shard."""
    w = dec.spec.window
    span = dec.n_devices * dec.scan_windows * w
    half = 96 * dec.cfg.symbol_length // 2
    bursts = [scm(5000 + i, i * span - half) for i in range(1, 4)]
    bursts += [scm(6000 + i, i * dec.scan_windows * w + w // 2) for i in range(7)]
    return synth.render_iq(3 * span + span // 2, bursts, CHIP, noise=2.0, seed=10)


def cap_all_protocols(dec):
    """Every protocol of ALL in turn, a burst every PacketLength + 1 block,
    over two super-batches and a half."""
    cfg = dec.cfg
    span = dec.n_devices * dec.scan_windows * dec.spec.window
    total = 2 * span + span // 2
    bursts, offset, i = [], cfg.block_size // 2, 0
    while offset + cfg.packet_length < total - cfg.block_size:
        kind = ALL[i % len(ALL)]
        if kind == "scm":
            bursts.append(scm(100000 + i, offset))
        elif kind == "scm+":
            bursts.append(synth.bits_to_burst(
                synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i), offset))
        elif kind == "idm":
            bursts.append(synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), offset))
        else:
            bursts.append(synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), offset))
        offset += cfg.packet_length + cfg.block_size
        i += 1
    return synth.render_iq(total, bursts, CHIP, noise=2.0, seed=11)


def cap_partial(dec):
    """One super-batch, three windows and 5.5 blocks: the flush decodes a
    partial super-batch whose valid blocks end inside shard 1."""
    w, bs = dec.spec.window, dec.cfg.block_size
    span = dec.n_devices * dec.scan_windows * w
    total = span + 3 * w + 5 * bs + bs // 2
    bursts = [scm(7000 + i, span + i * w + bs // 3) for i in range(3)]
    bursts.append(scm(7100, span + 3 * w + 10))  # in the last valid blocks
    bursts.append(scm(7200, span - 96 * dec.cfg.symbol_length // 2))
    return synth.render_iq(total, bursts, CHIP, noise=2.0, seed=12)


def cap_overflow_first(dec):
    """Window K (shard 1's first) holds two SCM packets and the end of one
    straddling its left edge: with one candidate slot it overflows, and its
    escalation needs the halo from shard 0's last window."""
    w, k = dec.spec.window, dec.scan_windows
    half = 96 * dec.cfg.symbol_length // 2
    edge = k * w
    bursts = [scm(8000, edge - half), scm(8001, edge + half + 100),
              scm(8002, edge + 3 * half + 300), scm(8003, w // 3)]
    return synth.render_iq(2 * dec.n_devices * k * w, bursts, CHIP, noise=2.0, seed=13)


CASES = {
    # name: (protocols, shards, window_blocks, max_hits, capture)
    "boundary_packets": (("scm",), 4, None, 256, cap_boundary_packets),
    "carry_over_superbatches": (("scm",), 2, None, 256, cap_carry),
    "all_protocols": (ALL, 2, None, 256, cap_all_protocols),
    "partial_last_superbatch": (("scm",), 4, 8, 256, cap_partial),
    "overflow_at_shard_start": (("scm",), 2, 8, 1, cap_overflow_first),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_matches_jax_mesh_and_window_decoder(case):
    names, n, window_blocks, max_hits, make_capture = CASES[case]
    dec = port_mesh(names, n, window_blocks, max_hits)
    iq = make_capture(dec)
    got = as_list(dec.decode_capture(iq))
    assert len(got) >= 3
    want_jax = as_list(jax_mesh(names, n, window_blocks, max_hits).decode_capture(iq))
    assert got == want_jax
    single = port_window(names, dec.spec.window // dec.cfg.block_size, max_hits)
    assert got == as_list(single.decode_capture(iq))
    oracle = ReferenceDecoder([new_parser(x, CHIP) for x in names], arithmetic="int")
    assert got == as_list(oracle.decode_capture(iq))
    if case == "overflow_at_shard_start":
        assert dec.metrics.hit_overflows > 0
    if case == "partial_last_superbatch":
        assert iq.size % dec.window_bytes and any("7100" in m for _, m in got)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun(n):
    # scm + idm + r900 in noise, a shard-boundary packet and a
    # super-batch-boundary packet: 5 messages, each exactly once.
    assert dryrun(n, device="cpu") == 5


def test_stage_superbatch_is_the_window_decoders_staging(monkeypatch):
    """The super-batch is staged in the JAX layout (each shard's window 0
    with a zero halo); once the halo ring has filled those, every window
    the mesh decodes equals the buffer WindowDecoder stages for it, on all
    that a stencil reads (from pad_shift on), over two super-batches, so
    the carry crosses one; the pad_shift samples before are zero."""
    from rtlamr_tpu_torch.decoder import pipeline
    from rtlamr_tpu_torch.parallel import mesh

    dec = port_mesh(("scm",), 2, window_blocks=4)
    spec = dec.spec
    w, ps, hs = spec.window, spec.pad_shift, spec.halo_staged
    rng = np.random.default_rng(5)
    iq = rng.integers(0, 256, 2 * (2 * 2 * 2 * w), dtype=np.uint8)
    sb = stage_superbatch(spec, iq[: dec.window_bytes], 2, 2)
    assert not sb[:, 0, :hs].any() and not sb[:, 1, :ps].any()
    with pytest.raises(ValueError):
        stage_superbatch(spec, iq[: dec.window_bytes - 2], 2, 2)

    seen = {"mesh": [], "window": []}
    scan, single = mesh.decode_windows_scan, pipeline.decode_window_staged_packed
    monkeypatch.setattr(mesh, "decode_windows_scan", lambda sp, windows, firsts: (
        seen["mesh"].extend(x.numpy().copy() for x in windows), scan(sp, windows, firsts))[1])
    monkeypatch.setattr(pipeline, "decode_window_staged_packed", lambda sp, st, first: (
        seen["window"].append(st.numpy().copy()), single(sp, st, first))[1])
    dec.decode_capture(iq)
    port_window(("scm",), 4).decode_capture(iq)
    assert len(seen["mesh"]) == len(seen["window"]) == 8
    for got, want in zip(seen["mesh"], seen["window"]):
        assert np.array_equal(got[ps:], want[ps:]) and not got[:ps].any()


def test_mesh_needs_a_card_or_explicit_devices():
    """``devices=None`` means every card and raises without one: the
    decoder never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshDecoder([new_parser("scm", CHIP)])
    with pytest.raises(ValueError, match="window must cover the halo"):
        MeshDecoder([new_parser("scm", CHIP)], devices=["cpu"], window_blocks=1)
    assert port_mesh(("scm",), 3).window_bytes == 2 * 3 * 2 * port_mesh(("scm",), 1).spec.window


# ---------------------------------------------------------------------------
# Checkpoints


def discard_pending(dec) -> int:
    """``dec.discard_pending()``: the bytes fed since the last whole window
    dropped, their count. The JAX package's decoders have no such method, so
    their queue is emptied here."""
    if hasattr(dec, "discard_pending"):
        return dec.discard_pending()
    n = dec._pending.size
    dec._pending = np.zeros(0, np.uint8)
    return n


def split_run(writer, reader, data, cut, path):
    """Feed ``data[:cut]`` into ``writer`` (decoder, capture), checkpoint at
    its super-batch boundary, save; load and restore into ``reader``
    (decoder, load, restore), feed the rest and flush. (stream, boundary)."""
    a, capture = writer
    got = as_list(a.feed(data[:cut])) + as_list(a.drain())
    boundary = cut - discard_pending(a)
    capture(a, boundary).save(path)
    b, load, restore = reader
    restore(b, load(path))
    got += as_list(b.feed(data[boundary:])) + as_list(b.flush())
    return got, boundary


def jax_checkpoint_api():
    from rtlamr_tpu.decoder import checkpoint as jck

    return jck.capture_checkpoint, jck.load_checkpoint, jck.restore_checkpoint


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_mesh_checkpoint_resumes_across_packages(direction, tmp_path):
    """A port MeshDecoder's checkpoint (kind "window", the (halo,) tail)
    resumes in the JAX MeshDecoder and the JAX one's in the port, cut
    inside the second super-batch; each equals the straight stream."""
    names, n = ALL, 2
    dec = port_mesh(names, n)
    iq = cap_all_protocols(dec)
    want = as_list(dec.decode_capture(iq))
    cut = dec.window_bytes + dec.window_bytes // 3 + 1
    j_capture, j_load, j_restore = jax_checkpoint_api()
    port_w = (port_mesh(names, n), capture_checkpoint)
    port_r = (port_mesh(names, n), load_checkpoint, restore_checkpoint)
    writer, reader = {
        "port_to_jax": (port_w, (jax_mesh(names, n), j_load, j_restore)),
        "jax_to_port": ((jax_mesh(names, n), j_capture), port_r),
        "port_to_port": (port_w, port_r),
    }[direction]
    path = str(tmp_path / "ck")
    got, boundary = split_run(writer, reader, iq, cut, path)
    assert boundary == dec.window_bytes
    assert got == want and len(want) >= 6
    saved = load_checkpoint(path)
    assert isinstance(saved, Checkpoint)
    assert saved.carry.shape == (dec.spec.halo,) and saved.window_index == n * 2


def test_mesh_checkpoint_geometry_refusals(tmp_path):
    """A mesh checkpoint into a single-device decoder, or the reverse, is a
    geometry mismatch, as in the JAX package."""
    names = ("scm",)
    mesh = port_mesh(names, 2, window_blocks=8)
    single = port_window(names, 8)
    assert mesh.spec.halo != mesh.spec.halo_staged
    capture_checkpoint(mesh, 0).save(str(tmp_path / "mesh"))
    capture_checkpoint(single, 0).save(str(tmp_path / "single"))
    with pytest.raises(ValueError, match="geometry mismatch.*resume it with -mesh"):
        restore_checkpoint(port_window(names, 8), load_checkpoint(str(tmp_path / "mesh")))
    with pytest.raises(ValueError, match="geometry mismatch.*resume it without -mesh"):
        restore_checkpoint(port_mesh(names, 2, window_blocks=8),
                           load_checkpoint(str(tmp_path / "single")))
    with pytest.raises(ValueError, match="geometry mismatch.*window"):
        restore_checkpoint(port_mesh(names, 2, window_blocks=16),
                           load_checkpoint(str(tmp_path / "mesh")))
    # The JAX package refuses them alike.
    _, j_load, j_restore = jax_checkpoint_api()
    with pytest.raises(ValueError, match="geometry mismatch"):
        j_restore(jax_mesh(names, 2, window_blocks=8), j_load(str(tmp_path / "single")))


# ---------------------------------------------------------------------------
# CLI


def cli(argv, device):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, device=device)
    return rc, [TIMESTAMP.sub("<time>", ln) for ln in out.getvalue().splitlines()], err.getvalue()


GOLDEN = ["-msgtype=scm", "-symbollength=78", "-windowblocks=8", "-format=json",
          f"-fromfile={SAMPLE}"]


@pytest.mark.parametrize("n", [1, 4])
def test_cli_mesh_equals_plain(n):
    rc, want, _ = cli(GOLDEN, "cpu")
    assert rc == 0 and len(want) == 14
    rc, got, err = cli(GOLDEN + ["-mesh"], ["cpu"] * n)
    assert rc == 0 and got == want
    assert f"mesh: {n} devices" in err


def test_cli_mesh_checkpoint_interrupt_resume(tmp_path, monkeypatch):
    """SIGINT during the second super-batch of a ``-mesh -checkpoint`` run:
    the run stops at that feed's boundary and saves a mesh checkpoint; the
    resumed run follows on exactly; a run to the end leaves none."""
    data = cap_all_protocols(port_mesh(ALL, 2, window_blocks=24))
    cap = tmp_path / "cap.bin"
    data.tofile(cap)
    ck = str(tmp_path / "ck")
    argv = ["-msgtype=" + ",".join(ALL), "-symbollength=8", "-windowblocks=24", "-mesh",
            "-format=json", f"-fromfile={cap}", f"-checkpoint={ck}"]
    devices = ["cpu"] * 2
    rc, want, _ = cli(argv, devices)
    assert rc == 0 and len(want) >= 6 and not os.path.exists(ck + ".meta.json")
    orig = MeshDecoder._process_window
    calls = {"n": 0}

    def process(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGINT)
        return orig(self, *args, **kwargs)

    stray = []
    old = signal.signal(signal.SIGINT, lambda *_: stray.append(True))
    try:
        with monkeypatch.context() as mp:
            mp.setattr(MeshDecoder, "_process_window", process)
            rc, head, err = cli(argv, devices)
    finally:
        signal.signal(signal.SIGINT, old)
    assert rc == 0 and not stray and "interrupted" in err
    saved = load_checkpoint(ck)
    assert saved.carry.shape == (port_mesh(ALL, 2, window_blocks=24).spec.halo,)
    assert saved.byte_offset % (2 * 2 * 2 * 24 * 512) == 0 and saved.byte_offset > 0
    rc, tail, err = cli(argv, devices)
    assert rc == 0 and f"resumed from checkpoint at byte {saved.byte_offset}" in err
    assert head + tail == want and 0 < len(head) < len(want)
    assert not os.path.exists(ck + ".meta.json")


def test_cli_mesh_refusals(capsys):
    """A device list without -mesh, and -mesh with fewer than one channel,
    are refused."""
    with pytest.raises(SystemExit) as exc:
        main(GOLDEN + ["-channels=0", "-mesh"], device=["cpu"] * 2)
    assert exc.value.code == 1 and "invalid -channels value 0" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs -mesh"):
        main(GOLDEN, device=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs -mesh"):
        main(GOLDEN + ["-channels=4"], device=["cpu"] * 2)


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.cuda
def test_cuda_mesh_matches_window_decoder():
    """On the card, through K1: 1 and 2 shards on one card equal the
    WindowDecoder, and dryrun(2) decodes each boundary packet once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode stencil kernel runs only there")
    single = port_window(ALL, 24, device=None)
    iq = cap_all_protocols(port_mesh(ALL, 2, window_blocks=24))
    for n in (1, 2):
        dec = port_mesh(ALL, n, window_blocks=24, device=None)
        before = decode_stencil.launches
        got = as_list(dec.decode_capture(iq))
        assert decode_stencil.launches > before
        assert got == as_list(single.decode_capture(iq)) and len(got) >= 6
    assert dryrun(2) == 5


@pytest.mark.cuda
def test_cuda_mesh_a_shard_a_card():
    """With several cards the default layout puts one shard on each: a
    carry over several super-batches and an overflowed window at a shard's
    first position (escalated on that shard's card) equal the
    WindowDecoder's stream, K1 runs once a dispatched window and once more
    an escalation, and the CLI's ``-mesh`` over every card equals the plain
    run."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two or more CUDA cards: one shard on each")
    for case in ("carry_over_superbatches", "overflow_at_shard_start"):
        names, _, window_blocks, max_hits, make_capture = CASES[case]
        dec = MeshDecoder([new_parser(x, CHIP) for x in names], window_blocks=window_blocks,
                          max_hits=max_hits)
        assert [d.index for d in dec.devices] == list(range(cards))
        iq = make_capture(dec)
        before = decode_stencil.launches
        got = as_list(dec.decode_capture(iq))
        dispatched = dec.export_state()["window_index"]
        assert decode_stencil.launches - before == dispatched + dec.metrics.hit_overflows
        single = port_window(names, dec.spec.window // dec.cfg.block_size, max_hits, device=None)
        assert got == as_list(single.decode_capture(iq)) and len(got) >= 3
        if case == "overflow_at_shard_start":
            assert dec.metrics.hit_overflows > 0
    rc, want, _ = cli(GOLDEN, None)
    assert rc == 0 and len(want) == 14
    rc, got, err = cli(GOLDEN + ["-mesh"], None)
    assert rc == 0 and got == want and f"mesh: {cards} devices" in err
