"""Stream checkpoints of the port (rtlamr_tpu_torch/decoder/checkpoint.py and
``-checkpoint`` in its CLI): a resumed stream equals the straight-through
decode exactly, for narrowband and wideband, at every kind of cut; the
files resume in the JAX package and the JAX package's resume in the port;
every refusal of the reference holds; a save is atomic; and the CLI stops
on SIGINT only between two feeds.

All at chip length 8 with 24-block windows (tests/test_aux.py's and
tests/test_torch_cli.py's sizes). The JAX package is imported inside the
tests that use it, so the ``cuda`` test runs on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_checkpoint.py -m cuda``."""

import contextlib
import dataclasses
import io
import json
import os
import re
import signal

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder import checkpoint as ck
from rtlamr_tpu_torch.decoder.checkpoint import (
    Checkpoint,
    WidebandCheckpoint,
    capture_checkpoint,
    load_checkpoint,
    restore_checkpoint,
)
from rtlamr_tpu_torch.io.capture import FileSource
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.parallel import WidebandDecoder
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

CHIP = 8
NAMES = ("scm", "scm+", "idm", "r900")
WIDE_NAMES = ("scm", "idm", "r900")
WINDOW_BLOCKS = 24
N = 4
SAMPLE = os.path.join(os.path.dirname(__file__), "fixtures", "sample.bin")
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")


def as_list(msgs):
    """(block, str(message)) or (channel, block, str(message)) rows."""
    return [(*t[:-1], str(t[-1])) for t in msgs]


def port(device="cpu", window_blocks=WINDOW_BLOCKS):
    return WindowDecoder([new_parser(n, CHIP) for n in NAMES],
                         window_blocks=window_blocks, device=device)


def port_wide(n_channels=N, device="cpu"):
    return WidebandDecoder([new_parser(n, CHIP) for n in WIDE_NAMES], n_channels=n_channels,
                           window_blocks=WINDOW_BLOCKS, cross_channel_dedup=True,
                           device=device)


def nb_capture(windows=7):
    """``windows`` full windows and a partial one of all four protocols, a
    burst every PacketLength + 1 block from mid-block 0, so packets straddle
    the window boundaries."""
    cfg = build_decoder_config([new_parser(n, CHIP) for n in NAMES])
    w = WINDOW_BLOCKS * cfg.block_size
    total = windows * w + 9 * cfg.block_size
    bursts, offset, i = [], cfg.block_size // 2, 0
    while offset + cfg.packet_length < total:
        kind = NAMES[i % len(NAMES)]
        if kind == "scm":
            bursts.append(synth.bits_to_burst(
                synth.make_scm_bits(meter_id=100000 + i, consumption=i), offset))
        elif kind == "scm+":
            bursts.append(synth.bits_to_burst(
                synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i), offset))
        elif kind == "idm":
            bursts.append(synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), offset))
        else:
            bursts.append(synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), offset))
        offset += cfg.packet_length + cfg.block_size
        i += 1
    return synth.render_iq(total, bursts, CHIP, noise=2.0, seed=31)


@pytest.fixture(scope="module")
def nb():
    """(capture, window bytes, the straight-through stream)."""
    iq = nb_capture()
    dec = port()
    want = as_list(dec.decode_capture(iq))
    assert len(want) >= 6
    oracle = ReferenceDecoder([new_parser(n, CHIP) for n in NAMES], arithmetic="int")
    assert want == as_list(oracle.decode_capture(iq))
    return iq, dec.window_bytes, want


def cut_at(kind, iq, wb):
    return {
        "byte0": 0,
        "window_aligned": 2 * wb,
        "mid_window": 2 * wb + (wb // 3 | 1),
        "final_partial": (iq.size // wb) * wb + (iq.size % wb) // 2 + 1,
    }[kind]


CUTS = ["byte0", "window_aligned", "mid_window", "final_partial"]


def discard_pending(dec) -> int:
    """``dec.discard_pending()``: the bytes fed since the last whole window
    dropped, their count. The JAX package's decoders have no such method, so
    their queue is emptied here."""
    if hasattr(dec, "discard_pending"):
        return dec.discard_pending()
    n = dec._pending.size
    dec._pending = np.zeros(0, np.uint8)
    return n


def resume(make, data, cut, path, writer=None, reader=None):
    """Feed ``data[:cut]`` into ``make()``, drain, checkpoint at the window
    boundary, save to ``path``, load into a fresh ``make()``, restore, feed
    the rest and flush. ``writer``/``reader`` replace the first and second
    decoder and the checkpoint functions (the other package)."""
    w_make, w_capture = writer or (make, capture_checkpoint)
    r_make, r_load, r_restore = reader or (make, load_checkpoint, restore_checkpoint)
    a = w_make()
    got = as_list(a.feed(data[:cut])) + as_list(a.drain())
    boundary = cut - discard_pending(a)
    saved = w_capture(a, boundary)
    saved.save(path)
    b = r_make()
    r_restore(b, r_load(path))
    got += as_list(b.feed(data[boundary:])) + as_list(b.flush())
    return got, saved, boundary


@pytest.mark.parametrize("kind", CUTS)
def test_narrowband_resume_bit_identical(kind, nb, tmp_path):
    iq, wb, want = nb
    cut = cut_at(kind, iq, wb)
    got, saved, boundary = resume(port, iq, cut, str(tmp_path / "ck"))
    assert got == want
    assert boundary == cut - cut % wb and saved.byte_offset == boundary
    assert saved.first == (boundary == 0)
    loaded = load_checkpoint(str(tmp_path / "ck"))
    assert isinstance(loaded, Checkpoint)
    assert np.array_equal(loaded.carry, saved.carry) and loaded.carry.dtype == np.uint16
    assert sorted(loaded.prev_digests) == sorted(saved.prev_digests)
    assert (loaded.window_index, loaded.last_block, loaded.first) == (
        saved.window_index, saved.last_block, saved.first)
    dec = port()
    restore_checkpoint(dec, loaded)
    state = dec.export_state()
    assert np.array_equal(state["carry"], saved.carry) and state["dedup_next"] == set()


@pytest.fixture(scope="module")
def wide():
    """tests/test_aux.py's wideband checkpoint capture: four channels, the
    channel-1 packet straddles the cut after two super-steps."""
    w = port_wide().spec.window
    planted = [
        (0, synth.bits_to_burst(synth.make_scm_bits(meter_id=111001, consumption=1), 3000)),
        (1, synth.bits_to_burst(synth.make_scm_bits(meter_id=222002, consumption=2),
                                2 * w - 700)),
        (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), w + 5000)),
        (3, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 2 * w + 300)),
    ]
    wb = synth.render_wideband(4 * w, planted, N, CHIP, amplitude=90.0, noise=2.0, seed=7)
    msgs = port_wide().decode_capture(wb)
    assert {m.meter_id() for _, _, m in msgs} >= {111001, 222002, 333003, 444004}
    return wb, as_list(msgs)


def test_wideband_resume_bit_identical(wide, tmp_path):
    wb, want = wide
    dec = port_wide()
    half = 2 * dec.window_bytes
    got, saved, boundary = resume(port_wide, wb, half + 999, str(tmp_path / "wck"))
    assert got == want and boundary == half
    loaded = load_checkpoint(str(tmp_path / "wck"))
    assert isinstance(loaded, WidebandCheckpoint)
    assert np.array_equal(loaded.wb_hist, saved.wb_hist) and loaded.wb_hist.dtype == np.float32
    assert np.array_equal(loaded.chan_tail, saved.chan_tail)
    assert loaded.wb_hist.shape == (2, N, 8) and loaded.chan_tail.shape == (N, dec.spec.halo_staged)
    assert sorted(loaded.xchan_seen) == sorted(saved.xchan_seen)
    assert loaded.chan_last_block == saved.chan_last_block


def test_wideband_resume_at_stream_head(wide, tmp_path):
    """Cut before the first super-step: ``first`` and a zero history carry
    over, and the whole stream comes from the restored decoder."""
    wb, want = wide
    got, saved, boundary = resume(port_wide, wb, 5000, str(tmp_path / "wck"))
    assert got == want and boundary == 0 and saved.first
    assert not saved.wb_hist.any()


# ---------------------------------------------------------------------------
# Across packages: the JAX package's files resume in the port and the reverse


def jax_narrow():
    from rtlamr_tpu.decoder import WindowDecoder as JaxDecoder
    from rtlamr_tpu.protocols import new_parser as jax_parser

    return JaxDecoder([jax_parser(n, CHIP) for n in NAMES], window_blocks=WINDOW_BLOCKS)


def jax_wide():
    from rtlamr_tpu.parallel.wideband import WidebandDecoder as JaxWideband
    from rtlamr_tpu.protocols import new_parser as jax_parser

    return JaxWideband([jax_parser(n, CHIP) for n in WIDE_NAMES], n_channels=N,
                       window_blocks=WINDOW_BLOCKS, cross_channel_dedup=True)


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
@pytest.mark.parametrize("kind", ["window", "wideband"])
def test_checkpoint_files_cross_packages(kind, direction, nb, wide, tmp_path):
    """A checkpoint the JAX package writes resumes in the port, one the port
    writes resumes in the JAX package (its default ``jnp`` backend), each
    equal to the writer's straight run."""
    from rtlamr_tpu.decoder import checkpoint as jck

    if kind == "window":
        (data, wb, want), mine, theirs = nb, port, jax_narrow
        cut = 2 * wb + (wb // 3 | 1)
    else:
        (data, want), mine, theirs = wide, port_wide, jax_wide
        cut = 2 * port_wide().window_bytes + 999
    jax_side = (theirs, jck.load_checkpoint, jck.restore_checkpoint)
    port_side = (mine, load_checkpoint, restore_checkpoint)
    path = str(tmp_path / "ck")
    if direction == "jax_writes":
        straight = as_list(theirs().decode_capture(data))
        got, _, _ = resume(None, data, cut, path, writer=(theirs, jck.capture_checkpoint),
                           reader=port_side)
        meta = json.load(open(path + ".meta.json"))
        assert "carry_sha256" not in meta  # the JAX package's own file
    else:
        straight = want
        got, saved, _ = resume(None, data, cut, path, writer=(mine, capture_checkpoint),
                               reader=jax_side)
        meta = json.load(open(path + ".meta.json"))
        assert meta["kind"] == kind and meta["window"] == saved.window
    assert straight == want  # the two packages agree straight through
    assert got == straight


# ---------------------------------------------------------------------------
# Refusals


def test_refuses_mid_window_and_in_flight():
    dec = port()
    dec.feed(np.zeros(100, np.uint8))
    with pytest.raises(ValueError, match="window boundaries"):
        capture_checkpoint(dec, 100)
    dec = port()
    dec.feed(np.zeros(dec.window_bytes, np.uint8))
    with pytest.raises(ValueError, match="in flight"):
        capture_checkpoint(dec, dec.window_bytes)
    wdec = port_wide()
    wdec.feed(np.zeros(wdec.window_bytes, np.uint8))
    with pytest.raises(ValueError, match="in flight"):
        capture_checkpoint(wdec, wdec.window_bytes)
    wdec.drain()
    wdec.feed(np.zeros(10, np.uint8))
    with pytest.raises(ValueError, match="window boundaries"):
        capture_checkpoint(wdec, wdec.window_bytes + 10)


def saved_pair(tmp_path):
    """A narrowband and a wideband checkpoint after one window each, saved
    and loaded back."""
    nb_dec, wb_dec = port(), port_wide()
    nb_dec.feed(np.full(nb_dec.window_bytes, 128, np.uint8))
    nb_dec.drain()
    wb_dec.feed(np.full(wb_dec.window_bytes, 128, np.uint8))
    wb_dec.drain()
    capture_checkpoint(nb_dec, nb_dec.window_bytes).save(str(tmp_path / "n"))
    capture_checkpoint(wb_dec, wb_dec.window_bytes).save(str(tmp_path / "w"))
    return load_checkpoint(str(tmp_path / "n")), load_checkpoint(str(tmp_path / "w"))


def test_refuses_kind_and_geometry(tmp_path):
    narrow, wide_ck = saved_pair(tmp_path)
    with pytest.raises(ValueError, match="kind mismatch"):
        restore_checkpoint(port(), wide_ck)
    with pytest.raises(ValueError, match="kind mismatch"):
        restore_checkpoint(port_wide(), narrow)
    with pytest.raises(ValueError, match="geometry mismatch.*chan_tail"):  # wrong N
        restore_checkpoint(port_wide(n_channels=2), dataclasses.replace(wide_ck, window=None))
    with pytest.raises(ValueError, match="geometry mismatch.*history"):  # wrong P
        restore_checkpoint(port_wide(), dataclasses.replace(wide_ck, wb_hist=wide_ck.wb_hist[..., :4]))
    with pytest.raises(ValueError, match="geometry mismatch.*window"):  # wrong window
        restore_checkpoint(port(window_blocks=48), narrow)
    with pytest.raises(ValueError, match="geometry mismatch.*window"):
        restore_checkpoint(WidebandDecoder([new_parser(n, CHIP) for n in WIDE_NAMES], n_channels=N,
                                           window_blocks=48, device="cpu"), wide_ck)
    with pytest.raises(ValueError, match="geometry mismatch.*carry"):  # other message types
        restore_checkpoint(WindowDecoder([new_parser("scm", CHIP)], window_blocks=WINDOW_BLOCKS,
                                         device="cpu"), dataclasses.replace(narrow, window=None))
    bad = wide_ck.wb_hist.copy()
    bad[0, 0, 0] += np.float32(0.25)
    with pytest.raises(ValueError, match="u8-derived"):
        restore_checkpoint(port_wide(), dataclasses.replace(wide_ck, wb_hist=bad))
    # The refusals leave the restored decoder usable: restore the good one.
    dec = port_wide()
    restore_checkpoint(dec, wide_ck)
    assert dec.export_state()["window_index"] == 1


def test_refuses_jax_mesh_checkpoint(tmp_path):
    """A JAX ``MeshDecoder`` checkpoint (kind "window", the (halo,) tail)
    offered to a port ``WindowDecoder`` names the multi-GPU slice."""
    import jax

    from rtlamr_tpu.decoder.checkpoint import capture_checkpoint as jax_capture
    from rtlamr_tpu.parallel.mesh import MeshDecoder
    from rtlamr_tpu.protocols import new_parser as jax_parser

    mesh = MeshDecoder([jax_parser(n, CHIP) for n in NAMES], devices=jax.devices()[:2],
                       window_blocks=WINDOW_BLOCKS, scan_windows=2)
    mesh.reset()
    jax_capture(mesh, 0).save(str(tmp_path / "mesh"))
    loaded = load_checkpoint(str(tmp_path / "mesh"))
    assert loaded.carry.shape == (port().spec.halo,)
    with pytest.raises(ValueError, match="geometry mismatch.*mesh.*multi-GPU"):
        restore_checkpoint(port(), loaded)


# ---------------------------------------------------------------------------
# Atomic save


def checkpoints_at(dec, data, cuts):
    """Checkpoints of ``dec`` at each window-aligned cut of ``data``."""
    out, pos = [], 0
    for cut in cuts:
        dec.feed(data[pos:cut])
        dec.drain()
        out.append(capture_checkpoint(dec, cut))
        pos = cut
    return out


def same(a, b):
    if isinstance(a, Checkpoint):
        return (a.byte_offset, a.window_index, a.last_block, a.first, sorted(a.prev_digests)) == (
            b.byte_offset, b.window_index, b.last_block, b.first, sorted(b.prev_digests)
        ) and np.array_equal(a.carry, b.carry)
    return (a.byte_offset, a.window_index, a.chan_last_block, sorted(a.xchan_seen)) == (
        b.byte_offset, b.window_index, b.chan_last_block, sorted(b.xchan_seen)
    ) and np.array_equal(a.wb_hist, b.wb_hist) and np.array_equal(a.chan_tail, b.chan_tail)


@pytest.mark.parametrize("kind", ["window", "wideband"])
def test_save_is_atomic(kind, nb, wide, tmp_path, monkeypatch):
    """A save that fails on moving its meta into place leaves the previous
    checkpoint whole, and no file the loader would read. After a crash
    between the two moves (the rollback fails too) the loader reads the
    previous carry, the one that matches the meta in place."""
    if kind == "window":
        data, wb = nb[0], nb[1]
        dec = port()
    else:
        data = wide[0]
        dec = port_wide()
        wb = dec.window_bytes
    first, second, third = checkpoints_at(dec, data, [wb, 2 * wb, 3 * wb])
    path = str(tmp_path / "ck")
    first.save(path)
    before = sorted(os.listdir(tmp_path))
    real_replace = os.replace

    def fail_on_meta(src, dst):
        if str(dst).endswith(".meta.json"):
            raise OSError("disk full")
        return real_replace(src, dst)

    with monkeypatch.context() as mp:
        mp.setattr(ck.os, "replace", fail_on_meta)
        with pytest.raises(OSError, match="disk full"):
            second.save(path)
    assert sorted(os.listdir(tmp_path)) == before
    assert same(load_checkpoint(path), first)

    def crash_between(src, dst):
        if str(dst).endswith(".meta.json") or str(src).endswith(".prev"):
            raise OSError("power lost")
        return real_replace(src, dst)

    with monkeypatch.context() as mp:
        mp.setattr(ck.os, "replace", crash_between)
        with pytest.raises(OSError, match="power lost"):
            second.save(path)
    assert any(f.endswith(".prev") for f in os.listdir(tmp_path))
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    assert same(load_checkpoint(path), first)
    third.save(path)  # a later save after the crash is whole again
    assert sorted(os.listdir(tmp_path)) == before
    assert same(load_checkpoint(path), third)
    # The JAX package reads the port's file (it ignores the added keys).
    from rtlamr_tpu.decoder.checkpoint import load_checkpoint as jax_load

    theirs = jax_load(path)
    assert theirs.byte_offset == third.byte_offset and theirs.window_index == third.window_index


def test_carry_that_matches_no_meta_is_refused(nb, tmp_path):
    iq, wb, _ = nb
    saved = checkpoints_at(port(), iq, [wb])[0]
    path = str(tmp_path / "ck")
    saved.save(path)
    with open(path + ".carry.bin", "r+b") as f:
        f.write(b"\x01\x02")
    with pytest.raises(ValueError, match="does not match its meta"):
        load_checkpoint(path)


# ---------------------------------------------------------------------------
# CLI


def cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, device="cpu")
    return rc, [TIMESTAMP.sub("<time>", ln) for ln in out.getvalue().splitlines()]


def golden_argv(path, ck_path, fmt):
    return ["-msgtype=scm", "-symbollength=78", "-windowblocks=8", f"-format={fmt}",
            f"-fromfile={path}", f"-checkpoint={ck_path}"]


@pytest.mark.parametrize("fmt", ["plain", "json"])
def test_cli_straight_through_writes_no_checkpoint(fmt, tmp_path):
    rc, lines = cli(golden_argv(SAMPLE, str(tmp_path / "ck"), fmt))
    assert rc == 0 and len(lines) == 14
    assert os.listdir(tmp_path) == []


@contextlib.contextmanager
def sigint_guard():
    """Hold stray SIGINTs in the test, so a run that failed to take them
    fails its assertions instead of stopping the test session."""
    stray = []
    old = signal.signal(signal.SIGINT, lambda *_: stray.append(True))
    try:
        yield stray
    finally:
        signal.signal(signal.SIGINT, old)


@pytest.mark.parametrize("fmt", ["plain", "json"])
def test_cli_interrupt_resume(fmt, tmp_path, monkeypatch):
    """tests/test_aux.py's interrupt test: the first read returns 100000
    bytes, not window-aligned (a window is 65536 bytes at chip length 78 x
    8 blocks), so the checkpoint lands mid-chunk; the second read is
    interrupted. The resumed run's lines, Offset and Length included, follow
    on exactly, and the run to the end removes the checkpoint."""
    _, want = cli(golden_argv(SAMPLE, str(tmp_path / "full"), fmt))
    assert len(want) == 14
    path = str(tmp_path / "ck")
    orig_read = FileSource.read
    calls = {"n": 0}

    def flaky_read(self, n):
        calls["n"] += 1
        if calls["n"] == 1:
            return orig_read(self, 100000)
        raise KeyboardInterrupt

    argv = golden_argv(SAMPLE, path, fmt) + ["-ingest=python"]  # the test patches FileSource
    with monkeypatch.context() as mp:
        mp.setattr(FileSource, "read", flaky_read)
        rc, got = cli(argv)
    assert rc == 0 and os.path.exists(path + ".meta.json")
    assert load_checkpoint(path).byte_offset == 65536
    assert 0 < len(got) < 14
    rc, rest = cli(argv)
    assert rc == 0 and got + rest == want
    assert not os.path.exists(path + ".meta.json")


@pytest.mark.parametrize("channels", [1, 4])
def test_cli_deferred_sigint_resumes_bit_identical(channels, nb, wide, tmp_path, monkeypatch):
    """SIGINT raised inside ``feed``, on the 2nd window of a chunk that
    holds at least 3, stops the run at that feed's boundary: the run drains,
    saves, and the resumed run follows on exactly. With the reference's loop,
    which catches KeyboardInterrupt anywhere (rtlamr_tpu/cli/main.py:594-631),
    the interrupt would land inside ``feed`` after some of the chunk's
    windows were dispatched, the saved boundary would not match the decoder
    and this test would fail."""
    if channels == 1:
        data = nb_capture(windows=14)  # longer than the first read
        argv = [f"-msgtype={','.join(NAMES)}", "-symbollength=8", "-windowblocks=24"]
        target = WindowDecoder
        window_bytes = nb[1]
    else:
        data = wide[0]
        argv = [f"-msgtype={','.join(WIDE_NAMES)}", "-symbollength=8", "-windowblocks=24",
                "-channels=4", "-crosschanneldedup=true"]
        target = WidebandDecoder
        window_bytes = port_wide().window_bytes
    first = min(data.size, max(channels * build_decoder_config(
        [new_parser(n, CHIP) for n in NAMES]).block_size2, 1 << 18))  # the first read
    # a wideband super-step is 4 windows of bytes: a read holds two
    assert first // window_bytes >= (3 if channels == 1 else 2)
    cap = tmp_path / "cap.bin"
    data.tofile(cap)
    argv += ["-format=json", f"-fromfile={cap}", f"-checkpoint={tmp_path / 'ck'}"]
    _, want = cli(argv)
    assert not os.path.exists(tmp_path / "ck.meta.json")

    method = "_process_window" if channels == 1 else "_process_chunk"
    orig = getattr(target, method)
    calls = {"n": 0}

    def process(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            signal.raise_signal(signal.SIGINT)
        return orig(self, *args, **kwargs)

    with sigint_guard() as stray, monkeypatch.context() as mp:
        mp.setattr(target, method, process)
        rc, got = cli(argv)
    assert rc == 0 and not stray
    saved = load_checkpoint(str(tmp_path / "ck"))
    assert saved.byte_offset == first - first % window_bytes  # the first feed's boundary
    assert calls["n"] == first // window_bytes  # the interrupted feed ran to its end
    rc, rest = cli(argv)
    assert rc == 0 and got + rest == want and len(got) < len(want)


def test_cli_wideband_interrupt_resume(wide, tmp_path, monkeypatch):
    """tests/test_aux.py's wideband CLI interrupt (without -mesh): one
    150000-byte read, then an interrupt; the checkpoint boundary lands
    mid-chunk and the channel-tagged lines of the two runs equal one run."""
    cap = tmp_path / "wb.bin"
    wide[0].tofile(cap)
    argv = ["-msgtype=scm,idm,r900", "-symbollength=8", "-channels=4", "-windowblocks=24",
            "-format=json", f"-fromfile={cap}", f"-checkpoint={tmp_path / 'ck'}",
            "-ingest=python"]  # the test patches FileSource
    _, want = cli(argv)
    assert len(want) >= 3
    orig_read = FileSource.read
    calls = {"n": 0}

    def flaky_read(self, n):
        calls["n"] += 1
        if calls["n"] == 1:
            return orig_read(self, 150000)
        raise KeyboardInterrupt

    with monkeypatch.context() as mp:
        mp.setattr(FileSource, "read", flaky_read)
        _, got = cli(argv)
    assert isinstance(load_checkpoint(str(tmp_path / "ck")), WidebandCheckpoint)
    assert len(got) < len(want)
    _, rest = cli(argv)
    assert got + rest == want
    assert all(json.loads(ln)["Channel"] in range(N) for ln in want)


def test_cli_refuses_bad_checkpoints(tmp_path, capsys):
    """A checkpoint of the other kind, or one past the capture's end, ends
    the run with exit code 1 and no output."""
    narrow, _ = saved_pair(tmp_path)
    cap = tmp_path / "short.bin"
    np.zeros(1000, np.uint8).tofile(cap)
    base = ["-symbollength=8", "-windowblocks=24", "-format=json", f"-fromfile={cap}"]
    assert cli(base + ["-msgtype=scm,scm+,idm,r900", f"-checkpoint={tmp_path / 'n'}"]) == (1, [])
    assert "before the checkpoint's" in capsys.readouterr().err
    assert cli(base + ["-msgtype=scm,idm,r900", "-channels=4",
                       f"-checkpoint={tmp_path / 'n'}"]) == (1, [])
    assert "kind mismatch" in capsys.readouterr().err


def test_sample_ring_resume_matches_a_walk():
    """``SampleRing.resume_at`` leaves the state a walk from block 0 leaves."""
    from rtlamr_tpu_torch.io.capture import SampleDumper, SampleRing

    for block in (0, 1, 3, 7, 40):
        walked = SampleRing(SampleDumper(None), 100, 350)
        walked.advance_to(block - 1)
        resumed = SampleRing(SampleDumper(None), 100, 350)
        resumed.resume_at(block)
        assert (resumed._ring, resumed.length, resumed._sim_block) == (
            walked._ring, walked.length, walked._sim_block)
        walked.advance_to(block + 5)
        resumed.advance_to(block + 5)
        assert (resumed._ring, resumed.length) == (walked._ring, walked.length)


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.cuda
def test_cuda_resume_bit_identical(tmp_path):
    """On the card, through K1: resume at each narrowband cut equals the
    straight run on the card and the port's oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode stencil kernel runs only there")
    iq = nb_capture()
    dec = port(device=None)
    want = as_list(dec.decode_capture(iq))
    oracle = ReferenceDecoder([new_parser(n, CHIP) for n in NAMES], arithmetic="int")
    assert want == as_list(oracle.decode_capture(iq)) and len(want) >= 6
    for kind in CUTS:
        before = decode_stencil.launches
        got, _, _ = resume(lambda: port(device=None), iq, cut_at(kind, iq, dec.window_bytes),
                           str(tmp_path / kind))
        assert got == want, kind
        assert decode_stencil.launches > before
