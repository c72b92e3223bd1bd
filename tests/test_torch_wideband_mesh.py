"""The port's channel x time ``WidebandMeshDecoder``
(rtlamr_tpu_torch/parallel/wideband_mesh.py) and ``-channels N -mesh`` in its
CLI: (channel, block, message) streams equal to the JAX package's
``WidebandMeshDecoder`` on conftest's virtual CPU devices and to the port's
``WidebandDecoder``, exactly, for packets inside shards, on a time-shard
seam and across a super-batch boundary, at mesh shapes (2, 2), (4, 1) and
(1, 4); ragged feeds; the cross-channel ghost dedup; ``dryrun``; the
checkpoint both ways with the JAX wideband mesh's files and its refusals;
the CLI's ``-channels=4 -mesh`` and its ``-checkpoint`` interrupt/resume.

The port runs a shard a device of ``["cpu"] * 4`` (the channelizer's plain
version and the window program's plain stencil). The JAX package is
imported inside the tests that use it, so the ``cuda`` tests run on a
machine without JAX:
``python -m pytest --noconftest tests/test_torch_wideband_mesh.py -m cuda``."""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import signal

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.decoder.checkpoint import (
    WidebandCheckpoint,
    capture_checkpoint,
    load_checkpoint,
    restore_checkpoint,
)
from rtlamr_tpu_torch.ops.channelizer_fused import channelize_requantize_fused
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.parallel import WidebandDecoder, WidebandMeshDecoder
from rtlamr_tpu_torch.parallel.wideband_mesh import dryrun
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

N = 4
CHIP = 8
ALL = ("scm", "scm+", "idm", "r900")
WINDOW_BLOCKS = 24  # smallest halo-covering window at chip 8, all-protocol
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")


def as_list(msgs):
    return [(c, b, str(m)) for c, b, m in msgs]


def port_mesh(shape, names=ALL, window_blocks=WINDOW_BLOCKS, device="cpu", **kw):
    return WidebandMeshDecoder([new_parser(x, CHIP) for x in names], n_channels=N,
                               mesh_shape=shape, devices=[device] * (shape[0] * shape[1]),
                               window_blocks=window_blocks, **kw)


def port_wide(names=ALL, window_blocks=WINDOW_BLOCKS, device="cpu", **kw):
    return WidebandDecoder([new_parser(x, CHIP) for x in names], n_channels=N,
                           window_blocks=window_blocks, device=device, **kw)


def jax_mesh(shape, names=ALL, window_blocks=WINDOW_BLOCKS, **kw):
    import jax

    from rtlamr_tpu.parallel.wideband_mesh import WidebandMeshDecoder as JaxMesh
    from rtlamr_tpu.protocols import new_parser as jax_parser

    return JaxMesh([jax_parser(x, CHIP) for x in names], n_channels=N, mesh_shape=shape,
                   devices=jax.devices()[: shape[0] * shape[1]], window_blocks=window_blocks,
                   **kw)


def scm(meter_id, offset):
    return synth.bits_to_burst(
        synth.make_scm_bits(meter_id=meter_id, consumption=meter_id % 97), offset)


def seam_capture(dec):
    """tests/test_wideband.py's mesh capture, on ``dec``'s geometry: a
    packet inside channel 0's first window, one exactly on the first
    time-shard seam (channel 1), an R900 burst (channel 2), one straddling
    the super-batch boundary (channel 3) and one inside the second
    super-batch (channel 0); two super-batches and a half."""
    w = dec.spec.window
    shard_span = dec.scan_windows * w
    batch_span = dec.tdev * shard_span
    half = 96 * dec.cfg.symbol_length // 2
    planted = [
        (0, scm(111001, 3000)),
        (1, scm(222002, shard_span - half)),
        (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), 5000)),
        (3, scm(444004, batch_span - half)),
        (0, scm(555005, batch_span + 4000)),
        (2, scm(666006, 2 * batch_span + w // 3)),
    ]
    return synth.render_wideband(2 * batch_span + batch_span // 2, planted, N, CHIP,
                                 amplitude=90.0, noise=2.0, seed=33)


SHAPES = [(2, 2), (4, 1), (1, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{c}x{t}" for c, t in SHAPES])
def test_matches_jax_mesh_and_wideband_decoder(shape):
    dec = port_mesh(shape)
    wb = seam_capture(dec)
    got = as_list(dec.decode_capture(wb))
    ids = {(c, s.split("ID:")[1].split()[0].strip("{},")) for c, _, s in got if "ID:" in s}
    assert {(0, "111001"), (1, "222002"), (3, "444004"), (0, "555005")} <= ids
    assert got == as_list(jax_mesh(shape).decode_capture(wb))
    assert got == as_list(port_wide().decode_capture(wb))


def test_ragged_feed_equals_decode_capture():
    """Feeds of random sizes, a flush at the end: the decode_capture stream."""
    dec = port_mesh((2, 2))
    wb = seam_capture(dec)
    want = as_list(dec.decode_capture(wb))
    dec.reset()
    rng = np.random.default_rng(4)
    got, pos = [], 0
    while pos < wb.size:
        n = int(rng.integers(1, 3 * dec.superbatch_bytes // 4))
        got += as_list(dec.feed(wb[pos : pos + n]))
        pos += n
    got += as_list(dec.flush())
    assert got == want and len(want) >= 5


def test_cross_channel_dedup_keeps_the_lowest_channel():
    """A strong R900 burst on channel 2 also decodes on channel 0; the
    ghost dedup keeps channel 0's copy, as the JAX mesh and the port's
    single-card decoder do, and counts the drop."""
    dec = port_mesh((2, 2), cross_channel_dedup=True)
    w = dec.spec.window
    planted = [(0, scm(111001, 3000)), (1, scm(222002, w - 700)),
               (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), 5000)),
               (3, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 300))]
    wb = synth.render_wideband(3 * w, planted, N, CHIP, amplitude=90.0, noise=2.0, seed=21)
    msgs = dec.decode_capture(wb)
    got = as_list(msgs)
    assert got == as_list(jax_mesh((2, 2), cross_channel_dedup=True).decode_capture(wb))
    assert got == as_list(port_wide(cross_channel_dedup=True).decode_capture(wb))
    ids = sorted((c, m.meter_id()) for c, _, m in msgs)
    assert ids == [(0, 111001), (0, 333003), (1, 222002), (3, 444004)]
    assert dec.metrics_snapshot()["messages_dropped_dup"] >= 1
    assert len(as_list(port_mesh((2, 2)).decode_capture(wb))) > len(got)


@pytest.mark.parametrize("n,want", [(1, 3), (2, 3), (4, 4), (8, 4)])
def test_dryrun(n, want):
    # (cdev, tdev) = (1, 1), (2, 1), (2, 2), (2, 4): the time-shard seam
    # packet exists from two time shards on.
    assert dryrun(n, device="cpu") == want


def test_geometry_refusals():
    with pytest.raises(ValueError, match="divisible by mesh cdev"):
        port_mesh((3, 1))
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        WidebandMeshDecoder([new_parser("scm", CHIP)], n_channels=N, mesh_shape=(2, 2),
                            devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="window must cover the halo"):
        port_mesh((2, 2), window_blocks=1)
    with pytest.raises(ValueError, match="scan_windows"):
        port_mesh((2, 2), scan_windows=0)
    small = port_mesh((1, 1), names=("scm",), window_blocks=None)
    with pytest.raises(ValueError, match=f"8 bytes, want {small.superbatch_bytes}"):
        small.decode_superbatch(np.zeros(8, np.uint8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WidebandMeshDecoder([new_parser("scm", CHIP)], n_channels=N, mesh_shape=(1, 1))
    dec = port_mesh((2, 2))
    assert dec.superbatch_bytes == dec.window_bytes == 2 * N * dec.spec.window * 2 * 2
    assert [str(dec.device_of(ci, x)) for ci in range(2) for x in range(2)] == ["cpu"] * 4
    assert np.array_equal(dec.channel_center_freqs(912_000_000),
                          port_wide().channel_center_freqs(912_000_000))


# ---------------------------------------------------------------------------
# Checkpoints

def aux_capture(dec):
    """tests/test_aux.py's wideband-mesh checkpoint capture: a packet
    straddling the first super-batch boundary, so only the carried filter
    history and channel tails recover it."""
    span = dec.superbatch_bytes // (2 * N)
    planted = [(0, scm(111001, 3000)), (1, scm(222002, span - 700)),
               (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), span + 5000))]
    return synth.render_wideband(2 * span, planted, N, CHIP, amplitude=90.0, noise=2.0, seed=9)


def jax_checkpoint_api():
    from rtlamr_tpu.decoder import checkpoint as jck

    return jck.capture_checkpoint, jck.load_checkpoint, jck.restore_checkpoint


CK_NAMES = ("scm", "r900")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_checkpoint_resumes_across_packages(direction, tmp_path):
    """A port wideband mesh's checkpoint (kind "wideband", the JAX mesh's
    (N, halo) tails) resumes in the JAX WidebandMeshDecoder and the JAX
    one's in the port, cut at the first super-batch's end; each equals the
    straight stream, the boundary packet included."""
    def port():
        return port_mesh((2, 2), names=CK_NAMES, window_blocks=None, cross_channel_dedup=True)

    def jax():
        return jax_mesh((2, 2), names=CK_NAMES, window_blocks=None, cross_channel_dedup=True)

    dec = port()
    wb = aux_capture(dec)
    want = as_list(dec.decode_capture(wb))
    assert len(want) >= 3
    sb = dec.superbatch_bytes
    j_capture, j_load, j_restore = jax_checkpoint_api()
    a, capture = {"port_to_jax": (port(), capture_checkpoint),
                  "jax_to_port": (jax(), j_capture),
                  "port_to_port": (port(), capture_checkpoint)}[direction]
    b, load, restore = {"port_to_jax": (jax(), j_load, j_restore),
                        "jax_to_port": (port(), load_checkpoint, restore_checkpoint),
                        "port_to_port": (port(), load_checkpoint, restore_checkpoint)}[direction]
    a.reset()
    got = as_list(a.feed(wb[:sb])) + as_list(a.drain())
    path = str(tmp_path / "ck")
    capture(a, sb).save(path)
    restore(b, load(path))
    got += as_list(b.feed(wb[sb:])) + as_list(b.flush())
    assert got == want
    saved = load_checkpoint(path)
    assert isinstance(saved, WidebandCheckpoint)
    assert saved.chan_tail.shape == (N, dec.spec.halo) and saved.byte_offset == sb
    assert saved.window_index == 4 and not saved.first


def test_checkpoint_geometry_refusals(tmp_path):
    """A wideband-mesh checkpoint into a single-card wideband decoder, or
    the reverse, is a geometry mismatch, as in the JAX package; so is
    another window."""
    mesh, single = port_mesh((2, 2)), port_wide()
    assert mesh.spec.halo != mesh.spec.halo_staged
    capture_checkpoint(mesh, 0).save(str(tmp_path / "mesh"))
    capture_checkpoint(single, 0).save(str(tmp_path / "single"))
    with pytest.raises(ValueError, match="geometry mismatch.*resume it with -channels and -mesh"):
        restore_checkpoint(port_wide(), load_checkpoint(str(tmp_path / "mesh")))
    with pytest.raises(ValueError, match="geometry mismatch.*resume it without -mesh"):
        restore_checkpoint(port_mesh((2, 2)), load_checkpoint(str(tmp_path / "single")))
    with pytest.raises(ValueError, match="geometry mismatch.*window"):
        restore_checkpoint(port_mesh((2, 2), window_blocks=48),
                           load_checkpoint(str(tmp_path / "mesh")))
    _, j_load, j_restore = jax_checkpoint_api()
    with pytest.raises(ValueError, match="geometry mismatch"):
        j_restore(jax_mesh((2, 2)), j_load(str(tmp_path / "single")))
    # A mesh of another shape over the same channels resumes it.
    restore_checkpoint(port_mesh((1, 4)), load_checkpoint(str(tmp_path / "mesh")))


def test_export_state_round_trip():
    """load_state(export_state()) mid-stream continues bit-identically, the
    carried tails split over the channel shards' devices."""
    dec = port_mesh((2, 2))
    wb = seam_capture(dec)
    want = as_list(dec.decode_capture(wb))
    a = port_mesh((2, 2))
    sb = a.superbatch_bytes
    got = as_list(a.feed(wb[:sb])) + as_list(a.drain())
    state = a.export_state()
    assert state["chan_tail"].shape == (N, a.spec.halo_staged)
    b = port_mesh((2, 2))
    b.load_state(state)
    assert [t.shape for t in b._chan_tail] == [(2, a.spec.halo_staged)] * 2
    got += as_list(b.feed(wb[sb:])) + as_list(b.flush())
    assert got == want


# ---------------------------------------------------------------------------
# CLI


def cli(argv, device):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, device=device)
    return rc, [TIMESTAMP.sub("<time>", ln) for ln in out.getvalue().splitlines()], err.getvalue()


@pytest.fixture(scope="module")
def cli_capture(tmp_path_factory):
    """tests/test_cli.py's four-channel capture (one packet a channel)."""
    w = port_wide().spec.window
    planted = [(0, scm(111001, 3000)), (1, scm(222002, w - 700)),
               (2, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), 5000)),
               (3, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 300))]
    wb = synth.render_wideband(3 * w, planted, N, CHIP, amplitude=90.0, noise=2.0, seed=21)
    path = tmp_path_factory.mktemp("wbm") / "wideband.bin"
    wb.tofile(path)
    return str(path)


CLI_ARGS = ["-msgtype=all", "-symbollength=8", "-channels=4", "-windowblocks=24",
            "-format=json"]


@pytest.mark.parametrize("n,shape", [(8, (4, 2)), (2, (2, 1)), (3, (1, 3))])
def test_cli_wideband_mesh_equals_plain(cli_capture, n, shape):
    argv = CLI_ARGS + [f"-fromfile={cli_capture}"]
    rc, want, _ = cli(argv, "cpu")
    assert rc == 0 and len(want) >= 4
    rc, got, err = cli(argv + ["-mesh"], ["cpu"] * n)
    assert rc == 0 and got == want
    assert (f"wideband mesh: {shape[0]} channel-shards x {shape[1]} time-shards over {n} "
            "devices") in err
    assert {json.loads(ln)["Channel"] for ln in got} == {0, 1, 2, 3}


def test_cli_wideband_mesh_checkpoint_interrupt_resume(tmp_path, monkeypatch):
    """tests/test_aux.py's CLI case: SIGINT during the first super-batch of
    a ``-channels=4 -mesh -checkpoint`` run (a super-batch is 1.5 of the
    CLI's reads here) stops it at that feed's end with a wideband-mesh
    checkpoint at the super-batch boundary; the resumed run reads the rest
    of the feed again and follows on exactly; a run to the end leaves
    none."""
    probe = port_mesh((4, 2), names=CK_NAMES)
    wb = aux_capture(probe)
    cap = tmp_path / "wbm.bin"
    wb.tofile(cap)
    ck = str(tmp_path / "ck")
    argv = ["-msgtype=scm,r900", "-symbollength=8", "-channels=4", "-mesh", "-windowblocks=24",
            "-format=json", f"-fromfile={cap}", f"-checkpoint={ck}"]
    devices = ["cpu"] * 8  # a (4, 2) mesh, as the JAX test's virtual devices give
    rc, want, err = cli(argv, devices)
    assert rc == 0 and len(want) >= 3 and not os.path.exists(ck + ".meta.json")
    assert "4 channel-shards x 2 time-shards" in err
    orig = WidebandMeshDecoder._process_chunk
    calls = {"n": 0}

    def process(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            signal.raise_signal(signal.SIGINT)
        return orig(self, *args, **kwargs)

    assert probe.superbatch_bytes == 3 * (1 << 18) // 2
    stray = []
    old = signal.signal(signal.SIGINT, lambda *_: stray.append(True))
    try:
        with monkeypatch.context() as mp:
            mp.setattr(WidebandMeshDecoder, "_process_chunk", process)
            rc, head, err = cli(argv, devices)
    finally:
        signal.signal(signal.SIGINT, old)
    assert rc == 0 and not stray and "interrupted" in err
    saved = load_checkpoint(ck)
    assert isinstance(saved, WidebandCheckpoint)
    assert saved.chan_tail.shape == (N, probe.spec.halo)
    assert saved.byte_offset == probe.superbatch_bytes
    rc, tail, err = cli(argv, devices)
    assert rc == 0 and f"resumed from checkpoint at byte {saved.byte_offset}" in err
    assert head + tail == want and 0 < len(head) < len(want)
    assert not os.path.exists(ck + ".meta.json")


# ---------------------------------------------------------------------------
# On the card


def build_kernels(shapes):
    """K1 and the K2 instantiation of every channel shard of ``shapes``,
    one nvcc each, all together (a first launch would build them one by
    one)."""
    from rtlamr_tpu_torch.ops import build
    from rtlamr_tpu_torch.ops.channelizer_fused import kernel_library

    libs = ["decode_stencil"] + [kernel_library(N, True, c0, N // cdev)
                                 for cdev, _ in shapes for c0 in range(0, N, N // cdev)]
    build.build_many(list(dict.fromkeys(libs)))


@pytest.mark.cuda
def test_cuda_wideband_mesh_matches_wideband_decoder():
    """On one card, through K1 and the block instantiations of K2: mesh
    (2, 2) and (4, 1) with their shards repeating the card equal the
    WidebandDecoder; K2 runs once a (channel shard, time shard) a
    super-batch, K1 once a window of every channel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer and stencil kernels run only there")
    build_kernels([(1, 1), (2, 2), (4, 1)])
    single = port_wide(device=None)
    for shape in ((2, 2), (4, 1)):
        dec = port_mesh(shape, device=None)
        wb = seam_capture(dec)
        k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
        got = as_list(dec.decode_capture(wb))
        batches = dec.export_state()["window_index"] // (dec.tdev * dec.scan_windows)
        assert channelize_requantize_fused.launches - k2 == batches * shape[0] * shape[1]
        assert decode_stencil.launches - k1 == (
            batches * dec.tdev * dec.scan_windows * N + dec.metrics_snapshot()["hit_overflows"])
        assert got == as_list(single.decode_capture(wb)) and len(got) >= 5
    assert dryrun(4) == 4


@pytest.mark.cuda
def test_cuda_wideband_mesh_a_shard_a_card(tmp_path):
    """With four cards the CLI's default layout puts one shard on each
    ((4, 1) for four channels): the stream equals the single-card
    WidebandDecoder's, K2 launches on every card, and at mesh (2, 2) the
    decode halo crosses cards."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 4:
        pytest.skip("needs four CUDA cards: one shard on each")
    build_kernels([(1, 1), (2, 2), (4, 1)])
    single = port_wide(device=None)
    for shape in ((2, 2), (4, 1), (1, 4)):
        dec = WidebandMeshDecoder([new_parser(x, CHIP) for x in ALL], n_channels=N,
                                  mesh_shape=shape, window_blocks=WINDOW_BLOCKS)
        assert [d.index for d in dec.devices] == [0, 1, 2, 3]
        wb = seam_capture(dec)
        k2 = channelize_requantize_fused.launches
        assert as_list(dec.decode_capture(wb)) == as_list(single.decode_capture(wb))
        assert channelize_requantize_fused.launches > k2
    path = tmp_path / "wideband.bin"
    wb.tofile(path)
    rc, want, _ = cli(CLI_ARGS + [f"-fromfile={path}"], None)
    rc2, got, err = cli(CLI_ARGS + ["-mesh", f"-fromfile={path}"], None)
    assert rc == rc2 == 0 and got == want and len(want) >= 5
    assert "wideband mesh: 4 channel-shards x 1 time-shards over 4 devices" in err
