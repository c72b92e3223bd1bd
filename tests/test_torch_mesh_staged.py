"""The port's device-resident mesh super-batch
(rtlamr_tpu_torch/parallel/mesh.py ``stage_superbatch`` and
``MeshDecoder.decode_superbatch_staged``, whose halo ring fills each shard's
first halo on the devices) against the JAX package's ``MeshDecoder`` on
conftest's virtual CPU devices, at 1, 2 and 4 shards and 1 and 2 windows a
shard: the staged batch byte for byte, the (block, message) stream, every
super-batch's packed result rows byte for byte and the carry after each
super-batch (the JAX decoder's row 0), over two full super-batches and a
partial one, with packets on a shard boundary and on the super-batch
boundaries; the same batch decoded three times, as ``bench_mesh.py`` does;
escalated windows equal to the JAX ``_staged_window``'s; the caller's
tensors left as they were. Exact equality throughout.

The port runs ``n`` shards on ``["cpu"] * n``. The JAX package is imported
inside the helpers that use it, so the ``cuda`` test runs on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_mesh_staged.py
-m cuda`` (it needs four cards)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder import pipeline
from rtlamr_tpu_torch.ops.frontend import unpack_results
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.parallel.mesh import MeshDecoder, stage_superbatch
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

CHIP = 8
ALL = ("scm", "scm+", "idm", "r900")
#: symbols a burst of each kind takes, with a margin
SYMBOLS = {"scm": 100, "scm+": 132, "idm": 740, "r900": 120}


def as_list(msgs):
    return [(b, str(m)) for b, m in msgs]


def port_mesh(n, k, max_hits=256, window_blocks=None, device="cpu"):
    return MeshDecoder([new_parser(x, CHIP) for x in ALL], devices=[device] * n,
                       window_blocks=window_blocks, max_hits=max_hits, scan_windows=k)


def jax_mesh(n, k, max_hits=256):
    import jax

    from rtlamr_tpu.parallel.mesh import MeshDecoder as JaxMesh
    from rtlamr_tpu.protocols import new_parser as jax_parser

    return JaxMesh([jax_parser(x, CHIP) for x in ALL], devices=jax.devices()[:n],
                   window_blocks=None, max_hits=max_hits, scan_windows=k)


def burst(kind, i, at):
    if kind == "scm":
        return synth.bits_to_burst(synth.make_scm_bits(meter_id=100000 + i, consumption=i), at)
    if kind == "scm+":
        return synth.bits_to_burst(
            synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i), at)
    if kind == "idm":
        return synth.bits_to_burst(synth.make_idm_bits(serial=300000 + i), at)
    return synth.r900_burst(synth.make_r900_symbols(meter_id=500000 + i), at)


def capture(dec, full=None, seed=21):
    """``full`` super-batches of u8 IQ (by default as many as put two
    super-batch boundaries a packet length before the end) and half of one
    more: an SCM packet across the first shard boundary (with two shards or
    more) and across the first two super-batch boundaries, where a packet
    there can still be found, and bursts of every protocol in turn in the
    gaps. Returns the bytes and the meter IDs of the boundary packets."""
    w, sl, bs = dec.spec.window, dec.cfg.symbol_length, dec.cfg.block_size
    span = dec.n_devices * dec.scan_windows * w
    reach = dec.cfg.packet_length + bs  # the stream a packet needs after its start
    if full is None:
        total = max(2, -(-(2 * span + reach) // span)) * span + span // 2
    else:
        total = full * span
    half = SYMBOLS["scm"] * sl // 2
    edges = [e for e in (span, 2 * span, dec.scan_windows * w if dec.n_devices > 1 else 0)
             if e and e - half + reach <= total]
    bursts = [burst("scm", 9000 + i, e - half) for i, e in enumerate(edges)]
    ids = {100000 + 9000 + i for i in range(len(edges))}
    busy = [(e - half, e + half) for e in edges]
    pos, i = bs // 2, 0
    while True:
        kind = ALL[i % len(ALL)]
        end = pos + SYMBOLS[kind] * sl
        if end > total - bs:
            break
        clash = [b for a, b in busy if a < end and pos < b]
        if clash:
            pos = max(clash)
            continue
        bursts.append(burst(kind, i, pos))
        pos, i = end + bs // 4, i + 1
    return synth.render_iq(total, bursts, CHIP, noise=2.0, seed=seed), ids


def super_batches(dec, iq):
    """(bytes of one super-batch, valid_blocks) for each super-batch of
    ``iq``; the last one zero-padded with its count of whole blocks."""
    size = dec.window_bytes
    out = []
    for pos in range(0, iq.size, size):
        chunk = iq[pos : pos + size]
        if chunk.size == size:
            out.append((chunk, None))
        else:
            padded = np.zeros(size, np.uint8)
            padded[: chunk.size] = chunk
            out.append((padded, chunk.size // (2 * dec.cfg.block_size)))
    return out


def on_shards(dec, sb):
    return [torch.from_numpy(sb[s].copy()).to(dev) for s, dev in enumerate(dec.devices)]


def jax_staged(jdec, super_bytes):
    import jax

    from rtlamr_tpu.parallel.mesh import stage_superbatch as jax_stage

    sb = jax_stage(jdec.spec, super_bytes, jdec.n_devices, jdec.scan_windows)
    return sb, jax.device_put(sb, jdec._sharding)


def packed_rows(dec):
    """The in-flight super-batch's packed rows, (n*K, P)."""
    return dec._inflight[0][0].numpy().copy()


def jax_packed_rows(jdec):
    return np.asarray(jdec._inflight[1]).reshape(jdec.n_devices * jdec.scan_windows, -1)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_superbatch_matches_jax(n, k):
    dec, jdec = port_mesh(n, k), jax_mesh(n, k)
    iq, boundary_ids = capture(dec)
    msgs, want = [], []
    for super_bytes, valid in super_batches(dec, iq):
        sb = stage_superbatch(dec.spec, super_bytes, n, k)
        jsb, jsb_dev = jax_staged(jdec, super_bytes)
        np.testing.assert_array_equal(sb, jsb)
        shards = on_shards(dec, sb)
        msgs += dec.decode_superbatch_staged(shards, valid, drain=False)
        want += as_list(jdec.decode_superbatch_staged(jsb_dev, valid, drain=False))
        np.testing.assert_array_equal(packed_rows(dec), jax_packed_rows(jdec))
        np.testing.assert_array_equal(dec._carry.numpy(), np.asarray(jdec._carry)[0])
        for s in range(n):  # the caller's batch is left as it was
            np.testing.assert_array_equal(shards[s].numpy(), sb[s])
    msgs += dec.drain()
    want += as_list(jdec.drain())
    got = as_list(msgs)
    assert got == want and len(got) >= 5
    assert boundary_ids <= {m.meter_id() for _, m in msgs}
    # The same stream as the single-card decoder, and as this decoder's own
    # streaming path.
    single = WindowDecoder([new_parser(x, CHIP) for x in ALL],
                           window_blocks=dec.spec.window // dec.cfg.block_size, device="cpu")
    assert got == as_list(single.decode_capture(iq))
    assert got == as_list(port_mesh(n, k).decode_capture(iq))


def test_same_batch_three_times_matches_jax():
    """One staged batch decoded three times, dispatch-ahead, as
    bench_mesh.py times it: the stream and the packed rows equal the JAX
    decoder's each time, and the batch is unchanged."""
    n, k = 2, 2
    dec, jdec = port_mesh(n, k), jax_mesh(n, k)
    iq, _ = capture(dec, full=1)
    sb = stage_superbatch(dec.spec, iq, n, k)
    _, jsb_dev = jax_staged(jdec, iq)
    shards = on_shards(dec, sb)
    got, want = [], []
    for _ in range(3):
        got += as_list(dec.decode_superbatch_staged(shards, drain=False))
        want += as_list(jdec.decode_superbatch_staged(jsb_dev, drain=False))
        np.testing.assert_array_equal(packed_rows(dec), jax_packed_rows(jdec))
    got += as_list(dec.drain())
    want += as_list(jdec.drain())
    assert got == want and len(got) >= 3
    blocks = dec.spec.window // dec.cfg.block_size * n * k
    assert {b // blocks for b, _ in got} == {0, 1, 2}
    for s in range(n):
        np.testing.assert_array_equal(shards[s].numpy(), sb[s])


def test_escalated_windows_match_jax_staged_window(monkeypatch):
    """With one candidate slot windows overflow: each escalated window is
    re-decoded from the buffer the JAX ``_staged_window`` rebuilds (window
    0's halo from the left shard or the carry), and the stream equals the
    JAX decoder's."""
    from rtlamr_tpu.parallel.mesh import _staged_window

    n, k = 2, 2
    dec, jdec = port_mesh(n, k, max_hits=1), jax_mesh(n, k, max_hits=1)
    iq, _ = capture(dec, full=2)
    escalated = []
    big = dec._big_spec()
    program = pipeline.decode_window_staged_packed

    def record(spec, staged, first):
        if spec == big:
            escalated.append(staged.numpy().copy())
        return program(spec, staged, first)

    monkeypatch.setattr(pipeline, "decode_window_staged_packed", record)
    got, want, windows = [], [], set()
    for super_bytes, valid in super_batches(dec, iq):
        sb = stage_superbatch(dec.spec, super_bytes, n, k)
        _, jsb_dev = jax_staged(jdec, super_bytes)
        carry = dec._carry.numpy().copy()
        escalated.clear()
        msgs = dec.decode_superbatch_staged(on_shards(dec, sb), valid, drain=False)
        rows = packed_rows(dec)
        msgs += dec.drain()
        got += as_list(msgs)
        want += as_list(jdec.decode_superbatch_staged(jsb_dev, valid))
        over = [(s, kk) for s in range(n) for kk in range(k)
                if dec._overflowed(unpack_results(dec.spec, rows[s * k + kk]))]
        assert len(escalated) == len(over)
        for buf, (s, kk) in zip(escalated, over):
            np.testing.assert_array_equal(buf, _staged_window(jdec.spec, sb, s, kk, carry))
        windows |= {kk for _, kk in over}
    assert got == want and len(got) >= 3
    assert dec.metrics.hit_overflows > 0 and 0 in windows  # a first window escalated


def test_refuses_a_batch_of_another_layout():
    dec = port_mesh(2, 2)
    size = dec.window_bytes
    sb = on_shards(dec, stage_superbatch(dec.spec, np.zeros(size, np.uint8), 2, 2))
    for bad in (sb[:1], [sb[0], sb[1][:1]], [sb[0], sb[1].view(torch.int16)]):
        with pytest.raises(ValueError, match="decode_superbatch_staged"):
            dec.decode_superbatch_staged(bad)


@pytest.mark.cuda
def test_cuda_a_shard_a_card_equals_window_decoder():
    """One shard on each of four cards at 1024-block windows: the halo ring
    copies each shard's first halo card to card, and the stream of a
    device-resident decode equals the WindowDecoder's on the same capture;
    K1 runs once a window (plus escalations)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 4:
        pytest.skip("needs four CUDA cards: one shard on each")
    names = ALL
    devices = [f"cuda:{i}" for i in range(4)]
    dec = MeshDecoder([new_parser(x, 72) for x in names], devices=devices, window_blocks=1024)
    w, bs = dec.spec.window, dec.cfg.block_size
    span = dec.n_devices * dec.scan_windows * w
    half = SYMBOLS["scm"] * dec.cfg.symbol_length // 2
    edges = [s * dec.scan_windows * w for s in range(1, 4)] + [span]
    bursts = [burst("scm", 7000 + i, e - half) for i, e in enumerate(edges)]
    bursts += [burst(kind, i, i * w + w // 3) for i, kind in enumerate(names * 2)]
    iq = synth.render_iq(span + span // 2, bursts, 72, noise=3.0, seed=4)
    before = decode_stencil.launches
    msgs = []
    batches = super_batches(dec, iq)
    for super_bytes, valid in batches:
        sb = stage_superbatch(dec.spec, super_bytes, 4, dec.scan_windows)
        msgs += dec.decode_superbatch_staged(on_shards(dec, sb), valid, drain=False)
    msgs += dec.drain()
    launches = decode_stencil.launches - before
    assert launches == len(batches) * 4 * dec.scan_windows + dec.metrics.hit_overflows
    single = WindowDecoder([new_parser(x, 72) for x in names], window_blocks=1024, device=None)
    assert as_list(msgs) == as_list(single.decode_capture(iq)) and len(msgs) >= 8
    assert {100000 + 7000 + i for i in range(4)} <= {m.meter_id() for _, m in msgs}
