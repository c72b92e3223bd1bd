"""The port's streaming ``WindowDecoder`` (rtlamr_tpu_torch/decoder) against
the JAX package's and the port's copy of the NumPy oracle: identical message streams on the
golden capture and on synthetic all-protocol captures fed in odd chunks,
through overflow escalation, the batch path, and a stream handed over
mid-capture from the JAX decoder to the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlamr_tpu.decoder import WindowDecoder as JaxDecoder
from rtlamr_tpu.protocols import new_parser as jax_parser
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.ops.spec import staged_geometry
from rtlamr_tpu_torch.protocols import new_parser as torch_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

SIX =["scm", "scm+", "idm", "netidm", "r900", "r900bcd"]
SAMPLE_BIN_GOLDEN = [
    (4, 17580293, 111414),
    (8, 17578504, 243171),
    (13, 17479804, 798754),
    (17, 17564085, 102314),
    (23, 17563920, 101614),
    (27, 17565073, 1657255),
    (32, 58418772, 102814),
    (37, 17565099, 101614),
    (41, 17561667, 61799),
    (46, 17569243, 101714),
    (51, 31553606, 7120),
    (55, 17556728, 110714),
    (59, 17556726, 1407059),
    (68, 20240556, 3907400),
]


def port(names, chip_length=72, **kw):
    return WindowDecoder(
        [torch_parser(n, chip_length) for n in names], device="cpu", **kw
    )


def jax_dec(names, chip_length=72, **kw):
    return JaxDecoder([jax_parser(n, chip_length) for n in names], **kw)


def as_list(msgs):
    return [(b, str(m)) for b, m in msgs]


def oracle(names, iq, chip_length=72):
    dec = ReferenceDecoder(
        [torch_parser(n, chip_length) for n in names], arithmetic="int"
    )
    return as_list(dec.decode_capture(iq))


def synth_capture(names, chip_length=72, noise=3.0, n_packets=8, seed=11):
    """Bursts of every named protocol spread over many blocks (one packet
    straddles a block boundary)."""
    cfg = build_decoder_config([torch_parser(n, chip_length) for n in names])
    gap = cfg.packet_length + 3 * cfg.block_size
    bursts, offset = [], cfg.block_size - cfg.preamble_length // 2
    for i in range(n_packets):
        kind = names[i % len(names)]
        if kind == "scm":
            bits = synth.make_scm_bits(meter_id=100000 + i, consumption=i * 7)
        elif kind == "scm+":
            bits = synth.make_scmplus_bits(endpoint_id=200000 + i, consumption=i)
        elif kind == "idm":
            bits = synth.make_idm_bits(serial=300000 + i)
        elif kind == "netidm":
            bits = synth.make_netidm_bits(serial=400000 + i)
        else:
            bits = None
        if bits is None:
            digits = synth.make_r900_symbols(meter_id=500000 + i, consumption=i)
            bursts.append(synth.r900_burst(digits, offset))
        else:
            bursts.append(synth.bits_to_burst(bits, offset))
        offset += gap
    total = ((offset + cfg.packet_length) // cfg.block_size + 2) * cfg.block_size
    return synth.render_iq(total, bursts, chip_length, noise=noise, seed=seed)


def feed_in_chunks(dec, iq, seed=0, lo=1000, hi=90000):
    rng = np.random.default_rng(seed)
    out, pos = [], 0
    while pos < iq.size:
        n = int(rng.integers(lo, hi)) | 1  # odd sizes split IQ byte pairs
        out.extend(dec.feed(iq[pos : pos + n]))
        pos += n
    out.extend(dec.flush())
    return out


def test_sample_bin_golden(sample_bin):
    got = port(["scm"], 78, window_blocks=16).decode_capture(sample_bin)
    assert [(b, m.ID, m.Consumption) for b, m in got] == SAMPLE_BIN_GOLDEN
    want_jax = as_list(jax_dec(["scm"], 78, window_blocks=16).decode_capture(sample_bin))
    assert as_list(got) == want_jax == oracle(["scm"], sample_bin, 78)


def test_six_protocols_odd_chunks_match_jax():
    iq = synth_capture(SIX, chip_length=72, n_packets=8)
    got = as_list(feed_in_chunks(port(SIX, window_blocks=8), iq))
    want = as_list(jax_dec(SIX, window_blocks=8).decode_capture(iq))
    assert got == want
    assert got == oracle(SIX, iq)
    assert len(got) >= 8


def test_state_handover_from_jax():
    """Run the first part of a capture in the JAX decoder, move its stream
    state over, finish in the port: the same stream as one JAX run."""
    names = ["scm", "scm+", "idm", "r900"]
    iq = synth_capture(names, chip_length=8, n_packets=12, seed=4)
    want = as_list(jax_dec(names, 8, window_blocks=4).decode_capture(iq))

    first = jax_dec(names, 8, window_blocks=4)
    cut = int(iq.size * 0.45) | 1
    head = first.feed(iq[:cut]) + first.drain()
    state = {
        "carry": np.asarray(first._carry),
        "first": first._first,
        "window_index": first._window_index,
        "last_block": first._last_block,
        "dedup_prev": first._deduper.prev,
        "dedup_next": first._deduper.next,
        "pending": np.asarray(first._pending),
    }
    assert state["window_index"] > 0 and head
    dec = port(names, 8, window_blocks=4)
    dec.load_state(state)
    tail = dec.feed(iq[cut:]) + dec.flush()
    assert as_list(head) + as_list(tail) == want

    # The port's own export/load round trip continues the same way.
    a = port(names, 8, window_blocks=4)
    head2 = a.feed(iq[:cut]) + a.drain()
    b = port(names, 8, window_blocks=4)
    b.load_state(a.export_state())
    assert as_list(head2 + b.feed(iq[cut:]) + b.flush()) == want


def test_export_state_needs_drain():
    iq = synth_capture(["scm"], chip_length=8, n_packets=3)
    dec = port(["scm"], 8, window_blocks=4)
    dec.feed(iq)
    with pytest.raises(RuntimeError, match="drain"):
        dec.export_state()
    dec.drain()
    assert dec.export_state()["window_index"] > 0


@pytest.mark.parametrize("exact_fallback", [False, True])
def test_overflow_escalation_matches_jax(exact_fallback):
    """More candidates than max_hits (two packets in a window, one slot)
    escalate to the high-capacity variant and, when that overflows too, to
    the exact NumPy path."""
    iq = synth_capture(["scm"], noise=0.0, n_packets=6)
    decs = [port(["scm"], window_blocks=8, max_hits=1),
            jax_dec(["scm"], window_blocks=8, max_hits=1)]
    if exact_fallback:
        for d in decs:
            d._big_spec_cache = dataclasses.replace(
                d.spec, max_hits=1, gather_hits=4, slice_hits=2, gather_rows=1
            )
    got, want = (as_list(d.decode_capture(iq)) for d in decs)
    assert got == want == oracle(["scm"], iq)
    assert decs[0].metrics.hit_overflows == decs[1].metrics.hit_overflows > 0


def test_staged_batch_matches_sequential_and_jax(sample_bin):
    dec = port(["scm"], 78, window_blocks=4)
    spec = dec.spec
    geo = staged_geometry(spec)
    w, k = spec.window, 4
    full = np.zeros((k - 1) * w + geo.staged_samples, np.uint16)
    u16 = sample_bin[: 2 * (spec.halo + k * w)].view(np.uint16)
    full[spec.pad_shift : spec.pad_shift + u16.size] = u16
    batch = np.stack([full[i * w : i * w + geo.staged_samples] for i in range(k)])

    dec._first = False
    got_batch = as_list(dec.decode_staged_batch(torch.from_numpy(batch)))
    dec.reset()
    dec._first = False
    got_seq = as_list(dec.decode_staged([torch.from_numpy(b) for b in batch]))
    jd = jax_dec(["scm"], 78, window_blocks=4)
    jd._first = False
    want = as_list(jd.decode_staged_batch(jnp.asarray(batch)))
    assert got_batch == got_seq == want
    assert got_batch


def test_feed_copies_the_chunk(sample_bin):
    want = as_list(port(["scm"], 78, window_blocks=8).decode_capture(sample_bin))
    dec = port(["scm"], 78, window_blocks=8)
    buf = np.empty(50000, np.uint8)
    out = []
    for pos in range(0, sample_bin.size, buf.size):
        part = sample_bin[pos : pos + buf.size]
        buf[: part.size] = part
        out.extend(dec.feed(buf[: part.size]))
        buf[:] = 0  # reusing the read buffer must not change the result
    out.extend(dec.flush())
    assert as_list(out) == want


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WindowDecoder([torch_parser("scm", 72)])


def random_capture(rng, names, chip_length):
    """tests/test_fuzz_conformance.py's random capture: 1-5 packets of the
    named protocols at random offsets, random levels and noise."""
    cfg = build_decoder_config([torch_parser(n, chip_length) for n in names])
    total = int(rng.integers(20, 60)) * cfg.block_size
    bursts = []
    for _ in range(int(rng.integers(1, 6))):
        kind = names[int(rng.integers(len(names)))]
        offset = int(rng.integers(0, max(1, total - cfg.packet_length)))
        if kind == "scm":
            bits = synth.make_scm_bits(
                meter_id=int(rng.integers(1, 1 << 26)),
                meter_type=int(rng.integers(16)),
                consumption=int(rng.integers(1 << 24)),
            )
        elif kind == "scm+":
            bits = synth.make_scmplus_bits(
                endpoint_id=int(rng.integers(1, 1 << 32)),
                endpoint_type=int(rng.integers(256)),
                consumption=int(rng.integers(1 << 32)),
            )
        elif kind == "idm":
            bits = synth.make_idm_bits(
                serial=int(rng.integers(1, 1 << 32)),
                intervals=[int(v) for v in rng.integers(0, 512, 47)],
            )
        elif kind == "netidm":
            bits = synth.make_netidm_bits(serial=int(rng.integers(1, 1 << 32)))
        else:
            bits = None
        if bits is None:
            digits = synth.make_r900_symbols(
                meter_id=int(rng.integers(1, 1 << 32)),
                consumption=int(rng.integers(1 << 24)),
            )
            bursts.append(synth.r900_burst(digits, offset))
        else:
            bursts.append(synth.bits_to_burst(bits, offset))
    return synth.render_iq(
        total, bursts, chip_length, hi=int(rng.integers(170, 255)),
        noise=float(rng.uniform(0, 8)), seed=int(rng.integers(1 << 30)),
    )


@pytest.mark.parametrize("seed", range(8))
def test_random_capture_conformance(seed):
    """Random protocol mixes, chip lengths, window sizes and capacities: the
    port's stream equals the exact-int oracle's."""
    rng = np.random.default_rng(2000 + seed)
    chip_length = int(rng.choice([8, 32, 56, 72]))
    names = list(rng.choice(SIX, size=int(rng.integers(1, len(SIX) + 1)), replace=False))
    iq = random_capture(rng, names, chip_length)
    want = oracle(names, iq, chip_length)
    cfg = build_decoder_config([torch_parser(n, chip_length) for n in names])
    halo_blocks = -(-(cfg.packet_length + cfg.symbol_length) // cfg.block_size)
    dec = port(
        names, chip_length,
        window_blocks=max(int(rng.choice([2, 8, 32])), halo_blocks),
        max_hits=int(rng.choice([16, 256])),
    )
    assert as_list(dec.decode_capture(iq)) == want, (seed, names, chip_length)
