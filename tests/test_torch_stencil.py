"""The port's decode stencil (rtlamr_tpu_torch/ops/stencil.py) against the
JAX package's: the plain jnp stage (``_bits_q6_jnp_staged`` + ``_masks_jnp``)
and the Pallas kernel ``frontend_pallas_staged``, run in interpret mode on
the CPU as tests/test_pallas.py runs it. Everything is integer, so equality
is exact. The CUDA kernel itself is held against the plain version by the
``cuda``-marked test, which runs only on a machine with a card.

The JAX package is imported inside the tests that use it, so the ``cuda``
test also collects on a card machine without JAX:
``python -m pytest --noconftest tests/test_torch_stencil.py -m cuda``."""

import pathlib
import types

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.ops import spec as ts
from rtlamr_tpu_torch.ops.stencil import (
    CTAS_PER_SM,
    decode_stencil,
    stencil_plain,
    stencil_plan,
)
from rtlamr_tpu_torch.protocols import new_parser as torch_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config as torch_config
from rtlamr_tpu_torch.ref import synth

# The suite runs in several worker processes at once; torch's default of one
# intra-op thread per core in each of them oversubscribes the CPU.
torch.set_num_threads(1)

NAMES =("scm", "scm+", "idm", "r900")
SAMPLE_BIN = pathlib.Path(__file__).parent / "fixtures" / "sample.bin"


def jax_ref():
    """The JAX package's stencil versions."""
    import jax.numpy as jnp

    from rtlamr_tpu.ops import frontend
    from rtlamr_tpu.ops.pallas_frontend import frontend_pallas_staged
    from rtlamr_tpu.protocols import new_parser
    from rtlamr_tpu.protocols.base import build_decoder_config

    return types.SimpleNamespace(
        jnp=jnp, jf=frontend, pallas=frontend_pallas_staged,
        parser=new_parser, config=build_decoder_config,
    )


def spec_pair(names, chip_length, window_blocks):
    ref = jax_ref()
    js = ref.jf.make_frontend_spec(
        ref.config([ref.parser(n, chip_length) for n in names]), window_blocks
    )
    return js, torch_spec(names, chip_length, window_blocks)


def torch_spec(names, chip_length, window_blocks):
    return ts.make_frontend_spec(
        torch_config([torch_parser(n, chip_length) for n in names]), window_blocks
    )


def staged_input(spec, kind: str, seed: int) -> np.ndarray:
    """A staged u16 window: seeded random IQ, or a planted SCM + R900
    packet pair in noise. Search position q looks for a packet starting at
    capture sample q (the capture begins a halo before the window)."""
    if kind == "random":
        rng = np.random.default_rng(seed)
        iq = rng.integers(0, 256, 2 * spec.total_samples, dtype=np.uint8)
    else:
        bursts = [
            synth.bits_to_burst(
                synth.make_scm_bits(meter_id=777, consumption=1), 100
            ),
            # after the SCM packet's 96 symbols
            synth.r900_burst(
                synth.make_r900_symbols(meter_id=4242),
                100 + 100 * spec.symbol_length,
            ),
        ]
        iq = synth.render_iq(
            spec.total_samples, bursts, spec.chip_length, noise=2.0, seed=seed
        )
    return ts.stage_host(spec, iq)


def as_np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("kind", ["random", "packet"])
@pytest.mark.parametrize("chip_length,window_blocks", [(8, 8), (72, 4)])
def test_stencil_matches_jax(chip_length, window_blocks, kind, first):
    js, tsp = spec_pair(NAMES, chip_length, window_blocks)
    staged = staged_input(tsp, kind, seed=chip_length)
    bits, q6, mask = stencil_plain(tsp, torch.from_numpy(staged), first)
    assert bits.dtype == q6.dtype == mask.dtype == torch.uint8
    assert mask.shape == (tsp.window // 128, 128)

    ref = jax_ref()
    x, f = ref.jnp.asarray(staged), ref.jnp.asarray(first)
    jb, jq = ref.jf._bits_q6_jnp_staged(js, x, f)
    jm = ref.jf._masks_jnp(js, jb)
    pb, pq, pm = ref.pallas(js, x, f)
    for got, want_jnp, want_pallas in ((bits, jb, pb), (q6, jq, pq), (mask, jm, pm)):
        np.testing.assert_array_equal(got.numpy(), as_np(want_jnp))
        np.testing.assert_array_equal(got.numpy(), as_np(want_pallas))
    if kind == "packet" and not first:  # the planted preambles are found
        hit_groups = np.bitwise_or.reduce(mask.numpy().reshape(-1))
        assert hit_groups & 0b1001 == 0b1001  # SCM (group 0), R900 (group 3)


def test_stencil_without_r900_group():
    """SCM alone at chip length 78 (the golden capture's spec): no q6."""
    js, tsp = spec_pair(("scm",), 78, window_blocks=4)
    iq = np.fromfile(SAMPLE_BIN, np.uint8)[: 2 * tsp.total_samples]
    staged = ts.stage_host(tsp, iq)
    for first in (True, False):
        bits, q6, mask = stencil_plain(tsp, torch.from_numpy(staged), first)
        assert q6 is None
        ref = jax_ref()
        x, f = ref.jnp.asarray(staged), ref.jnp.asarray(first)
        jb, jq = ref.jf._bits_q6_jnp_staged(js, x, f)
        assert jq is None
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref.jf._masks_jnp(js, jb)))


def test_wrapper_dispatch():
    """A CPU tensor runs the plain version and counts no kernel launch;
    a device that is neither CPU nor CUDA is refused."""
    tsp = torch_spec(NAMES, 8, window_blocks=8)
    staged = torch.from_numpy(staged_input(tsp, "packet", seed=3))
    before = decode_stencil.launches
    got = decode_stencil(tsp, staged, False)
    want = stencil_plain(tsp, staged, False)
    assert decode_stencil.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_stencil(tsp, staged.to("meta"), False)


def staged_case(spec, kind: str, seed: int = 5) -> np.ndarray:
    """``staged_input``'s windows, or a constant one: every staged u16 zero
    (each magnitude 130,050, so a strip's uint32 prefix wraps, every filter
    output is 0 and every bit 1) or 0x8080 (magnitudes 2, ties everywhere)."""
    if kind in ("zeros", "0x8080"):
        value = 0 if kind == "zeros" else 0x8080
        return np.full(ts.staged_geometry(spec).staged_samples, value, np.uint16)
    return staged_input(spec, kind, seed)


def strip_reads(spec, plan, k):
    """Staged samples strip ``k`` loads, ``[start, end)``, and the end of
    those its stored outputs depend on (cp.async zero-fills any load past
    the buffer, which only positions past every output length read)."""
    geo = ts.staged_geometry(spec)
    q0 = k * plan.strip_len
    q1 = min(q0 + plan.strip_len, geo.lp)
    start = q0 + spec.pad_shift - plan.shift
    sl = spec.symbol_length
    last = [q1 - 1 + sl, min(q1, spec.window) - 1 + geo.pre_reach + sl]  # bits, mask
    if spec.wants_r900:
        last.append(min(q1, geo.lq) - 1 + sl + 4 * spec.chip_length)
    return start, start + plan.n_steps * plan.sub_tile, max(last) + spec.pad_shift


# The specs of the kernel's edge cases: the throughput spec (lp =
# 8,494,448, not a multiple of 32), CL 8 at 4 blocks (fewer positions than
# one strip per SM), and SCM only at CL 78 (no q6; pad_shift % 8 = 4).
PLAN_SPECS = [(NAMES, 72, 1024), (NAMES, 8, 4), (("scm",), 78, 64), (NAMES, 72, 16)]


@pytest.mark.parametrize("n_sm", [132, 4])
@pytest.mark.parametrize("names,chip_length,window_blocks", PLAN_SPECS)
def test_stencil_plan_covers_window(names, chip_length, window_blocks, n_sm):
    """The kernel's strips cover [0, lp) exactly once, each in whole steps
    with its halo, and what each strip's outputs read lies inside the
    staged buffer and inside what the strip loads."""
    spec = torch_spec(names, chip_length, window_blocks)
    geo = ts.staged_geometry(spec)
    plan = stencil_plan(spec, n_sm)
    assert plan.strip_len % 32 == 0 and plan.d_bits % 32 == 0 and plan.d_mask % 32 == 0
    assert plan.lookback % 8 == 0 and plan.n_strips <= CTAS_PER_SM * n_sm
    assert plan.n_steps * plan.sub_tile >= plan.strip_len + plan.d_mask
    covered = np.zeros(geo.lp, np.int32)
    for k in range(plan.n_strips):
        lo, hi = k * plan.strip_len, min((k + 1) * plan.strip_len, geo.lp)
        assert lo < hi  # no empty strip
        covered[lo:hi] += 1
        start, end, need = strip_reads(spec, plan, k)
        assert 0 <= start and start % 8 == 0  # 16-byte aligned loads
        assert need <= geo.staged_samples and need <= end
    assert (covered == 1).all()
    if chip_length == 8 and n_sm == 132:
        assert plan.n_strips < n_sm  # a grid smaller than the card


def pack_words(bits: np.ndarray, n_words: int) -> np.ndarray:
    """Bit i of the stream at bit i % 32 of word i // 32 (a ballot's order)."""
    padded = np.zeros(32 * n_words, np.uint64)
    padded[: bits.size] = bits
    return (padded.reshape(-1, 32) << np.arange(32, dtype=np.uint64)).sum(1).astype(np.uint32)


def funnel_r(lo: np.ndarray, hi: np.ndarray, sh: np.ndarray) -> np.ndarray:
    """``__funnelshift_r(lo, hi, sh)`` for sh in [0, 32)."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> sh.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def words_to_mask(accs, n_pos: int) -> np.ndarray:
    """One byte a position from the per-group 32-position accumulators."""
    out = np.zeros((accs[0].size, 32), np.uint8)
    for g, acc in enumerate(accs):
        out |= (((acc[:, None] >> np.arange(32, dtype=np.uint32)) & 1) << g).astype(np.uint8)
    return out.reshape(-1)[:n_pos]


def packed_bank(spec, bits: np.ndarray) -> np.ndarray:
    """The kernel's preamble bank over packed words: for symbol k, the word
    at offset k SL by a funnel shift of two words, shared by every group,
    ANDed (or its complement) into one accumulator a group."""
    sl, w = spec.symbol_length, spec.window
    words = pack_words(bits, -(-bits.size // 32) + 2)
    i0 = 32 * np.arange(-(-w // 32))
    accs = [np.full(i0.size, 0xFFFFFFFF, np.uint32) for _ in spec.groups]
    for k in range(max(len(g.bits) for g in spec.groups)):
        p = i0 + k * sl
        word = funnel_r(words[p >> 5], words[(p >> 5) + 1], p & 31)
        for g, group in enumerate(spec.groups):
            if k < len(group.bits):
                accs[g] &= word if group.bits[k] else ~word
    return words_to_mask(accs, w).reshape(w // 128, 128)


@pytest.mark.parametrize("kind", ["random", "packet"])
@pytest.mark.parametrize("chip_length", [8, 72])
def test_packed_preamble_bank(chip_length, kind):
    """The packed funnel-shift bank, in numpy, equals ``masks_plain``."""
    spec = torch_spec(NAMES, chip_length, 8 if chip_length == 8 else 4)
    bits, _, mask = stencil_plain(spec, torch.from_numpy(staged_input(spec, kind, 11)), False)
    np.testing.assert_array_equal(packed_bank(spec, bits.numpy()), mask.numpy())
    if kind == "packet":
        assert mask.numpy().any()


def emulate_kernel(spec, plan, staged: np.ndarray, first: bool):
    """The kernel's strip and step loop in numpy, index for index: the
    linear prefix buffer with its carried lookback, the packed bit-word
    buffer with its carried words (both start as noise, apart from the
    prefix 0 before sample 0), the element mag - 130,050 whose constant
    cancels in every balanced filter, the delays and the ragged-end stores.
    Each buffer slot carries a tag of the stream index it holds: every read
    must stay inside its buffer, and every read that a stored output depends
    on must find the index it wants. Returns the three outputs and how often
    each output byte was written."""
    geo = ts.staged_geometry(spec)
    t_sub, lb = plan.sub_tile, plan.lookback
    words, keep = t_sub // 32, (plan.d_mask - plan.d_bits) // 32
    cl, sl, n = spec.chip_length, spec.symbol_length, staged.size
    max_len = max(len(g.bits) for g in spec.groups)
    outs = {"bits": np.zeros(geo.lp, np.uint8), "q6": np.zeros(geo.lq, np.uint8),
            "mask": np.zeros(spec.window, np.uint8)}
    writes = {k: np.zeros(v.size, np.int32) for k, v in outs.items()}
    noise = np.random.default_rng(0)
    lane = np.arange(t_sub)
    u32 = np.uint32

    def store(name, q0, pos, end, vals):
        keep_ = (pos >= 0) & (pos < end)
        outs[name][q0 + pos[keep_]] = vals[keep_]
        writes[name][q0 + pos[keep_]] += 1

    def read(buf, tag, idx, want, live):
        assert ((idx >= 0) & (idx < buf.size)).all()
        assert (tag[idx[live]] == want[live]).all()
        return buf[idx]

    for k in range(plan.n_strips):
        q0 = k * plan.strip_len
        base = q0 + spec.pad_shift - plan.shift
        ends = {"bits": min(plan.strip_len, geo.lp - q0), "q6": min(plan.strip_len, geo.lq - q0),
                "mask": min(plan.strip_len, spec.window - q0)}
        zero_samples = spec.halo_staged - base if first else 0
        zero_bits = spec.packet_length - q0 if first else -(1 << 30)
        # what the kernel skips: bits no output needs, and their samples
        bits_need = min(plan.strip_len + plan.d_mask - plan.d_bits, geo.lp - q0)
        samples_need = bits_need + plan.d_bits
        buf = noise.integers(0, 1 << 32, t_sub + lb, dtype=np.uint64).astype(u32)
        btag = np.full(t_sub + lb, -(1 << 40))
        buf[lb - 1], btag[lb - 1] = 0, -1  # I[-1] = 0
        bw = noise.integers(0, 1 << 32, plan.bit_words, dtype=np.uint64).astype(u32)
        wtag = np.full(plan.bit_words, -(1 << 40))
        carry = 0
        for t in range(plan.n_steps):
            if t > 0:  # carry the lookback sums and the newest bit words
                buf[:lb], btag[:lb] = buf[t_sub:].copy(), btag[t_sub:].copy()
                bw[:keep], wtag[:keep] = bw[words : words + keep].copy(), wtag[words : words + keep].copy()

            def prefix(j, live):  # I[j] of local sample j
                return read(buf, btag, j - t * t_sub + lb, j, live)

            def word_at(w, live):  # bit word w (positions 32w ..)
                return read(bw, wtag, w - (t * t_sub - plan.d_mask) // 32, w, live)

            # A: element mag - 130050 = -4 (I(255-I) + Q(255-Q)), and its prefix
            s = base + t * t_sub + lane
            v = np.where(s < n, staged[np.minimum(s, n - 1)], 0).astype(np.int64)
            lo, hi = v & 255, v >> 8
            dec = np.where(t * t_sub + lane < zero_samples, 130050,
                           4 * (lo * (255 - lo) + hi * (255 - hi)))
            dec[(t * t_sub + lane) // 8 * 8 >= samples_need] = 0
            pre = ((carry - np.cumsum(dec)) & 0xFFFFFFFF).astype(u32)
            buf[lb:], btag[lb:] = pre, t * t_sub + lane
            carry = int(pre[-1])
            # B: bits, d_bits behind, packed by 32
            i = t * t_sub - plan.d_bits + lane
            j = i + plan.shift
            live = (i >= 0) & (i < ends["bits"] + max_len * sl)
            f = 2 * prefix(j + cl - 1, live) - prefix(j - 1, live) - prefix(j + sl - 1, live)
            b = (f.view(np.int32) >= 0) & (i >= zero_bits)
            made = (i[::32] + 32 > 0) & (i[::32] < bits_need)
            bw[keep : keep + words][made] = pack_words(b, words)[made]
            wtag[keep : keep + words][made] = (i[::32] >> 5)[made]
            if spec.wants_r900:
                iq = t * t_sub - plan.d_bits + lane
                x0 = iq + plan.shift + sl - 1
                e = [prefix(x0 + m * cl, (iq >= 0) & (iq < ends["q6"])) for m in range(5)]
                d = [(e[m + 1] - e[m]).view(np.int32).astype(np.int64) for m in range(4)]
                a = np.stack([(d[0] + d[1]) - (d[2] + d[3]), d[0] - d[1] + d[2] - d[3],
                              d[0] - d[1] - d[2] + d[3]])
                arg = np.argmax(np.abs(a), axis=0)
                chosen = np.take_along_axis(a, arg[None], 0)[0]
                store("q6", q0, iq, ends["q6"], (arg + 3 * (chosen > 0)).astype(np.uint8))
            # C1: mask words, d_mask behind
            i0 = t * t_sub - plan.d_mask + 32 * np.arange(words)
            accs = [np.full(i0.size, 0xFFFFFFFF, u32) for _ in spec.groups]
            live = (i0 + 32 > 0) & (i0 < ends["mask"])
            for kk in range(max_len):
                p = i0 + kk * sl
                word = funnel_r(word_at(p >> 5, live),
                                word_at((p >> 5) + 1, live & (p % 32 > 0)), p & 31)
                for g, group in enumerate(spec.groups):
                    if kk < len(group.bits):
                        accs[g] &= word if group.bits[kk] else ~word
            store("mask", q0, (i0[:, None] + np.arange(32)).reshape(-1), ends["mask"],
                  words_to_mask(accs, t_sub))
            # C2: the bits of this step from the packed words
            ib = t * t_sub - plan.d_bits + lane
            live = (ib >= 0) & (ib < ends["bits"])
            store("bits", q0, ib, ends["bits"],
                  ((word_at(ib >> 5, live) >> (ib & 31).astype(u32)) & 1).astype(np.uint8))
    q6 = outs["q6"] if spec.wants_r900 else None
    return outs["bits"], q6, outs["mask"].reshape(-1, 128), writes


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("case", [
    (NAMES, 8, 4, "random", 132), (NAMES, 8, 4, "packet", 4), (("scm",), 78, 4, "packet", 4),
    (NAMES, 72, 16, "zeros", 4), (NAMES, 72, 16, "0x8080", 4), (NAMES, 72, 16, "packet", 8),
])
def test_kernel_emulation_matches_plain(case, first):
    """The kernel's algorithm, emulated in numpy with its launch plan, equals
    the plain stencil byte for byte and writes each output byte once:
    strips smaller than one per SM, preambles across strip boundaries, the
    first-window bounds inside a strip, the uint32 prefix wrapping (all-zero
    bytes), ties (0x8080) and no q6 (SCM only)."""
    names, chip_length, window_blocks, kind, n_sm = case
    spec = torch_spec(names, chip_length, window_blocks)
    plan = stencil_plan(spec, n_sm)
    staged = staged_case(spec, kind)
    bits, q6, mask, writes = emulate_kernel(spec, plan, staged, first)
    want = stencil_plain(spec, torch.from_numpy(staged), first)
    for got, ref in zip((bits, q6, mask), want):
        assert (got is None) == (ref is None)
        if got is not None:
            np.testing.assert_array_equal(got, ref.numpy())
    assert all((w == 1).all() for name, w in writes.items() if name != "q6" or q6 is not None)
    if kind == "zeros":  # the prefix wraps within a strip
        assert plan.n_steps * plan.sub_tile * 130050 > 1 << 32
        assert first or bits.all()  # every f is 0, every bit 1


CUDA_CASES = [  # (protocols, chip length, window blocks, staged windows)
    (NAMES, 72, 1024, ("random", "packet", "zeros", "0x8080")),
    (NAMES, 72, 64, ("random", "packet")),
    (("scm",), 78, 64, ("random", "packet")),
    (NAMES, 8, 4, ("random", "packet", "zeros")),
]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel equals its plain version on the card, byte for byte,
    ``first`` both ways: the full 1024-block throughput spec on random,
    planted, all-zero (the strip prefix wraps) and 0x8080 (ties) windows,
    64 blocks, SCM only at CL 78 (no q6) and CL 8 at 4 blocks (fewer
    strips than SMs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode stencil kernel runs only there")
    for names, chip_length, window_blocks, kinds in CUDA_CASES:
        spec = torch_spec(names, chip_length, window_blocks)
        for kind in kinds:
            staged = torch.from_numpy(staged_case(spec, kind)).cuda()
            for first in (True, False):
                before = decode_stencil.launches
                got = decode_stencil(spec, staged, first)
                assert decode_stencil.launches == before + 1
                want = stencil_plain(spec, staged, first)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert (a is None) == (b is None)
                    if a is not None:
                        assert a.is_cuda and torch.equal(a, b), (names, chip_length, kind, first)
    with pytest.raises(ValueError):
        decode_stencil(spec, staged[:-1], False)  # wrong length
    with pytest.raises(ValueError):  # not 16-byte aligned
        decode_stencil(spec, torch.zeros(staged.numel() + 1, dtype=torch.uint16,
                                         device="cuda")[1:], False)
