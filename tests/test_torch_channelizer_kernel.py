"""The channelizer kernel's exact arithmetic and index plan, emulated on the
CPU.

``csrc/channelizer.cu`` replaces conversions and most of the mix's products
by exact equivalents, and walks the stream by the plan of
``ops/channelizer_fused.py`` :func:`channelizer_plan`. The card is not here,
so each of those forms is written below in numpy float32 (every product and
sum rounded on its own, as the kernel's ``__fmul_rn``/``__fadd_rn`` are)
and held to the plain version ``channelize_requantize_plain`` byte for byte:

- the DC removal ``2^22 + byte`` from the bits, minus ``2^22 + 127.5``, over
  every u16 sample;
- the requantize ``clip(v + 127.5, 0, 255) + 1.5 x 2^23``, the byte read
  from the bits, over every .5 boundary in [-2^21, 2^21] and its
  neighbours;
- each chain started by its first product, not ``0 +`` it, in the branches
  and (as a copy) in the mix;
- the mix as the shared-product program of ``ops/channelizer_mix.py``, and
  the C++ header generated from it, read back;
- the plan: each CTA's span staged element by element or in 16-byte
  groups, into the [plane][frame % T][frame / T] layout, with a ragged
  tail, fewer frames than a tile and a misaligned head; every element a
  thread reads was staged exactly once, and nothing else.
"""

import re

import numpy as np
import pytest
import torch

import chip_smoke
from rtlamr_tpu_torch.ops import build
from rtlamr_tpu_torch.ops import channelizer as tc
from rtlamr_tpu_torch.ops.channelizer_fused import (
    FIXED_TAPS,
    THREADS,
    channelize_requantize_fused,
    channelize_requantize_plain,
    channelizer_plan,
    kernel_library,
)
from rtlamr_tpu_torch.ops.channelizer_mix import (
    MACROS,
    emulate_mix,
    mix_header,
    mix_op_count,
    mix_program,
)

torch.set_num_threads(1)

F32 = np.float32


def dc_bits(v: np.ndarray) -> np.ndarray:
    """The kernel's DC removal of u16 samples: (2, ...) float32."""
    v = v.astype(np.uint32)
    re = (np.uint32(0x4A800000) | ((v << 1) & 0x1FE)).view(np.float32)
    im = (np.uint32(0x4A800000) | ((v >> 7) & 0x1FE)).view(np.float32)
    return np.stack([re - F32(4194431.5), im - F32(4194431.5)])


def requant_bits(v: np.ndarray) -> np.ndarray:
    """The kernel's requantize of float32 values: the u8 as uint32."""
    t = np.minimum(np.maximum(v.astype(np.float32) + F32(127.5), F32(0)), F32(255))
    return (t + F32(12582912.0)).view(np.uint32) & 255


def test_dc_bits_equal_the_reference_over_every_u16():
    v = np.arange(1 << 16, dtype=np.uint32)
    got = dc_bits(v)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[0], (v & 255).astype(np.float32) - F32(127.5))
    np.testing.assert_array_equal(got[1], (v >> 8).astype(np.float32) - F32(127.5))


def test_requant_bits_equal_clip_rint_at_every_half():
    """v + 127.5 at every .5 tie, every integer, and the float32 neighbours
    of each, for v in [-2^21, 2^21]."""
    k = np.arange(-(1 << 21), (1 << 21) + 1, dtype=np.float64)
    for base in (k.astype(np.float32), (k + 0.5).astype(np.float32)):
        for v in (base, np.nextafter(base, F32(-np.inf)), np.nextafter(base, F32(np.inf))):
            want = np.clip(np.rint(v + F32(127.5)), 0, 255).astype(np.uint32)
            np.testing.assert_array_equal(requant_bits(v), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 12, 31, 32])
def test_shared_product_mix_is_exact(n):
    """The mix program, emulated, equals ``mix_channels`` float for float on
    random branch outputs, zeros among them."""
    rng = np.random.default_rng(40 + n)
    y = rng.normal(scale=60.0, size=(2, n, 2000)).astype(np.float32)
    y[:, :, :40] = 0.0
    y[:, :, 40:80] = -0.0
    want = tc.mix_channels(tc.ChannelizerSpec(n_channels=n), torch.from_numpy(y)).numpy()
    got = emulate_mix(n, y[0], y[1])
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(requant_bits(got), requant_bits(want))


def read_header_case(case: str):
    """(products, ops) of one ``case`` of the generated header, read back
    from its C++ lines in the form of a :class:`MixBranch`."""
    sign_of = {mac: sign for sign, mac in MACROS.items()}
    products, ops = [], []
    for ln in case.strip().splitlines():
        ln = ln.strip()
        k = len(products)
        if ln == f"float pr{k}[T], pi{k}[T];":
            continue
        m = re.fullmatch(rf"MIX_MUL\(pr{k}, (\S+)f, yr\); MIX_MUL\(pi{k}, (\S+)f, yi\);", ln)
        if m:
            assert m.group(1) == m.group(2)
            products.append(float.fromhex(m.group(1)))
            continue
        m = re.fullmatch(r"(MIX_\w+)\((cr|ci)\[(\d+)\], (yr|yi|p[ri]\d+)\);", ln)
        assert m, ln
        mac, acc, c, operand = m.groups()
        assert operand in ("yr", "yi") or int(operand[2:]) < len(products), ln
        operand = operand if operand in ("yr", "yi") else (operand[:2], int(operand[2:]))
        ops.append((acc, int(c), sign_of[mac], operand))
    return tuple(products), tuple(ops)


@pytest.mark.parametrize("n", range(1, tc.MAX_CHANNELS + 1))
def test_mix_program_and_header_agree(n):
    """The generated header, read back line by line, is the mix program:
    the same products as exact float32 literals, and the same
    accumulations (accumulator, channel, kind, operand) in the same order,
    one case a branch."""
    text = mix_header(n)
    assert f"template <> struct Mix<{n}> {{" in text and text.count("struct Mix<") == 1
    cases = re.findall(r"      case (\d+): \{\n(.*?)\n      \} break;", text, re.S)
    assert [int(b) for b, _ in cases] == list(range(n))
    for (_, case), br in zip(cases, mix_program(n)):
        products, ops = read_header_case(case)
        assert products == br.products and ops == br.ops
        assert all(float(np.float32(a)) == a for a in products)


@pytest.mark.parametrize("n,per_frame", [(4, 240), (12, 1192)])
def test_channelizer_work_counts_the_cheapest_form(n, per_frame):
    """chip_smoke.py's bound: 4NP - 2N for the branches, 6N + 9N for the DC
    removal and the requantize, and the mix counted from the tables with
    each accumulator's opening copy left out."""
    spec = tc.ChannelizerSpec(n_channels=n)
    work = chip_smoke.channelizer_work(spec, 1000, 1.0)
    assert work["f32_instr"] == 1000 * per_frame
    assert work["f32_instr_reference_order"] == 1000 * (32 * n + 15 * n + 8 * n * n)
    assert sum(mix_op_count(n)) == per_frame - (32 * n - 2 * n) - 15 * n
    first = [op for br in mix_program(n) for op in br.ops if op[2] == "="]
    assert sorted((acc, c) for acc, c, _, _ in first) == sorted(
        (acc, c) for acc in ("ci", "cr") for c in range(n))


def emulate_kernel(spec, hist: np.ndarray, wb: np.ndarray, first: bool, vec_in: bool):
    """csrc/channelizer.cu's index walk and arithmetic in numpy: (N, F) u16.

    Checks on the way that each CTA stages every element of its span once,
    in whole 16-byte groups where ``vec_in`` allows, and that each thread
    reads only staged elements."""
    n, p = spec.n_channels, spec.history_frames
    f_total = wb.size // n
    plan = channelizer_plan(n, p, f_total)
    t_, tile, sub = plan.per_thread, plan.tile, plan.sub
    assert tile == THREADS * t_ and plan.tiles == -(-f_total // tile)
    taps = tc.taps_f32(spec)
    yr = np.zeros((n, f_total), np.float32)
    yi = np.zeros((n, f_total), np.float32)
    for g in range(plan.tiles):
        m0 = g * tile
        e0 = (m0 - p) * n
        e_end = min(m0 + tile, f_total) * n
        smem = np.zeros((n, t_, sub, 2), np.float32)
        count = np.zeros((n, t_, sub), np.int64)

        def put(i, values):
            f = i // n
            j = i - f * n
            assert (f < tile + p).all() and (f // t_ < sub).all()
            np.add.at(count, (j, f % t_, f // t_), 1)
            smem[j, f % t_, f // t_] = values.T

        if e0 < 0:
            i = np.arange(min(e_end, 0) - e0)
            if first:
                put(i, np.zeros((2, i.size), np.float32))
            else:
                put(i, dc_bits(hist[e0 + p * n + i]))
        lo = max(e0, 0)
        if vec_in:
            groups = np.arange(lo >> 3, (e_end + 7) >> 3)
            whole = groups[((groups << 3) >= lo) & ((groups << 3) + 8 <= e_end)]
            e = (whole[:, None] * 8 + np.arange(8)).ravel()
            part = groups[~np.isin(groups, whole)]
            pe = (part[:, None] * 8 + np.arange(8)).ravel()
            pe = pe[(pe >= lo) & (pe < e_end)]
            assert part.size <= 2  # only the head and the tail go element by element
            e = np.concatenate([e, pe])
        else:
            e = np.arange(lo, e_end)
        put(e - e0, dc_bits(wb[e]))
        # Every span element up to the end of the stream, once; nothing else.
        span_frames = min(m0 + tile, f_total) - (m0 - p)
        s = np.arange(tile + p)
        want = np.where(s < span_frames, 1, 0)
        for j in range(n):
            np.testing.assert_array_equal(count[j, s % t_, s // t_], want)

        tid = np.arange(THREADS)
        for u in range(t_):
            m = m0 + t_ * tid + u
            ok = m < f_total
            for b in range(n):
                j, d = (0, 0) if b == 0 else (n - b, 1)
                for q in range(p):
                    s = t_ * tid + u - q - d + p
                    assert (count[j, s % t_, s // t_][ok] == 1).all()
                    x = smem[j, s % t_, s // t_]
                    if q == 0:  # each chain starts with its first product
                        ar, ai = taps[q, b] * x[:, 0], taps[q, b] * x[:, 1]
                    else:
                        ar = ar + taps[q, b] * x[:, 0]
                        ai = ai + taps[q, b] * x[:, 1]
                yr[b, m[ok]] = ar[ok]
                yi[b, m[ok]] = ai[ok]
    ch = emulate_mix(n, yr, yi)
    return (requant_bits(ch[0]) | (requant_bits(ch[1]) << 8)).astype(np.uint16)


def _stream(n, p, frames, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, 2 * n * (frames + p), dtype=np.uint8).view(np.uint16)


@pytest.mark.parametrize("n", [1, 4, 12, 32])
@pytest.mark.parametrize("first", [True, False])
def test_kernel_emulation_equals_plain(n, first):
    """Two CTAs and a ragged third (its last thread holds fewer than T
    frames), head and carried history, against the plain version."""
    spec = tc.ChannelizerSpec(n_channels=n)
    p = spec.history_frames
    plan = channelizer_plan(n, p, 1)
    frames = 2 * plan.tile + plan.tile // 4 + 1
    s = _stream(n, p, frames, seed=60 + n)
    hist, wb = s[: p * n], s[p * n :]
    want = channelize_requantize_plain(
        spec, torch.from_numpy(hist.copy()), torch.from_numpy(wb.copy()), first).numpy()
    np.testing.assert_array_equal(emulate_kernel(spec, hist, wb, first, vec_in=True), want)


@pytest.mark.parametrize(
    "n,p,frames,vec_in",
    [
        (12, 8, 37, True),     # fewer frames than one tile
        (5, 3, 700, True),     # P N not a multiple of 8: misaligned group at the head
        (12, 5, 1100, True),   # the runtime tap loop, misaligned head
        (12, 12, 1029, False),  # chunk off 16-byte alignment: element by element
        (31, 8, 300, True),    # one frame a thread
        (16, 4, 3, True),      # fewer frames than taps
        (3, 700, 600, True),   # more taps than a tile: the second CTA reads history too
    ],
)
def test_kernel_plan_edges(n, p, frames, vec_in):
    spec = tc.ChannelizerSpec(n_channels=n, taps_per_branch=p)
    s = _stream(n, p, frames, seed=n * 100 + p)
    hist, wb = s[: p * n], s[p * n :]
    for first in (True, False):
        want = channelize_requantize_plain(
            spec, torch.from_numpy(hist.copy()), torch.from_numpy(wb.copy()), first).numpy()
        np.testing.assert_array_equal(emulate_kernel(spec, hist, wb, first, vec_in), want)


def test_plan_fits_the_card_where_the_old_kernel_did():
    """No new refusal: at the largest P whose span fitted the previous
    kernel's CTA (taps, both mix tables and 2 x 128 frames of float2 in 227
    KB of shared memory), this kernel's span fits too (both grow with P)."""
    cap = 227 * 1024
    for n in range(1, 33):
        old = lambda p: 4 * (p * n + 2 * n * n + 1) + 8 * n * (2 * 128 + p)  # noqa: E731
        p_max = max(p for p in range(1, 40000) if old(p) <= cap)
        for p in (1, 8, p_max - 1, p_max):
            assert channelizer_plan(n, p, 1).smem_bytes <= cap, (n, p)


def test_every_channel_count_is_built_once():
    """Each N from 1 to 32 and each tap class is a library of its own: one
    instantiation, named by its -D flags, with that N's mix as its header;
    no two share a build target, and K1 is untouched."""
    libs = [kernel_library(n, fixed) for n in range(1, tc.MAX_CHANNELS + 1)
            for fixed in (True, False)]
    for lib in libs:
        n = int(re.fullmatch(r"channelizer\.n(\d+)p(\d+)", lib.name).group(1))
        taps = FIXED_TAPS if lib.name.endswith(f"p{FIXED_TAPS}") else 0
        assert lib.source == "channelizer"
        assert lib.flags == (f"-DRTLAMR_K2_N={n}", f"-DRTLAMR_K2_P={taps}")
        assert lib.header == ("channelizer_mix.cuh", mix_header(n))
    assert len({build._target(lib) for lib in libs}) == len({lib.name for lib in libs}) == 64
    assert build._target(build.Library("decode_stencil")).name.startswith("decode_stencil-")


# ---------------------------------------------------------------------------
# A block of channel rows (the wideband mesh's channel shards)

MESH_BLOCKS = [(12, 0, 6), (12, 6, 6), (12, 3, 3), (4, 1, 1), (4, 2, 2)]


@pytest.mark.parametrize("n,c0,rows", MESH_BLOCKS)
def test_block_header_and_library(n, c0, rows):
    """A block's header, read back, is the block's mix program, named as
    its block; its library is its own build target beside the full one,
    with the block in its -D flags; the full block keeps the full
    library's name and flags."""
    text = mix_header(n, c0, rows)
    assert f"static constexpr int kStart = {c0}, kRows = {rows};" in text
    assert f"float (&cr)[{rows}][T], float (&ci)[{rows}][T]" in text
    cases = re.findall(r"      case (\d+): \{\n(.*?)\n      \} break;", text, re.S)
    prog = mix_program(n, c0, rows)
    assert [int(b) for b, _ in cases] == list(range(n)) == list(range(len(prog)))
    for (_, case), br in zip(cases, prog):
        assert read_header_case(case) == (br.products, br.ops)
        assert {c for _, c, _, _ in br.ops} <= set(range(rows))
    lib = kernel_library(n, True, c0, rows)
    assert lib.name == f"channelizer.n{n}c{c0}x{rows}p{FIXED_TAPS}"
    assert lib.flags == (f"-DRTLAMR_K2_N={n}", f"-DRTLAMR_K2_P={FIXED_TAPS}",
                         f"-DRTLAMR_K2_C0={c0}", f"-DRTLAMR_K2_ROWS={rows}")
    assert lib.header == ("channelizer_mix.cuh", text)
    full = kernel_library(n, True)
    assert kernel_library(n, True, 0, n) == full and full.name == f"channelizer.n{n}p{FIXED_TAPS}"
    assert build._target(lib) != build._target(full)
    # Fewer rows, fewer operations: the block's share of the full mix.
    muls, adds = mix_op_count(n, c0, rows)
    assert adds == sum(sign != "=" for br in prog for _, _, sign, _ in br.ops)
    assert muls <= mix_op_count(n)[0] and adds <= mix_op_count(n)[1]
    # chip_smoke.py's bound of a block: every branch and DC removal, the
    # block's mix and requantize, its rows written.
    work = chip_smoke.channelizer_work(tc.ChannelizerSpec(n_channels=n), 1000, 1.0, c0, rows)
    assert work["f32_instr"] == 1000 * (4 * n * 8 - 2 * n + 6 * n + 9 * rows + muls + adds)
    assert work["bytes"] == 2 * n * 1000 + 2 * n * 8 + 2 * rows * 1000


@pytest.mark.cuda
def test_cuda_block_kernel_equals_full_rows():
    """On the card: each block instantiation of the wideband mesh's channel
    shards (N = 12 in 2, 4 and 12 blocks, N = 4 in 2) is byte-equal to the
    same rows of the full launch and to its plain version, into a fresh
    tensor and into rows of a wider buffer, with the stream head's and a
    carried history."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channelizer kernel runs only there")
    cases = [(12, 6), (12, 3), (12, 1), (4, 2)]
    libs = []
    for n, rows in cases:
        libs += [kernel_library(n, True)] + [kernel_library(n, True, c0, rows)
                                              for c0 in range(0, n, rows)]
    build.build_many(list(dict.fromkeys(libs)))  # one nvcc each, together
    for n, rows in cases:
        spec = tc.ChannelizerSpec(n_channels=n)
        p, f = spec.history_frames, 3 * 8192 + 640 + 37
        wb = torch.from_numpy(_stream(n, p, f, seed=70 + n + rows).copy()).cuda()
        hist, chunk = wb[: p * n], wb[p * n :]
        for first in (True, False):
            full = channelize_requantize_fused(spec, hist, chunk, first)
            plain = channelize_requantize_plain(spec, hist, chunk, first)
            for c0 in range(0, n, rows):
                before = channelize_requantize_fused.launches
                got = channelize_requantize_fused(spec, hist, chunk, first, channel_start=c0,
                                                  channel_count=rows)
                wide = torch.zeros((rows, f + 300), dtype=torch.uint16, device="cuda")
                channelize_requantize_fused(spec, hist, chunk, first, out=wide[:, 5 : 5 + f],
                                            channel_start=c0, channel_count=rows)
                torch.cuda.synchronize()
                assert channelize_requantize_fused.launches == before + 2
                what = f"N={n} block [{c0}, {c0 + rows}) first={first}"
                rows_full = full[c0 : c0 + rows].view(torch.int16)
                assert torch.equal(got.view(torch.int16), rows_full), what
                assert torch.equal(got.view(torch.int16),
                                   plain[c0 : c0 + rows].view(torch.int16)), what
                assert torch.equal(wide[:, 5 : 5 + f].view(torch.int16), rows_full), what
                assert not wide[:, :5].view(torch.int16).any(), what
                assert not wide[:, 5 + f :].view(torch.int16).any(), what
