"""The reformulations of the hand-written search (``csrc/search.cu``),
restated in numpy and held to the plain search (``ops/search.py``) on the
CPU:

- the plateau test read directly, at a candidate's strided positions, in
  place of ``_edge_span_streams``'s doubling passes;
- compaction by per-tile counts and a scatter at each rank, in place of the
  sort of ``_compact_true_positions``;
- the whole search as the kernels compute it (tile counts, then ranks from
  the earlier tiles' counts, then the finish: fill rows, gates, duplicate
  collapse, counts and guards), byte for byte against
  ``pack_results(search_slice(...))`` on the windows of
  ``test_torch_search_graph.py``'s ``CPU_CASES`` and on masks that overflow
  each capacity in turn."""

import dataclasses

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.ops.frontend import pack_results
from rtlamr_tpu_torch.ops.search import (
    _compact_true_positions,
    _edge_span_streams,
    _r900_rs_tables,
    lookahead_guards,
    search_slice,
)
from rtlamr_tpu_torch.ops.spec import lookahead_geometry, lookahead_spec
from rtlamr_tpu_torch.ops.stencil import lookahead_mask, stencil_plain
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.r900 import PAYLOAD_SYMBOLS

from test_torch_search_graph import CPU_CASES, planted_capture, staged_windows

torch.set_num_threads(1)

#: positions a CTA of the kernels' first two passes takes (256 threads x 32)
TILE = 8192


def edge_in(stream: np.ndarray, p: int, stride: int, span: int) -> bool:
    """The kernel's direct plateau test: some read at p + m * stride, m <
    span, lies at the stream's last position or past it, or differs from
    the sample after it."""
    n = stream.size
    for m in range(span):
        x = p + m * stride
        if x >= n - 1 or stream[x] != stream[x + 1]:
            return True
    return False


def compact_by_counts(mask: np.ndarray, size: int, fill: int, tile: int) -> np.ndarray:
    """Ascending True positions at ranks below ``size``, ``fill`` past them:
    each tile's rank offset is the sum of the earlier tiles' counts, and a
    tile scatters its own positions at their ranks."""
    counts = [int(mask[t : t + tile].sum()) for t in range(0, mask.size, tile)]
    out = np.full(size, fill, np.int64)
    for i, t in enumerate(range(0, mask.size, tile)):
        base = sum(counts[:i])
        for r, q in enumerate(np.flatnonzero(mask[t : t + tile])):
            if base + r < size:
                out[base + r] = t + q
    return out


def crc_table(poly: int) -> list:
    """T[x]: the register (x << 8) after 8 MSB-first steps of ``poly``."""
    out = []
    for x in range(256):
        r = x << 8
        for _ in range(8):
            r = ((r << 1) ^ poly if r & 0x8000 else r << 1) & 0xFFFF
        out.append(r)
    return out


def crc16(data, init: int, poly: int) -> int:
    """MSB-first CRC-16 a byte a table step, as a lane of the kernel
    computes it."""
    t = crc_table(poly)
    crc = init
    for b in data:
        crc = ((crc << 8) ^ t[((crc >> 8) ^ int(b)) & 0xFF]) & 0xFFFF
    return crc


def pvalid(group, spec, packed: np.ndarray, syms) -> int:
    """The per-parser validity bits of one row (0 when ungated)."""
    if not (spec.device_validate and group.validators is not None):
        return 0
    rs = _r900_rs_tables()
    pv = 0
    for j, v in enumerate(group.validators):
        ok = all(crc16(np.concatenate([packed[a:b] for a, b in c.ranges]), c.init, c.poly)
                 == c.residue for c in v.crcs)
        if v.rs:
            sym = [int(syms[2 * i]) * 6 + int(syms[2 * i + 1]) for i in range(21)]
            syn = 0
            for i, s in enumerate(sym):
                syn ^= int(rs[i, s & 31])
            ok = ok and max(sym) <= 31 and syn == 0
        pv |= int(ok) << j
    return pv


def slice_row(spec, group, bits: np.ndarray, q6, q: int):
    """(packed bytes, R900 digits or None) of the packet at q; zeros past
    each stream's end."""
    sl, s_g = spec.symbol_length, group.packet_symbols
    nbytes = (s_g + 7) >> 3
    x = q + sl * np.arange(8 * nbytes)
    v = np.where(x < bits.size, bits[np.minimum(x, bits.size - 1)], 0).astype(np.uint32)
    packed = np.zeros(nbytes, np.uint32)
    for k in range(8):
        packed |= (v[k::8] << (7 - k)) & 0xFF
    if s_g != 8 * nbytes:
        packed[-1] &= (0xFF << (8 * nbytes - s_g)) & 0xFF
    syms = None
    if group.wants_r900:
        x = q + spec.preamble_length - sl + 4 * spec.chip_length * np.arange(PAYLOAD_SYMBOLS)
        syms = np.where(x < q6.size, q6[np.minimum(x, q6.size - 1)], 0).astype(np.uint8)
    return packed.astype(np.uint8), syms


def kernel_model(spec, bits, q6, mask2d, fits=None) -> np.ndarray:
    """The packed buffer (then the (G,) int32 guards when ``fits`` is
    given) as the three kernels compute it."""
    bits = bits.numpy()
    q6 = None if q6 is None else q6.numpy()
    mask = mask2d.numpy().reshape(-1)
    w, n_groups = mask.size, len(spec.groups)
    sl, bs = spec.symbol_length, spec.block_size
    base_r900 = spec.preamble_length - sl
    k_gather, cap = spec.gather_hits, spec.gather_rows
    k_any = min(n_groups * k_gather, cap * 128)
    k_slice = min(spec.slice_hits, k_gather)
    pos = np.arange(w)
    hit = mask != 0
    grp = [((mask >> g) & 1).astype(bool) for g in range(n_groups)]
    prev = np.concatenate([[0], mask[:-1]])

    # Pass 1: a position's plateau candidates (bit g here and at q - 1, not
    # a block's first), their direct test, and each tile's counts.
    keep = []
    for g, group in enumerate(spec.groups):
        cand = grp[g] & (((prev >> g) & 1) != 0) & (pos % bs != 0)
        drop = np.zeros(w, bool)
        for q in np.flatnonzero(cand):
            if group.wants_r900:
                drop[q] = not edge_in(q6, q - 1 + base_r900, 4 * spec.chip_length,
                                      PAYLOAD_SYMBOLS)
            else:
                drop[q] = not edge_in(bits, q - 1, sl, group.packet_symbols)
        keep.append(grp[g] & ~drop)
    row_hit = np.repeat(hit.reshape(-1, 128).any(1), 128)
    row_start = row_hit & (pos % 128 == 0)
    tiles = range(0, w, TILE)

    def tile_sum(x):
        return np.array([int(x[t : t + TILE].sum()) for t in tiles])

    def ranks(x):  # base from the earlier tiles' counts, then the tile's own
        base = np.concatenate([[0], np.cumsum(tile_sum(x))[:-1]])
        return np.repeat(base, TILE)[:w] + np.concatenate(
            [np.cumsum(x[t : t + TILE]) - x[t : t + TILE] for t in tiles])

    # a row's rank: the row starts before its first position
    row_rank = ranks(row_start) - (row_hit & ~row_start)
    incl = hit & (row_rank < cap) & (ranks(hit) < k_any)

    # Pass 2: the group lists, the slice rows and what each tile includes.
    rows = {}
    incl_keep = []
    for g in range(n_groups):
        listed = incl & grp[g] & (ranks(grp[g]) < k_gather)
        kept = keep[g] & listed
        incl_keep.append(int(kept.sum()))
        krank = ranks(keep[g])
        rows[g] = [(int(krank[q]), int(q)) for q in np.flatnonzero(kept) if krank[q] < k_slice]

    # Pass 3: fill rows, keep, counts (and guards).
    over = (int(row_start.sum()) > cap) or (int(hit.sum()) > k_any)
    parts = {"counts": [], "idx": [], "keep": [], "pvalid": [], "bytes": [], "symbols": []}
    for g, group in enumerate(spec.groups):
        s = min(k_slice, incl_keep[g])
        assert sorted(r for r, _ in rows[g]) == list(range(s))
        qs = dict(rows[g])
        idx = np.array([qs.get(j, w) for j in range(k_slice)], np.int32)
        sliced = [slice_row(spec, group, bits, q6, qs.get(j, 0)) for j in range(k_slice)]
        pv = np.array([pvalid(group, spec, b, y) for b, y in sliced], np.uint8)
        gated = spec.device_validate and group.validators is not None
        kp = np.zeros(k_slice, np.uint8)
        for j in range(s):
            ok = not gated or pv[j] != 0
            if ok and j > 0 and idx[j] // bs == idx[j - 1] // bs:
                key = 1 if group.wants_r900 else 0
                ok = not np.array_equal(sliced[j][key], sliced[j - 1][key])
            kp[j] = ok
        raw = k_gather + 1 if over or incl_keep[g] > k_slice else int(grp[g].sum())
        parts["counts"].append(np.array([raw, int(kp.sum())], np.int32))
        parts["idx"].append(idx)
        parts["keep"].append(kp)
        parts["pvalid"].append(pv)
        parts["bytes"].append(np.stack([b for b, _ in sliced]))
        if group.wants_r900:
            parts["symbols"].append(np.stack([y for _, y in sliced]))
    out = [np.stack(parts["counts"]).view(np.uint8).reshape(-1)]
    for name in ("idx", "keep", "pvalid", "bytes", "symbols"):
        out += [np.ascontiguousarray(x).view(np.uint8).reshape(-1) for x in parts[name]]
    if fits is not None:
        guards = [min([int(q) for q in np.flatnonzero(grp[g]) if q >= fit] + [w])
                  for g, fit in enumerate(fits)]
        out.append(np.array(guards, np.int32).view(np.uint8))
    return np.concatenate(out)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride, spans", [(16, (1, 5, 42, 96)), (144, (96, 128, 736)),
                                           (288, (42,))])
def test_direct_plateau_test_equals_edge_spans(stride, spans):
    """At every position, reads past the stream's end included, the direct
    test says "no edge" exactly where ``_edge_span_streams`` does."""
    rng = np.random.default_rng(stride)
    n = stride * (max(spans) + 40) + 37
    # a few edges, so that many positions read none of them
    stream = np.zeros(n, np.uint8)
    for e in rng.choice(n, 4, replace=False):
        stream[e:] ^= 1
    eq = _edge_span_streams(torch.from_numpy(stream), stride, list(spans))
    # a sample of the positions and the last 2 x stride, whose reads pass
    # the end
    at = np.concatenate([rng.choice(n, 400, replace=False), np.arange(n - 2 * stride, n)])
    for s in spans:
        want = eq[s].numpy()[at]
        got = np.array([not edge_in(stream, p, stride, s) for p in at])
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()


@pytest.mark.parametrize("size", [0, 1, 57, 58, 59, 300])
@pytest.mark.parametrize("tile", [7, 64, 4096])
def test_count_and_scatter_equals_sort_compaction(size, tile):
    """Below, at and over the 58 True positions, with its fill."""
    rng = np.random.default_rng(size + tile)
    mask = np.zeros(1000, bool)
    mask[rng.choice(1000, 58, replace=False)] = True
    want = _compact_true_positions(torch.from_numpy(mask), size, 777).numpy()
    np.testing.assert_array_equal(compact_by_counts(mask, size, 777, tile), want)


def window_inputs(names, chip_length, window_blocks, k=2):
    dec = WindowDecoder([new_parser(n, chip_length) for n in names],
                        window_blocks=window_blocks, device="cpu")
    iq = planted_capture(names, chip_length, dec.spec.window, 6)
    return dec.spec, staged_windows(dec.spec, iq, k)


@pytest.mark.parametrize("names, chip_length, window_blocks", CPU_CASES)
def test_model_equals_search_slice(names, chip_length, window_blocks):
    """The kernels' search over each window's K1 outputs, and over its
    look-ahead with the guards, equals the plain search's packed bytes."""
    spec, staged = window_inputs(names, chip_length, window_blocks)
    la = lookahead_geometry(spec)
    for i, row in enumerate(staged):
        bits, q6, mask2d = stencil_plain(spec, torch.from_numpy(row), i == 0)
        want = pack_results(search_slice(spec, bits, q6, mask2d)).numpy()
        np.testing.assert_array_equal(kernel_model(spec, bits, q6, mask2d), want)
        if la.extent:
            w = spec.window
            ahead = lookahead_mask(spec, bits)
            q6a = None if q6 is None else q6[w:]
            want = np.concatenate([
                pack_results(search_slice(lookahead_spec(spec), bits[w:], q6a, ahead)).numpy(),
                lookahead_guards(spec, ahead).numpy().view(np.uint8)])
            got = kernel_model(lookahead_spec(spec), bits[w:], q6a, ahead, la.fits)
            np.testing.assert_array_equal(got, want)


#: capacities cut one at a time below what the planted windows hold (35
#: hit positions in 5 rows a window, 14 of them SCM+'s, 7 of each other
#: group's): the rows, then the any-hit list (4 x 4 < 35), a group's list
#: (14 > 12), the slice rows (SCM+'s two distinct contents > 1)
OVERFLOWS = [dict(gather_rows=2), dict(gather_hits=4), dict(gather_hits=12), dict(slice_hits=1)]


@pytest.mark.parametrize("cut", OVERFLOWS)
def test_model_equals_search_slice_over_capacity(cut):
    """Windows that overflow the row, any-hit, group and slice capacities
    in turn: the same bytes, ``counts`` reporting the overflow."""
    spec, staged = window_inputs(("scm", "scm+", "idm", "r900"), 8, 96, k=3)
    small = dataclasses.replace(spec, **cut)
    for i, row in enumerate(staged):
        bits, q6, mask2d = stencil_plain(small, torch.from_numpy(row), i == 0)
        res = search_slice(small, bits, q6, mask2d)
        np.testing.assert_array_equal(kernel_model(small, bits, q6, mask2d),
                                      pack_results(res).numpy())
        assert (res["counts"][:, 0] > small.gather_hits).any()


@pytest.mark.parametrize("cut", [{}] + OVERFLOWS)
def test_model_equals_search_slice_on_a_dense_mask(cut):
    """A random mask with every group's bit at about half the positions,
    over a window's K1 streams: every group overflows, at the spec's own
    capacities too (11,520 hit positions against an any-hit list of
    8,192)."""
    spec, staged = window_inputs(("scm", "scm+", "idm", "r900"), 8, 24, k=1)
    small = dataclasses.replace(spec, **cut)
    bits, q6, mask2d = stencil_plain(small, torch.from_numpy(staged[0]), False)
    dense = torch.from_numpy(
        np.random.default_rng(5).integers(0, 16, mask2d.shape).astype(np.uint8))
    res = search_slice(small, bits, q6, dense)
    np.testing.assert_array_equal(kernel_model(small, bits, q6, dense), pack_results(res).numpy())
    assert (res["counts"][:, 0] > small.gather_hits).all()
