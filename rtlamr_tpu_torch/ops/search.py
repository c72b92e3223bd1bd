"""Hit compaction, plateau collapse, packet slicing and checksum gates.

:func:`search_slice` is the port of the JAX package's
``ops/frontend.search_slice`` and its helpers in plain PyTorch ops: the CPU
path, and the version the card's kernels are held to. On the card the
window program runs :func:`search_kernel` instead: the hand-written CUDA
kernels of ``csrc/search.cu``, which write the same packed buffer in three
launches.

The plain version: everything is enqueued on the device without a host
sync: no ``nonzero``, no boolean-mask indexing, no ``.item()``. Compaction
is the fixed-capacity sort of :func:`_compact_true_positions`, and every
gather index is in range by construction (checked statically in
:func:`search_slice`), since a torch index out of range raises on the CPU
and is a device-side assert on CUDA.

The CRC-16 and Reed-Solomon gates use that both are GF(2)-linear in their
input bytes/symbols: a per-position table (built once on the host) maps
each byte value to its contribution to the final register, and the
register is the XOR of the row's contributions. That is the same function
as the reference's byte-serial fold (crc/crc.go:49-55,
r900/r900.go:215-221) in a fixed handful of launches instead of one set of
launches per byte.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..protocols.r900 import PAYLOAD_SYMBOLS
from .spec import (
    LANES,
    FrontendSpec,
    GroupSpec,
    lookahead_geometry,
    packed_size,
    result_layout,
    staged_geometry,
)


def _strided_matrix(stream: torch.Tensor, stride: int, max_length: int) -> torch.Tensor:
    """(stride, n_rows) matrix with mat[r, c] = stream[c*stride + r]
    (zero past the end), contiguous, shared by every group's gather."""
    n_rows = -(-int(stream.shape[0]) // stride) + max_length + 1
    padded = torch.zeros(n_rows * stride, dtype=stream.dtype, device=stream.device)
    padded[: stream.shape[0]] = stream
    return padded.reshape(n_rows, stride).T.contiguous()


def _strided_rows_from(
    mat: torch.Tensor, starts: torch.Tensor, stride: int, length: int
) -> torch.Tensor:
    """rows[i, j] = stream[starts[i] + j*stride] over a prebuilt
    :func:`_strided_matrix`, as one flat gather of k*length scalars."""
    r = starts % stride
    c = starts // stride
    ncols = mat.shape[1]
    j = torch.arange(length, device=starts.device)
    return torch.take(mat, r[:, None] * ncols + c[:, None] + j[None, :])


def _packed_strided_matrix(
    stream: torch.Tensor, stride: int, max_bytes: int, mat=None
) -> torch.Tensor:
    """P8[r, c] = MSB-first byte of stream[(c+k)*stride + r], k < 8. Packet
    byte b of a hit at (r, c0) is P8[r, c0 + 8b]."""
    if mat is None:
        mat = _strided_matrix(stream, stride, 8 * max_bytes + 8)
    c = mat.shape[1]
    c8 = -(-c // 8) * 8
    pad = torch.zeros((mat.shape[0], c8 + 8), dtype=mat.dtype, device=mat.device)
    pad[:, :c] = mat
    p8 = torch.zeros((mat.shape[0], c8), dtype=torch.uint8, device=mat.device)
    for j in range(8):
        p8 |= pad[:, j : j + c8] << (7 - j)
    return p8


def _packed_rows_from(
    p8: torch.Tensor, starts: torch.Tensor, stride: int, nbytes: int
) -> torch.Tensor:
    """bytes[i, b] = MSB-first packed stream[starts[i] + (8b+k)*stride]."""
    r = starts % stride
    c = starts // stride
    ncols = p8.shape[1]
    b = 8 * torch.arange(nbytes, device=starts.device)
    return torch.take(p8, r[:, None] * ncols + c[:, None] + b[None, :])


# ---------------------------------------------------------------------------
# Checksum gates


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of an integer tensor, by halving folds."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        folded = x[..., :half] ^ x[..., half : 2 * half]
        if x.shape[-1] % 2:
            folded = torch.cat([folded, x[..., 2 * half :]], dim=-1)
        x = folded
    return x[..., 0]


@functools.lru_cache(maxsize=None)
def _crc16_tables(length: int, init: int, poly: int):
    """(T, c0): the CRC-16 register after ``length`` bytes from ``init`` is
    c0 ^ XOR_j T[j, byte_j] (the MSB-first step is linear over GF(2))."""

    def zero_step(crc: np.ndarray) -> np.ndarray:  # one byte of value 0
        for _ in range(8):
            crc = ((crc << 1) & 0xFFFF) ^ np.where(crc & 0x8000, poly, 0)
        return crc

    t = np.zeros((length, 256), np.int64)
    t[length - 1] = zero_step(np.arange(256, dtype=np.int64) << 8)
    for j in range(length - 2, -1, -1):
        t[j] = zero_step(t[j + 1])
    c0 = np.array([init], np.int64)
    for _ in range(length):
        c0 = zero_step(c0)
    return t.astype(np.int32), int(c0[0])


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: str, *key) -> torch.Tensor:
    table = _crc16_tables(*key)[0] if name == "crc" else _r900_rs_tables()
    return torch.from_numpy(table).to(device)


def _crc16_batch(data: torch.Tensor, init: int, poly: int) -> torch.Tensor:
    """CRC-16 over each row of an (N, L) uint8 matrix -> (N,) int32."""
    n, length = data.shape
    if length == 0:
        return torch.full((n,), init, dtype=torch.int32, device=data.device)
    c0 = _crc16_tables(length, init, poly)[1]
    table = _device_table("crc", str(data.device), length, init, poly)
    pos = torch.arange(length, device=data.device)
    contrib = table[pos[None, :], data.long()]  # (N, L)
    return _xor_reduce(contrib) ^ c0


@functools.lru_cache(maxsize=None)
def _r900_rs_basis() -> np.ndarray:
    """B[i, j] = alpha^(29+i) * 2^j in GF(32): the linear-map images of the
    syndrome fold's constant multipliers (r900/r900.go:215-221)."""
    from ..utils.gf import r900_field

    f = r900_field()
    b = np.zeros((5, 5), np.int32)
    for i in range(5):
        m = f.exp_((29 + i) % f.order)
        for j in range(5):
            b[i, j] = f.mul(m, 1 << j)
    return b


#: codeword positions holding payload symbols: data [0:16], parity [26:31]
#: (the 10 positions between are zero and contribute nothing)
_RS_POSITIONS = tuple(range(16)) + tuple(range(26, 31))


@functools.lru_cache(maxsize=None)
def _r900_rs_tables() -> np.ndarray:
    """(21, 32) int32: the five 5-bit syndromes (packed at bits 5i) that
    symbol value v at codeword position _RS_POSITIONS[j] contributes. The
    Horner fold syn <- alpha^(29+i) syn ^ v is linear, so the final
    syndromes are the XOR of these contributions."""
    basis = _r900_rs_basis()

    def mul(syn: np.ndarray) -> np.ndarray:  # (32, 5) lanes
        out = np.zeros_like(syn)
        for j in range(5):
            out ^= ((syn >> j) & 1) * basis[None, :, j]
        return out

    v = np.arange(32, dtype=np.int32)
    table = np.zeros((len(_RS_POSITIONS), 32), np.int32)
    for row, p in enumerate(_RS_POSITIONS):
        syn = np.repeat(v[:, None], 5, axis=1)
        for _ in range(30 - p):
            syn = mul(syn)
        table[row] = sum(syn[:, i] << (5 * i) for i in range(5))
    return table


def _r900_rs_valid(syms: torch.Tensor) -> torch.Tensor:
    """(N, 42) 6-ary payload digits -> (N,) bool: base-6 pairs in range and
    all five GF(32) RS syndromes zero (r900/r900.go:199-221)."""
    n = syms.shape[0]
    d = syms.to(torch.int64).reshape(n, 21, 2)
    sym = d[:, :, 0] * 6 + d[:, :, 1]  # (N, 21) 5-bit symbols
    in_range = (sym <= 31).all(dim=1)
    table = _device_table("rs", str(syms.device))
    pos = torch.arange(21, device=syms.device)
    syn = _xor_reduce(table[pos[None, :], sym & 31])
    return in_range & (syn == 0)


def _device_parser_masks(
    group: GroupSpec, packed: torch.Tensor, syms
) -> List[torch.Tensor]:
    """Per-parser validity masks: an AND of CRC gates plus the optional RS
    gate (mirrors Parser.valid_mask batched on the host)."""
    n = packed.shape[0]
    out = []
    for v in group.validators:
        ok = torch.ones(n, dtype=torch.bool, device=packed.device)
        for c in v.crcs:
            data = torch.cat([packed[:, a:b] for a, b in c.ranges], dim=1)
            ok = ok & (_crc16_batch(data, c.init, c.poly) == c.residue)
        if v.rs:
            ok = ok & _r900_rs_valid(syms)
        out.append(ok)
    return out


# ---------------------------------------------------------------------------
# Compaction and the plateau collapse


def _compact_true_positions(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Ascending positions of True entries, padded with ``fill`` to ``size``
    (a fixed-capacity sort, so no host sync)."""
    n = mask.shape[0]
    pos = torch.where(mask, torch.arange(n, device=mask.device), n)
    pos = torch.sort(pos).values
    if size <= n:
        pos = pos[:size]
    else:
        pos = torch.cat([pos, torch.full((size - n,), n, device=mask.device)])
    return torch.where(pos < n, pos, fill)


def _shift_or_true(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[q + k] with True padding past the end."""
    n = x.shape[0]
    if k >= n:
        return torch.ones(n, dtype=torch.bool, device=x.device)
    return torch.cat([x[k:], torch.ones(k, dtype=torch.bool, device=x.device)])


def _edge_span_streams(
    stream: torch.Tensor, stride: int, spans: Sequence[int]
) -> Dict[int, torch.Tensor]:
    """``eq_S[q]`` True iff no sample-adjacent edge (stream[p] !=
    stream[p+1]) lies at any of the S strided read positions {q + m*stride}
    -- i.e. the content sliced from q is PROVEN equal to that from q+1.
    Built by doubling OR passes: o_2k[q] = o_k[q] | o_k[q + k*stride]."""
    edge = torch.cat(
        [stream[1:] != stream[:-1], torch.ones(1, dtype=torch.bool, device=stream.device)]
    )
    partials = {1: edge}
    k = 1
    while 2 * k <= max(spans):
        partials[2 * k] = partials[k] | _shift_or_true(partials[k], k * stride)
        k *= 2
    out: Dict[int, torch.Tensor] = {}
    for s in spans:
        acc = None
        off = 0
        rem = s
        for bit in reversed(range(s.bit_length())):
            p2 = 1 << bit
            if rem >= p2:
                part = _shift_or_true(partials[p2], off * stride)
                acc = part if acc is None else acc | part
                off += p2
                rem -= p2
        out[s] = ~acc
    return out


def search_slice(spec: FrontendSpec, bits: torch.Tensor, q6, mask2d: torch.Tensor):
    """Hit compaction and packet slicing over the quantized streams.

    Returns the JAX package's result dict: ``counts`` (G, 2) [raw hits,
    surviving candidates]; per group ``idx`` (k,) ascending positions with
    ``n`` as fill, ``keep`` (k,) u8 survivor mask, ``pvalid`` (k,) u8
    per-parser validity bits, ``bytes`` (k, nbytes) MSB-first packed packet
    symbols, and ``symbols[g]`` (k, 42) R900 payload digits, at the slice
    capacity k = min(slice_hits, gather_hits).

    ``mask2d`` is the (n / 128, 128) preamble mask of the streams' first n
    positions: the window's, or the look-ahead's over streams that begin
    at the window's end (:func:`lookahead_guards`). A packet read past the
    streams' end reads zeros.
    """
    dev = bits.device
    cl = spec.chip_length
    sl = spec.symbol_length
    bs = spec.block_size
    rm = mask2d.shape[0]
    w = rm * 128
    k_gather = spec.gather_hits
    n_rows_cap = spec.gather_rows
    geo = staged_geometry(spec)
    # Every take below stays in range; these are the deepest reads.
    assert w <= bits.shape[0] <= geo.lp
    if spec.wants_r900:
        assert w - 1 + spec.preamble_length - sl < q6.shape[0] == bits.shape[0] - sl

    # Level 1: rows of the (w/128, 128) mask containing any hit.
    row_any = (mask2d != 0).any(dim=1)
    rows_overflow = row_any.sum() > n_rows_cap
    rows_idx = _compact_true_positions(row_any, n_rows_cap, rm)
    row_valid = rows_idx < rm
    safe_rows = torch.where(row_valid, rows_idx, 0)
    sub = mask2d.index_select(0, safe_rows) * row_valid[:, None]
    flat_sub = sub.reshape(-1)
    flat_pos = (safe_rows[:, None] * 128 + torch.arange(128, device=dev)[None, :]).reshape(-1)

    # Shared strided views, built once and pre-packed to bytes.
    max_bytes = max((g.packet_symbols + 7) >> 3 for g in spec.groups)
    bit_mat = _strided_matrix(bits, sl, 8 * max_bytes + 8)
    pack_mat = _packed_strided_matrix(bits, sl, max_bytes, mat=bit_mat)
    q6_mat = _strided_matrix(q6, 4 * cl, PAYLOAD_SYMBOLS) if spec.wants_r900 else None

    # Level 2: one exact compaction over the gathered rows finds positions
    # with any group's hit.
    n_flat = flat_pos.shape[0]
    k_any = min(len(spec.groups) * k_gather, n_rows_cap * 128)
    any_hits = _compact_true_positions(flat_sub != 0, k_any, n_flat)
    any_valid = any_hits < n_flat
    safe_any = torch.where(any_valid, any_hits, 0)
    any_idx = torch.where(any_valid, flat_pos[safe_any], w)
    any_mask = flat_sub[safe_any] * any_valid
    total_any = (mask2d != 0).sum()
    any_overflow = rows_overflow | (total_any > k_any)

    # Content-equality streams for the exact pre-slice plateau collapse.
    k_slice = min(spec.slice_hits, k_gather)
    bit_spans = sorted({g.packet_symbols for g in spec.groups if not g.wants_r900})
    eq_bits = _edge_span_streams(bits, sl, bit_spans) if bit_spans else {}
    eq_q6 = _edge_span_streams(q6, 4 * cl, [PAYLOAD_SYMBOLS]) if spec.wants_r900 else {}

    # Reported as the raw count of a group whose window overflowed a
    # capacity, so the caller escalates.
    overflow_count = k_gather + 1
    counts, idxs, keeps, pvalids, byte_mats = [], [], [], [], []
    symbol_mats: Dict[int, torch.Tensor] = {}
    for g, group in enumerate(spec.groups):
        raw_count = ((mask2d >> g) & 1).sum()
        raw_count = torch.where(any_overflow, overflow_count, raw_count)
        gsel = (any_mask >> g) & 1
        ghits = _compact_true_positions(gsel != 0, k_gather, k_any)
        gvalid = ghits < k_any
        safe_g = torch.where(gvalid, ghits, 0)
        hit_idx = torch.where(gvalid, any_idx[safe_g], w)
        valid = gvalid & (hit_idx < w)

        s_g = group.packet_symbols
        nbytes = (s_g + 7) >> 3

        # Pre-slice plateau collapse: drop a hit at q when the previous hit
        # sits at q-1 in the same block AND the edge streams PROVE their
        # sliced contents identical (scm/scm.go:62-74 would drop it anyway).
        prev_q = (hit_idx - 1).clamp(min=0)
        if group.wants_r900:
            eq = eq_q6[PAYLOAD_SYMBOLS][prev_q + (spec.preamble_length - sl)]
        else:
            eq = eq_bits[s_g][prev_q]
        no = torch.zeros(1, dtype=torch.bool, device=dev)
        adj = torch.cat([no, hit_idx[1:] == hit_idx[:-1] + 1])
        sameblk = torch.cat([no, hit_idx[1:] // bs == hit_idx[:-1] // bs])
        pre_keep = valid & ~(adj & sameblk & eq)
        raw_count = torch.where(pre_keep.sum() > k_slice, overflow_count, raw_count)
        s_pos = _compact_true_positions(pre_keep, k_slice, k_gather)
        s_valid = s_pos < k_gather
        safe_s = torch.where(s_valid, s_pos, 0)
        slice_idx = torch.where(s_valid, hit_idx[safe_s], w)
        valid = s_valid & (slice_idx < w)
        safe_idx = torch.where(valid, slice_idx, 0)

        # Bit slice at stride SL (decode.go:353-375) as pre-packed bytes;
        # mask the stray low bits of a partial final byte.
        s_pad = nbytes * 8
        packed = _packed_rows_from(pack_mat, safe_idx, sl, nbytes)
        if s_g != s_pad:
            packed[:, -1] &= (0xFF << (s_pad - s_g)) & 0xFF

        syms = None
        if group.wants_r900:
            # 42 payload symbols at stride 4*CL from hit + PreambleLength -
            # SymbolLength (r900/r900.go:187-193).
            base = spec.preamble_length - sl
            syms = _strided_rows_from(q6_mat, safe_idx + base, 4 * cl, PAYLOAD_SYMBOLS)

        # Checksum gate: per-parser verdicts ship as a bitmask so the host
        # parse never recomputes a CRC.
        pv = torch.zeros(packed.shape[0], dtype=torch.uint8, device=dev)
        if spec.device_validate and group.validators is not None:
            pmasks = _device_parser_masks(group, packed, syms)
            any_ok = pmasks[0]
            for m in pmasks[1:]:
                any_ok = any_ok | m
            valid = valid & any_ok
            for j, m in enumerate(pmasks):
                pv |= m.to(torch.uint8) << j

        # Collapse same-block duplicates by gathered content; the host
        # selects the survivors through ``keep``.
        key = syms if group.wants_r900 else packed
        block_of = safe_idx // bs
        same_prev = (key[1:] == key[:-1]).all(dim=-1) & (block_of[1:] == block_of[:-1])
        keep = valid & ~torch.cat([no, same_prev])

        counts.append(torch.stack([raw_count, keep.sum()]))
        idxs.append(slice_idx)
        keeps.append(keep.to(torch.uint8))
        pvalids.append(pv)
        byte_mats.append(packed)
        if group.wants_r900:
            symbol_mats[g] = syms

    return {
        "counts": torch.stack(counts).to(torch.int32),
        "idx": [x.to(torch.int32) for x in idxs],
        "keep": keeps,
        "pvalid": pvalids,
        "bytes": byte_mats,
        "symbols": symbol_mats,
    }


def lookahead_guards(spec: FrontendSpec, ahead2d: torch.Tensor) -> torch.Tensor:
    """(G,) int32: each group's first raw preamble hit at or past its fit
    in the look-ahead's (extent / 128, 128) mask, before any gate, relative
    to the window's end (the extent when there is none); what
    :func:`~.spec.resolved_blocks` reads."""
    la = lookahead_geometry(spec)
    flat = ahead2d.reshape(-1)
    pos = torch.arange(la.extent, device=flat.device)
    return torch.stack([
        torch.where((((flat >> g) & 1) != 0) & (pos >= fit), pos, la.extent).amin()
        for g, fit in enumerate(la.fits)
    ]).to(torch.int32)


# ---------------------------------------------------------------------------
# The hand-written kernels (csrc/search.cu)

#: Threads of a CTA and positions of a tile of the kernels' first two passes;
#: equal to THREADS and TILE in ``csrc/search.cu``.
THREADS = 256
TILE = 32 * THREADS
#: ints of scratch a tile: its counts (N_FIELDS in the .cu)
TILE_FIELDS = 34
_MAX_GROUPS, _MAX_VALIDATORS, _MAX_CRCS, _MAX_RANGES, _MAX_BYTES = 8, 16, 16, 4, 128


class _Group(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "symbols", "nbytes", "r900", "gated", "v0", "n_validators", "fit",
        "idx_off", "keep_off", "pvalid_off", "bytes_off", "syms_off",
    )]


class _Validator(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("rs", "crc0", "n_crcs")]


class _Crc(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("init", "poly", "residue", "n_ranges")] + [
        ("lo", ctypes.c_int * _MAX_RANGES), ("hi", ctypes.c_int * _MAX_RANGES)]


class _SearchArgs(ctypes.Structure):
    """The kernels' arguments (``SearchArgs`` in the .cu)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "w", "n_tiles", "n_bits", "n_q6", "sl", "cl4", "base", "bs", "n_groups",
        "gather_rows", "k_any", "k_gather", "k_slice", "max_span", "guards_off", "n_crcs",
    )] + [("g", _Group * _MAX_GROUPS), ("v", _Validator * _MAX_VALIDATORS),
          ("c", _Crc * _MAX_CRCS)]


@functools.lru_cache(maxsize=None)
def _search_args(spec: FrontendSpec, w: int, n_bits: int, n_q6: int,
                 fits: Optional[tuple]) -> _SearchArgs:
    """The arguments of a search of ``w`` positions over streams of
    ``n_bits`` and ``n_q6`` samples; ``fits``: the look-ahead's, whose
    guards then follow the packed buffer."""
    if len(spec.groups) > _MAX_GROUPS:
        raise ValueError(f"search_kernel: at most {_MAX_GROUPS} preamble groups")
    offsets = {name: off for name, off, _ in result_layout(spec)}
    a = _SearchArgs()
    a.w, a.n_tiles, a.n_bits, a.n_q6 = w, -(-w // TILE), n_bits, n_q6
    a.sl, a.cl4 = spec.symbol_length, 4 * spec.chip_length
    a.base, a.bs = spec.preamble_length - spec.symbol_length, spec.block_size
    a.n_groups, a.gather_rows, a.k_gather = len(spec.groups), spec.gather_rows, spec.gather_hits
    a.k_any = min(len(spec.groups) * spec.gather_hits, spec.gather_rows * LANES)
    a.k_slice = min(spec.slice_hits, spec.gather_hits)
    a.guards_off = -1 if fits is None else packed_size(spec)
    n_v = n_c = 0
    for g, group in enumerate(spec.groups):
        nbytes = (group.packet_symbols + 7) >> 3
        gated = spec.device_validate and group.validators is not None
        vals = group.validators if gated else ()
        if nbytes > _MAX_BYTES or len(vals) > 8 or n_v + len(vals) > _MAX_VALIDATORS:
            raise ValueError("search_kernel: a group's packet or parsers exceed the kernel's")
        a.g[g] = _Group(
            group.packet_symbols, nbytes, int(group.wants_r900), int(gated), n_v, len(vals),
            0 if fits is None else fits[g], offsets[f"idx{g}"], offsets[f"keep{g}"],
            offsets[f"pvalid{g}"], offsets[f"bytes{g}"],
            offsets.get(f"symbols{g}", 0))
        for v in vals:
            if (v.rs and not group.wants_r900) or n_c + len(v.crcs) > _MAX_CRCS:
                raise ValueError("search_kernel: a parser's gates exceed the kernel's")
            a.v[n_v] = _Validator(int(v.rs), n_c, len(v.crcs))
            n_v += 1
            for c in v.crcs:
                if len(c.ranges) > _MAX_RANGES or any(not 0 <= lo <= hi <= nbytes
                                                      for lo, hi in c.ranges):
                    raise ValueError("search_kernel: a CRC's byte ranges exceed the kernel's")
                lo = [lo for lo, _ in c.ranges] + [0] * (_MAX_RANGES - len(c.ranges))
                hi = [hi for _, hi in c.ranges] + [0] * (_MAX_RANGES - len(c.ranges))
                a.c[n_c] = _Crc(c.init, c.poly, c.residue, len(c.ranges),
                                (ctypes.c_int * _MAX_RANGES)(*lo),
                                (ctypes.c_int * _MAX_RANGES)(*hi))
                n_c += 1
    a.max_span = max(PAYLOAD_SYMBOLS if g.wants_r900 else g.packet_symbols for g in spec.groups)
    a.n_crcs = n_c
    return a


def _search_fn():
    from .build import load

    fn = load("search").rtlamr_search
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
    return fn


def search_kernel(spec: FrontendSpec, bits: torch.Tensor, q6: Optional[torch.Tensor],
                  mask2d: torch.Tensor, fits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``pack_results(search_slice(spec, bits, q6, mask2d))``, byte for
    byte, by the CUDA kernels of ``csrc/search.cu`` on the current stream;
    with ``fits`` (the look-ahead's, :func:`~.spec.lookahead_geometry`)
    the (G,) int32 :func:`lookahead_guards` of ``mask2d`` follow it.

    CUDA tensors only; a launch sequence (three kernels) is counted in
    ``search_kernel.launches``. Arguments the kernels do not take, or a
    failed build or launch, raise."""
    if bits.device.type != "cuda":
        raise ValueError(f"search_kernel: CUDA tensors only, got {bits.device}")
    dev = bits.device
    w = mask2d.shape[0] * LANES
    n_q6 = 0 if q6 is None else q6.shape[0]
    ok = (
        bits.dtype == torch.uint8 and bits.dim() == 1 and bits.is_contiguous()
        and mask2d.dtype == torch.uint8 and mask2d.shape[1:] == (LANES,)
        and mask2d.is_contiguous() and mask2d.data_ptr() % 16 == 0 and mask2d.device == dev
        and w <= bits.shape[0] <= staged_geometry(spec).lp
        and (not spec.wants_r900 or (q6 is not None and n_q6 == bits.shape[0] - spec.symbol_length))
        and (q6 is None or (q6.dtype == torch.uint8 and q6.dim() == 1 and q6.is_contiguous()
                            and q6.device == dev))
    )
    if not ok:
        raise ValueError(
            f"search_kernel: want contiguous u8 bits, q6 (bits - SL long where a group wants "
            f"R900 digits) and a 16-byte aligned (rows, {LANES}) mask on one card, got "
            f"bits {bits.dtype} {tuple(bits.shape)}, mask {mask2d.dtype} {tuple(mask2d.shape)}"
            f", q6 {None if q6 is None else (q6.dtype, tuple(q6.shape))}")
    args = _search_args(spec, w, bits.shape[0], n_q6, None if fits is None else tuple(fits))
    n_groups = len(spec.groups)
    out = torch.empty(packed_size(spec) + (0 if fits is None else 4 * n_groups),
                      dtype=torch.uint8, device=dev)
    tiles = torch.empty(TILE_FIELDS * args.n_tiles, dtype=torch.int32, device=dev)
    dropw = torch.empty(n_groups * args.n_tiles * THREADS, dtype=torch.int32, device=dev)
    rs = _device_table("rs", str(dev))
    fn = _search_fn()
    with torch.cuda.device(dev):
        rc = fn(mask2d.data_ptr(), bits.data_ptr(), None if q6 is None else q6.data_ptr(),
                tiles.data_ptr(), dropw.data_ptr(), out.data_ptr(), rs.data_ptr(),
                ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"search_kernel: CUDA error {rc} at launch")
    search_kernel.launches += 1
    return out


#: launch sequences since the last reset, a CUDA graph's replays included
#: (ops/frontend.SearchGraph)
search_kernel.launches = 0
