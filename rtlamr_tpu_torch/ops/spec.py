"""Static window geometry of the decode program.

Pure Python/numpy: the window configuration (:class:`FrontendSpec`), the
staged-buffer layout (:class:`StagedGeometry`), the packed result buffer's
layout (:func:`result_layout`) and host staging. Every field
is value-equal to the JAX package's ``ops/frontend.py`` spec, including the
TPU tile fields (``tile_rows``, ``r_out``, ``r_in``, ``n_tiles``): they fix
``staged_samples``, so one staged u16 buffer feeds both packages and the
packed result layout matches byte for byte.

Stream coordinates (overlap-save, reference protocol/decode.go:163-375): a
window covering search positions ``[s*W, (s+1)*W)`` reads magnitude samples
from ``s*W - PacketLength - SymbolLength`` on, so it carries a left halo of
``PacketLength + SymbolLength`` samples, padded up to ``ALIGN``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..protocols.base import DecoderConfig
from ..protocols.r900 import PAYLOAD_SYMBOLS

#: Row width of the staged layout (kept for geometry equality with the TPU
#: build, whose streams are viewed as (rows, 128) lane tiles).
LANES = 128
#: Staged-buffer alignment in samples: the staged halo is rounded up to this.
ALIGN = 1024


@dataclass(frozen=True)
class GroupSpec:
    """Static per-preamble-group metadata."""

    preamble: str
    bits: Tuple[int, ...]
    packet_symbols: int
    wants_r900: bool
    #: per-parser device validity descriptors (protocols.base.DeviceValidator,
    #: OR across parsers); None when any parser in the group can't validate
    #: on device, disabling the pre-compaction checksum filter.
    validators: Optional[Tuple[object, ...]] = None


@dataclass(frozen=True)
class FrontendSpec:
    """Static configuration of a decode window program."""

    chip_length: int
    symbol_length: int
    preamble_length: int
    packet_length: int
    block_size: int
    window: int  # W: search positions per window; multiple of block_size
    #: escalation threshold on distinct candidates per group per window; a
    #: window with more re-decodes under the high-capacity variant
    #: (decoder/pipeline._big_spec).
    max_hits: int
    groups: Tuple[GroupSpec, ...]
    wants_r900: bool
    #: the JAX package's stencil backend name; kept for spec equality. The
    #: port always runs its CUDA kernel on the card.
    backend: str = "jnp"
    #: run the per-group checksum gates (CRC-16 / R900 RS) in the window
    #: program so only valid candidates occupy result slots. Semantics-free:
    #: parsers re-validate survivors on host.
    device_validate: bool = True
    #: raw-hit gather capacity before duplicate collapse.
    gather_hits: int = 4096
    #: row capacity of the two-level hit compaction over the
    #: (window/128, 128) mask.
    gather_rows: int = 1024
    #: capacity of the per-candidate content gathers after the exact
    #: pre-slice plateau collapse (see ops/search._edge_span_streams).
    slice_hits: int = 512
    #: rows (of 128 samples) per TPU tile; fixes the staged-buffer geometry
    #: shared by both packages (see :func:`staged_geometry`).
    tile_rows: int = 1024

    @property
    def halo(self) -> int:
        return self.packet_length + self.symbol_length

    @property
    def total_samples(self) -> int:
        return self.halo + self.window

    @property
    def pad_shift(self) -> int:
        """Left padding that aligns the staged halo to ALIGN samples."""
        return -self.halo % ALIGN

    @property
    def halo_staged(self) -> int:
        return self.halo + self.pad_shift

    @property
    def staged_samples(self) -> int:
        """Length (in samples == u16 elements) of a staged window buffer."""
        return staged_geometry(self).staged_samples


class StagedGeometry(NamedTuple):
    """Static layout of the staged u16 window buffer.

    The staged buffer holds ``staged_samples`` u16 elements (one interleaved
    IQ byte-pair each, little-endian: I in the low byte). Index ``s`` holds
    the stream sample ``window_start - halo_staged + s``; indices past
    ``halo_staged + window`` are zero tail padding. Contents of
    ``[0, pad_shift)`` are never read (every stencil read is offset by
    ``pad_shift``).
    """

    lp: int  # bit-stream positions needed (window + packet - symbol)
    lq: int  # R900 6-ary stream positions needed
    pre_reach: int  # deepest bit offset read by the correlation bank
    r_out: int  # output rows per TPU tile
    r_bits: int  # rows of the extended bit stream computed per TPU tile
    r_in: int  # input rows read per TPU tile
    n_tiles: int
    staged_rows: int
    staged_samples: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def staged_geometry(spec: FrontendSpec) -> StagedGeometry:
    sl = spec.symbol_length
    cl = spec.chip_length
    w = spec.window
    lp = w + spec.packet_length - sl
    lq = w + spec.packet_length - 2 * sl
    max_pre_bits = max(len(g.bits) for g in spec.groups)
    pre_reach = (max_pre_bits - 1) * sl

    r_out = min(spec.tile_rows, _round_up(-(-lp // LANES), 8))
    n_tiles = -(-lp // (r_out * LANES))
    r_bits = r_out + -(-pre_reach // LANES) + 1
    # Deepest staged-sample read past a tile's first output position:
    # correlation bits (via the Manchester stencil) and the R900 bank.
    need = max(
        r_bits * LANES + sl + spec.pad_shift,
        r_out * LANES + sl + 4 * cl + spec.pad_shift,
    )
    r_in = _round_up(-(-need // LANES) + 1, 8)
    staged_rows = (n_tiles - 1) * r_out + r_in
    # The staged buffer must also hold the full live content.
    staged_rows = max(staged_rows, -(-(spec.halo_staged + w) // LANES))
    staged_rows = _round_up(staged_rows, 8)
    return StagedGeometry(
        lp=lp,
        lq=lq,
        pre_reach=pre_reach,
        r_out=r_out,
        r_bits=r_bits,
        r_in=r_in,
        n_tiles=n_tiles,
        staged_rows=staged_rows,
        staged_samples=staged_rows * LANES,
    )


class LookAhead(NamedTuple):
    """The window program's look-ahead: the positions ``[window, window +
    extent)`` of the staged buffer, the next window's first ``extent /
    block_size`` blocks, searched with the bits and R900 digits already
    computed for this window.

    ``fits[g]`` counts the positions from ``window`` on whose whole packet
    of group g lies inside the streams (bits below ``lp``, R900 digits
    below ``lq``): there the search gives exactly what the next window's
    gives. A block past a group's fit is resolved only when that group has
    no raw preamble hit there (:func:`resolved_blocks`).
    """

    extent: int  # positions; a whole number of blocks, 0: no look-ahead
    fits: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def lookahead_geometry(spec: FrontendSpec) -> LookAhead:
    geo = staged_geometry(spec)
    w, sl, bs = spec.window, spec.symbol_length, spec.block_size
    base = spec.preamble_length - sl  # first R900 payload digit past a hit
    fits = []
    for g in spec.groups:
        fit = geo.lp - w - (g.packet_symbols - 1) * sl
        if g.wants_r900:
            fit = min(fit, geo.lq - w - base - (PAYLOAD_SYMBOLS - 1) * 4 * spec.chip_length)
        fits.append(max(fit, 0))
    # Every position's preamble bits lie below lp, and an R900 slice index
    # (its fill, the extent, included) below lq.
    room = geo.lp - w - geo.pre_reach
    if spec.wants_r900:
        room = min(room, geo.lq - w - base)
    extent = max(min(-(-max(fits) // bs), room // bs) * bs, 0) if bs % LANES == 0 else 0
    return LookAhead(extent, tuple(fits))


@functools.lru_cache(maxsize=None)
def lookahead_spec(spec: FrontendSpec) -> FrontendSpec:
    """The spec the look-ahead is searched with: the window's, its
    capacities scaled by extent / window (rounded up; rows at most the
    look-ahead's). A look-ahead that overflows one defers its blocks to
    their own window."""
    n = lookahead_geometry(spec).extent

    def scale(x: int) -> int:
        return -(-x * n // spec.window)

    return replace(spec, max_hits=scale(spec.max_hits), gather_hits=scale(spec.gather_hits),
                   slice_hits=scale(spec.slice_hits),
                   gather_rows=min(scale(spec.gather_rows), n // LANES))


def resolved_blocks(spec: FrontendSpec, guards: Sequence[int]) -> int:
    """Blocks of the look-ahead, from its first on, whose messages are all
    known: in each, every group's packets fit or the group has no raw hit.
    ``guards[g]`` is group g's first raw hit at or past its fit, relative
    to ``window`` (the extent when there is none)."""
    la = lookahead_geometry(spec)
    n = la.extent // spec.block_size
    for fit, hit in zip(la.fits, guards):
        n = min(n, max(fit, int(hit)) // spec.block_size)
    return n


def result_layout(spec: FrontendSpec) -> List[Tuple[str, int, int]]:
    """(name, byte_offset, byte_size) entries of the packed result buffer.

    Rows are carried at the slice capacity with a per-group keep mask; the
    host compacts survivors after the fetch (see ops/search.search_slice)."""
    k = min(spec.slice_hits, spec.gather_hits)
    layout = []
    off = 0

    def add(name, size):
        nonlocal off
        layout.append((name, off, size))
        off += size

    add("counts", 4 * len(spec.groups) * 2)
    for g, group in enumerate(spec.groups):
        add(f"idx{g}", 4 * k)
    for g, group in enumerate(spec.groups):
        add(f"keep{g}", k)
    for g, group in enumerate(spec.groups):
        add(f"pvalid{g}", k)
    for g, group in enumerate(spec.groups):
        nbytes = (group.packet_symbols + 7) >> 3
        add(f"bytes{g}", k * nbytes)
    for g, group in enumerate(spec.groups):
        if group.wants_r900:
            add(f"symbols{g}", k * PAYLOAD_SYMBOLS)
    add("_total", 0)
    return layout


@functools.lru_cache(maxsize=None)
def packed_size(spec: FrontendSpec) -> int:
    return result_layout(spec)[-1][1]


def stage_host(spec: FrontendSpec, iq: np.ndarray) -> np.ndarray:
    """Host-side staging: u8 interleaved IQ bytes -> staged u16 buffer.

    ``iq`` covers stream samples ``[window_start - halo, window_start +
    window)``; it lands at staged offset ``pad_shift``.
    """
    geo = staged_geometry(spec)
    iq = np.ascontiguousarray(np.asarray(iq, np.uint8))
    out = np.zeros(geo.staged_samples, np.uint16)
    u16 = iq.view(np.uint16)
    out[spec.pad_shift : spec.pad_shift + u16.size] = u16
    return out


def make_frontend_spec(
    cfg: DecoderConfig,
    window_blocks: int,
    max_hits: int = 256,
    backend: str = "jnp",
    device_validate: bool = True,
) -> FrontendSpec:
    groups = []
    wants_any = False
    for preamble, parsers in cfg.preamble_groups.items():
        wants = any(p.wants_r900_symbols for p in parsers)
        wants_any = wants_any or wants
        vals = tuple(p.device_validator() for p in parsers)
        groups.append(
            GroupSpec(
                preamble=preamble,
                bits=tuple(int(c) for c in preamble),
                packet_symbols=cfg.group_packet_symbols(preamble),
                wants_r900=wants,
                validators=None if any(v is None for v in vals) else vals,
            )
        )
    window = window_blocks * cfg.block_size
    # Preamble hits form plateaus ~ChipLength positions wide per packet, so
    # the raw-hit gather needs ~CL x the distinct-candidate capacity.
    gather_hits = min(max(4 * max_hits, 2048), window)
    lp_rows = -(-(window + cfg.packet_length) // LANES)
    return FrontendSpec(
        chip_length=cfg.chip_length,
        symbol_length=cfg.symbol_length,
        preamble_length=cfg.preamble_length,
        packet_length=cfg.packet_length,
        block_size=cfg.block_size,
        window=window,
        max_hits=max_hits,
        groups=tuple(groups),
        wants_r900=wants_any,
        backend=backend,
        device_validate=device_validate,
        gather_hits=gather_hits,
        # Distinct candidate contents per group per window after the exact
        # plateau collapse; overflow escalates exactly.
        slice_hits=min(max(max_hits + 128, 384), gather_hits),
        # Preamble plateaus cluster in few 128-sample rows (~2 per packet).
        gather_rows=min(max(3 * gather_hits // 16, 384), window // 128),
        tile_rows=min(512, _round_up(lp_rows, 8)),
    )
