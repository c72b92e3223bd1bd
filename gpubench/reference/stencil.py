"""The decode stencil (K1's function) in plain NumPy, from raw stream bytes.

One window of the stream, searching positions ``[i W, (i + 1) W)``, reads
the ``halo_staged = PacketLength + SymbolLength + pad_shift`` samples before
them; at the stream head (``first``) that history is zero and the first
PacketLength bits are zero (the reference's zeroed buffers, decode.go:144).
Outputs, in the receiver's window layout:

- bits: (lp,) u8 Manchester bits, lp = W + PacketLength - SymbolLength;
- q6: (lq,) u8 R900 6-ary symbols, lq = W + PacketLength - 2 SymbolLength;
- mask: (W,) u8, bit g set where preamble group g matches at stride
  SymbolLength (groups in the decoder config's registration order).

``arithmetic="int"`` is exact: the squared magnitude ``(255-2I)^2 +
(255-2Q)^2`` is an integer and every filter output a difference of int64
prefix sums. ``arithmetic="float32"`` takes the same prefix sums in float32,
the precision step below exact integers that a faster stencil would tempt;
it is the control that the comparison has to reject.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

#: staged halo alignment of the receiver's window layout, in samples
ALIGN = 1024


@dataclass(frozen=True)
class WindowGeometry:
    chip_length: int
    symbol_length: int
    packet_length: int
    preamble_length: int
    block_size: int
    window: int
    groups: Tuple[Tuple[int, ...], ...]
    wants_r900: bool

    @property
    def halo(self) -> int:
        return self.packet_length + self.symbol_length

    @property
    def pad_shift(self) -> int:
        return -self.halo % ALIGN

    @property
    def halo_staged(self) -> int:
        return self.halo + self.pad_shift

    @property
    def lp(self) -> int:
        return self.window + self.packet_length - self.symbol_length

    @property
    def lq(self) -> int:
        return self.window + self.packet_length - 2 * self.symbol_length


def window_geometry(cfg, window_blocks: int) -> WindowGeometry:
    """The window layout of a reference decoder config (``protocols.base``
    ``build_decoder_config``) at ``window_blocks`` blocks a window."""
    groups = []
    wants = False
    for preamble, parsers in cfg.preamble_groups.items():
        groups.append(tuple(int(c) for c in preamble))
        wants = wants or any(p.wants_r900_symbols for p in parsers)
    return WindowGeometry(
        chip_length=cfg.chip_length, symbol_length=cfg.symbol_length,
        packet_length=cfg.packet_length, preamble_length=cfg.preamble_length,
        block_size=cfg.block_size, window=window_blocks * cfg.block_size,
        groups=tuple(groups), wants_r900=wants)


def window_samples(geo: WindowGeometry, samples_u16, index: int) -> np.ndarray:
    """(halo_staged + W,) u16 samples of window ``index`` of a stream;
    ``samples_u16(lo, hi)`` returns the stream's samples ``[lo, hi)`` as u16
    (I in the low byte), zeros before the stream's first sample."""
    hs, w = geo.halo_staged, geo.window
    return samples_u16(index * w - hs, (index + 1) * w)


def stencil(geo: WindowGeometry, samples: np.ndarray, first: bool,
            arithmetic: str = "int") -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """(bits, q6, mask) of one window's (halo_staged + W,) u16 samples."""
    if arithmetic not in ("int", "float32"):
        raise ValueError(f"arithmetic {arithmetic!r}: want int or float32")
    cl, sl, pl = geo.chip_length, geo.symbol_length, geo.packet_length
    ps, lp, lq = geo.pad_shift, geo.lp, geo.lq
    v = samples.astype(np.int64)
    di = 255 - 2 * (v & 255)
    dq = 255 - 2 * (v >> 8)
    mag = di * di + dq * dq
    if first:
        mag[: geo.halo_staged] = 0
    if arithmetic == "int":
        cs = np.zeros(mag.size + 1, np.int64)
        np.cumsum(mag, out=cs[1:])
    else:
        cs = np.zeros(mag.size + 1, np.float32)
        np.cumsum(mag.astype(np.float32), dtype=np.float32, out=cs[1:])
    f = 2 * cs[ps + cl : ps + cl + lp] - cs[ps : ps + lp] - cs[ps + sl : ps + sl + lp]
    bits = (f >= 0).astype(np.uint8)
    if first:
        bits[:pl] = 0
    q6 = None
    if geo.wants_r900:
        c = [cs[ps + sl + i * cl : ps + sl + i * cl + lq] for i in range(5)]
        a = np.stack([
            2 * c[2] - c[4] - c[0],  # 1100
            2 * c[1] - 2 * c[2] + 2 * c[3] - c[4] - c[0],  # 1010
            2 * c[1] - 2 * c[3] + c[4] - c[0],  # 1001
        ])
        arg = np.argmax(np.abs(a), axis=0)  # first max == the strict-> chain
        chosen = np.take_along_axis(a, arg[None, :], axis=0)[0]
        q6 = (arg + np.where(chosen > 0, 3, 0)).astype(np.uint8)
    return bits, q6, masks(geo, bits)


def masks(geo: WindowGeometry, bits: np.ndarray) -> np.ndarray:
    """(W,) u8 preamble-hit mask: bit g at q iff every preamble bit of group
    g matches ``bits`` at stride SymbolLength from q (decode.go:255-348)."""
    sl, w = geo.symbol_length, geo.window
    mask = np.zeros(w, np.uint8)
    for g, group in enumerate(geo.groups):
        acc = np.ones(w, bool)
        for k, bit in enumerate(group):
            acc &= bits[k * sl : k * sl + w] == bit
        mask |= acc.astype(np.uint8) << g
    return mask


def live_words(geo: WindowGeometry, bits: np.ndarray) -> List[np.ndarray]:
    """For each group g, a (len(group), W/32) bool array: whether some
    position of a 32-position word is still alive before preamble symbol k
    (all earlier symbols matched). The yardstick counts the preamble bank's
    operations from it."""
    sl, w = geo.symbol_length, geo.window
    n_words = -(-w // 32)
    out = []
    for group in geo.groups:
        alive = np.zeros(32 * n_words, bool)
        alive[:w] = True
        live = np.zeros((len(group), n_words), bool)
        for k, b in enumerate(group):
            live[k] = alive.reshape(n_words, 32).any(1)
            alive[:w] &= bits[k * sl : k * sl + w] == b
        out.append(live)
    return out


def stencil_chunk(geo: WindowGeometry, samples: np.ndarray, first: bool, q0: int, q1: int):
    """:func:`stencil` (exact) and :func:`live_words` for the output
    positions ``[q0, q1)`` only (``q0`` a multiple of 32), from the samples
    ``[pad_shift + q0, ...)`` of the window that they read (``samples``
    starts there). Every filter output is a difference of prefix sums, so a
    chunk's own sums give the same values; chunks of one window split its
    work over processes. Returns (bits, q6, mask, live) of the chunk."""
    cl, sl, pl = geo.chip_length, geo.symbol_length, geo.packet_length
    lp, lq, w, hs = geo.lp, geo.lq, geo.window, geo.halo_staged
    reach = (max(len(g) for g in geo.groups) - 1) * sl
    qb = min(q1 + reach, lp)  # bits this chunk's mask positions read
    base = geo.pad_shift + q0
    v = samples.astype(np.int64)
    di = 255 - 2 * (v & 255)
    dq = 255 - 2 * (v >> 8)
    mag = di * di + dq * dq
    if first and base < hs:
        mag[: hs - base] = 0
    cs = np.zeros(mag.size + 1, np.int64)
    np.cumsum(mag, out=cs[1:])
    nb = qb - q0
    f = 2 * cs[cl : cl + nb] - cs[0:nb] - cs[sl : sl + nb]
    bits = (f >= 0).astype(np.uint8)
    if first and q0 < pl:
        bits[: pl - q0] = 0
    q6 = None
    if geo.wants_r900:
        nq = max(min(q1, lq) - q0, 0)
        c = [cs[sl + i * cl : sl + i * cl + nq] for i in range(5)]
        a = np.stack([
            2 * c[2] - c[4] - c[0],
            2 * c[1] - 2 * c[2] + 2 * c[3] - c[4] - c[0],
            2 * c[1] - 2 * c[3] + c[4] - c[0],
        ])
        arg = np.argmax(np.abs(a), axis=0)
        chosen = np.take_along_axis(a, arg[None, :], axis=0)[0]
        q6 = (arg + np.where(chosen > 0, 3, 0)).astype(np.uint8)
    nm = max(min(q1, w) - q0, 0)
    mask = np.zeros(nm, np.uint8)
    n_words = -(-nm // 32)
    live = []
    for g, group in enumerate(geo.groups):
        alive = np.zeros(32 * n_words, bool)
        alive[:nm] = True
        lw = np.zeros((len(group), n_words), bool)
        for k, b in enumerate(group):
            lw[k] = alive.reshape(n_words, 32).any(1)
            alive[:nm] &= bits[k * sl : k * sl + nm] == b
        mask |= alive[:nm].astype(np.uint8) << g
        live.append(lw)
    return bits[: min(q1, lp) - q0], q6, mask, live


def chunk_samples_needed(geo: WindowGeometry, q0: int, q1: int) -> tuple:
    """The window's sample range ``[lo, hi)`` that :func:`stencil_chunk`
    reads for output positions ``[q0, q1)``."""
    reach = (max(len(g) for g in geo.groups) - 1) * geo.symbol_length
    qb = min(q1 + reach, geo.lp)
    hi = max(qb + geo.symbol_length + 1, q1 + geo.symbol_length + 4 * geo.chip_length + 1)
    lo = geo.pad_shift + q0
    return lo, min(geo.pad_shift + hi, geo.halo_staged + geo.window)
