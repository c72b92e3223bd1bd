"""Bit-manipulation helpers shared by the oracle and host-side parsing."""

from __future__ import annotations

import numpy as np


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """MSB-first pack of a (..., 8*k) 0/1 array into (..., k) uint8.

    Matches the packing of protocol/decode.go:363-366 (shift-in MSB first).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    *lead, n = bits.shape
    if n % 8:
        raise ValueError(f"bit count {n} not a multiple of 8")
    weights = np.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=np.uint16)
    grouped = bits.reshape(*lead, n // 8, 8).astype(np.uint16)
    return (grouped @ weights).astype(np.uint8)


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """MSB-first unpack of (..., k) uint8 into (..., 8*k) 0/1 uint8."""
    data = np.asarray(data, dtype=np.uint8)
    return np.unpackbits(data, axis=-1)


def bits_to_uint(bits: np.ndarray) -> int:
    """Interpret a 0/1 array MSB-first as an unsigned integer."""
    b = np.asarray(bits).ravel().astype(np.uint64)
    n = b.size
    if n == 0:
        return 0
    weights = np.left_shift(np.uint64(1), np.arange(n - 1, -1, -1, dtype=np.uint64))
    return int((b * weights).sum())


def bitfield(bits: np.ndarray, lo: int, hi: int) -> int:
    """Integer value of bits[lo:hi] MSB-first (mirrors Go's data.Bits[a:b])."""
    return bits_to_uint(np.asarray(bits)[lo:hi])


def bitfields_strided(
    bits: np.ndarray, start: int, width: int, count: int
) -> np.ndarray:
    """``count`` consecutive MSB-first fields of ``width`` bits from
    ``start`` — vectorized (e.g. IDM's 47x9-bit intervals, idm/idm.go:136-141).
    """
    b = (
        np.asarray(bits)[start : start + width * count]
        .reshape(count, width)
        .astype(np.uint64)
    )
    weights = np.left_shift(
        np.uint64(1), np.arange(width - 1, -1, -1, dtype=np.uint64)
    )
    return b @ weights


def _weights(width: int) -> np.ndarray:
    return np.left_shift(
        np.uint64(1), np.arange(width - 1, -1, -1, dtype=np.uint64)
    )


def bitfield_rows(bits: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """MSB-first value of bits[:, lo:hi] for every row of an (N, B) 0/1
    matrix — the batch form of :func:`bitfield` used by the vectorized
    whole-window parsers. Returns (N,) uint64."""
    return (bits[:, lo:hi].astype(np.uint64) * _weights(hi - lo)).sum(axis=1)


def bitfields_strided_rows(
    bits: np.ndarray, start: int, width: int, count: int
) -> np.ndarray:
    """Batch form of :func:`bitfields_strided`: ``count`` consecutive
    ``width``-bit fields per row. Returns (N, count) uint64."""
    b = (
        np.asarray(bits)[:, start : start + width * count]
        .reshape(bits.shape[0], count, width)
        .astype(np.uint64)
    )
    return (b * _weights(width)).sum(axis=2)
