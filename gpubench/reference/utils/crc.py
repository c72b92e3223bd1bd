"""Table-driven CRC-16, vectorized over batches of packets.

Semantics mirror the reference library (crc/crc.go): MSB-first CRC-16 with a
256-entry table; ``checksum(init, data) = fold(crc<<8 ^ table[crc>>8 ^ byte])``.

Parameter sets used by the protocols (reference citations):
- BCH   init=0x0000 poly=0x6F63 residue=0x0000  (scm/scm.go:41)
- CCITT init=0xFFFF poly=0x1021 residue=0x1D0F  (scmplus/scmplus.go:48,
  idm/idm.go:48, netidm/netidm.go:59)

The batch variant runs the byte-fold across a whole (N, L) matrix of candidate
packets at once — N lanes advance in lockstep over the L byte positions, which
is the NumPy/JAX-friendly layout (packets are at most 92 bytes, so the fold is
short; the width N carries the vectorization).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def crc_table(poly: int) -> np.ndarray:
    """256-entry MSB-first CRC-16 table for ``poly`` (crc/crc.go:34-47)."""
    idx = np.arange(256, dtype=np.uint32) << 8
    for _ in range(8):
        idx = np.where(idx & 0x8000, (idx << 1) ^ poly, idx << 1) & 0xFFFF
    tbl = idx.astype(np.uint16)
    tbl.flags.writeable = False
    return tbl


def crc16(data, init: int, poly: int) -> int:
    """CRC-16 of one byte sequence (crc/crc.go:49-55)."""
    tbl = crc_table(poly)
    crc = np.uint32(init)
    for b in np.asarray(data, dtype=np.uint8):
        crc = ((crc << 8) ^ tbl[((crc >> 8) ^ b) & 0xFF]) & 0xFFFF
    return int(crc)


def crc16_batch(data: np.ndarray, init: int, poly: int) -> np.ndarray:
    """CRC-16 over each row of an (N, L) uint8 matrix. Returns (N,) uint16."""
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None, :]
    tbl = crc_table(poly).astype(np.uint32)
    crc = np.full(data.shape[0], init, dtype=np.uint32)
    for col in range(data.shape[1]):
        crc = ((crc << 8) ^ tbl[((crc >> 8) ^ data[:, col]) & 0xFF]) & 0xFFFF
    return crc.astype(np.uint16)


class CRC:
    """A named CRC parameter set, mirroring crc.CRC (crc/crc.go:5-30)."""

    def __init__(self, name: str, init: int, poly: int, residue: int):
        self.name = name
        self.init = init
        self.poly = poly
        self.residue = residue
        self.table = crc_table(poly)

    def checksum(self, data) -> int:
        return crc16(data, self.init, self.poly)

    def checksum_batch(self, data: np.ndarray) -> np.ndarray:
        return crc16_batch(data, self.init, self.poly)

    def __repr__(self) -> str:
        return (
            f"{{Name:{self.name} Init:0x{self.init:04X} "
            f"Poly:0x{self.poly:04X} Residue:0x{self.residue:04X}}}"
        )


BCH = CRC("BCH", 0x0000, 0x6F63, 0x0000)
CCITT = CRC("CCITT", 0xFFFF, 0x1021, 0x1D0F)
