"""GF(2^m) arithmetic and Reed-Solomon syndrome computation.

Mirrors the behavior of the reference's Galois-field library
(r900/gf/gf.go): a field of given ``order`` defined by an irreducible
polynomial and generator alpha, with log/exp tables, plus the Horner-scheme
syndrome used by the R900 parser (r900/r900.go:215-221: GF(32), poly 37,
generator 2, 31-symbol codeword, 5 syndromes, offset 29, all-zero required).

The batch syndrome evaluates all N candidate codewords in lockstep using a
precomputed full multiplication table, which is the vectorized layout used on
host and mirrored by the device kernel in ops/.
"""

from __future__ import annotations

import functools

import numpy as np


def _nbit(p: int) -> int:
    n = 0
    while p > 0:
        n += 1
        p >>= 1
    return n


def _poly_div(p: int, q: int) -> int:
    np_, nq = _nbit(p), _nbit(q)
    while np_ >= nq:
        if p & (1 << (np_ - 1)):
            p ^= q << (np_ - nq)
        np_ -= 1
    return p


def _reducible(p: int) -> bool:
    np_ = _nbit(p)
    for q in range(2, 1 << (np_ // 2 + 1)):
        if _poly_div(p, q) == 0:
            return True
    return False


def _mul(x: int, y: int, order: int, poly: int) -> int:
    z = 0
    while x > 0:
        if x & 1:
            z ^= y
        x >>= 1
        y <<= 1
        if y & order:
            y ^= poly
    return z


class GF:
    """GF(order) with log/exp tables (r900/gf/gf.go:10-57)."""

    def __init__(self, order: int, poly: int, alpha: int):
        if order < 0 or order > 256:
            raise ValueError(f"gf: invalid order: {order}")
        if poly < order or poly >= order << 1 or _reducible(poly):
            raise ValueError(f"gf: invalid polynomial: {poly}")

        self.size = order
        self.order = order - 1  # multiplicative group order
        self.log = np.zeros(order, dtype=np.uint8)
        self.exp = np.zeros((order - 1) * 2, dtype=np.uint8)

        x = 1
        for i in range(self.order):
            if x == 1 and i != 0:
                raise ValueError(
                    f"gf: invalid generator {alpha} for polynomial {poly}"
                )
            self.exp[i] = x
            self.exp[i + self.order] = x
            self.log[x] = i
            x = _mul(x, alpha, order, poly)
        self.log[0] = self.order

        # Full multiplication table for vectorized batch operations.
        a = np.arange(order)
        la = self.log[a].astype(np.int32)
        mul = self.exp[(la[:, None] + la[None, :]) % self.order]
        mul = np.where((a[:, None] == 0) | (a[None, :] == 0), 0, mul)
        self.mul_table = mul.astype(np.uint8)

    def add(self, x: int, y: int) -> int:
        return x ^ y

    def exp_(self, e: int) -> int:
        """Base-alpha exponential; 0 for negative e (gf.go:117-122)."""
        if e < 0:
            return 0
        return int(self.exp[e % self.order])

    def log_(self, x: int) -> int:
        """Base-alpha log; -1 for x == 0 (gf.go:126-131)."""
        if x == 0:
            return -1
        return int(self.log[x])

    def inv(self, x: int) -> int:
        if x == 0:
            return 0
        return int(self.exp[self.order - int(self.log[x])])

    def mul(self, x: int, y: int) -> int:
        if x == 0 or y == 0:
            return 0
        return int(self.exp[int(self.log[x]) + int(self.log[y])])

    def syndrome(self, message, parity_count: int, offset: int) -> np.ndarray:
        """Horner-scheme syndrome of one codeword (gf.go:152-172)."""
        if offset < 0 or offset > self.order:
            raise ValueError(f"gf: invalid offset: {offset}")
        message = np.asarray(message, dtype=np.uint8)
        if parity_count < 0 or parity_count > len(message):
            raise ValueError(
                f"gf: invalid paritySymbolCount: {parity_count}"
            )
        # All parity positions advance in lockstep over the Horner fold; one
        # mul-table row lookup per codeword symbol instead of scalar muls.
        m = np.array(
            [self.exp_(offset + i) for i in range(parity_count)], np.uint8
        )
        syn = np.full(parity_count, int(message[0]), dtype=np.uint8)
        mul = self.mul_table
        for v in message[1:]:
            syn = mul[syn, m] ^ v
        return syn


@functools.lru_cache(maxsize=None)
def r900_field() -> GF:
    """The R900 field: GF(32), polynomial 37, generator 2 (r900/r900.go:68)."""
    return GF(32, 37, 2)


def rs_syndromes_batch(
    messages: np.ndarray, parity_count: int, offset: int, field: GF | None = None
) -> np.ndarray:
    """Syndromes for each row of an (N, L) symbol matrix. Returns (N, parity_count)."""
    field = field or r900_field()
    messages = np.asarray(messages, dtype=np.uint8)
    if messages.ndim == 1:
        messages = messages[None, :]
    n, length = messages.shape
    out = np.zeros((n, parity_count), dtype=np.uint8)
    mul = field.mul_table
    for idx in range(parity_count):
        m = field.exp_(offset + idx)
        syn = messages[:, 0].copy()
        for col in range(1, length):
            syn = mul[syn, m] ^ messages[:, col]
        out[:, idx] = syn
    return out
