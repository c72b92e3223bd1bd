"""Cross-block digest dedup (reference: main.go:144-145, 252-260, 292).

A message found near a block boundary is decoded by two consecutive sample
blocks; the reference suppresses the second occurrence by keeping digest sets
for the previous and current block and swapping them at block end. The same
logic runs at the gather point of the sharded pipeline, where a packet inside
a halo region is decoded by two neighboring shards.
"""

from __future__ import annotations

from typing import Set

from .protocols.base import Digest


class BlockDeduper:
    """prev/next digest-set dedup with per-block swap semantics."""

    def __init__(self) -> None:
        self.prev: Set[Digest] = set()
        self.next: Set[Digest] = set()

    def start_block(self) -> None:
        # Clear the next map for this sample block (main.go:221-223).
        self.next = set()

    def check(self, d: Digest) -> bool:
        """Record ``d`` for this block; True if it should be emitted.

        Mirrors main.go:252-260: the digest is always marked seen for the
        next block, and suppressed only if the previous block saw it.
        """
        self.next.add(d)
        return d not in self.prev

    def end_block(self) -> None:
        # Swap next and previous digest maps (main.go:292).
        self.prev, self.next = self.next, self.prev
