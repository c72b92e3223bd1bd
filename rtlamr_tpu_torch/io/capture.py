"""Capture-file IQ sources and the sample-dump writer.

The reference has no offline decode mode (its only input is rtl_tcp) but
dumps raw samples to ``-samplefile`` whenever a packet is found
(main.go:279-289) so captures can be re-decoded. This module provides both
sides: file/stream sources for offline decoding and the dump writer.
"""

from __future__ import annotations

import io
import os
import sys
from typing import Iterator, Optional

import numpy as np


class IQSource:
    """Abstract source of u8 interleaved IQ bytes."""

    def read(self, n_bytes: int) -> np.ndarray:
        """Up to n_bytes of IQ; empty array at end of stream."""
        raise NotImplementedError

    def dropped_bytes(self) -> int:
        """Bytes the transport dropped because the consumer fell behind
        (0 for transports with backpressure)."""
        return 0

    def close(self) -> None:
        pass


class FileSource(IQSource):
    """Raw u8 IQ capture file (the format of -samplefile dumps)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")

    def read(self, n_bytes: int) -> np.ndarray:
        data = self._f.read(n_bytes)
        return np.frombuffer(data, dtype=np.uint8)

    def close(self) -> None:
        self._f.close()


class StdinSource(IQSource):
    """IQ piped on stdin (rtl_sdr | rtlamr-style usage)."""

    def __init__(self):
        self._f = sys.stdin.buffer

    def read(self, n_bytes: int) -> np.ndarray:
        data = self._f.read(n_bytes)
        return np.frombuffer(data or b"", dtype=np.uint8)


class ArraySource(IQSource):
    """In-memory capture (tests, bench)."""

    def __init__(self, iq: np.ndarray):
        self.iq = np.asarray(iq, dtype=np.uint8)
        self.pos = 0

    def read(self, n_bytes: int) -> np.ndarray:
        chunk = self.iq[self.pos : self.pos + n_bytes]
        self.pos += chunk.size
        return chunk


class RtlTcpSource(IQSource):
    """Live samples from an rtl_tcp server (reference L1)."""

    def __init__(self, client, deadline: float = 5.0):
        self.client = client
        self.deadline = deadline

    def read(self, n_bytes: int) -> np.ndarray:
        return self.client.read_samples(n_bytes, deadline=self.deadline)

    def dropped_bytes(self) -> int:
        stats = getattr(self.client, "stats", None)
        if stats is None:
            return 0
        _total, dropped, _buffered = stats()
        return int(dropped)

    def close(self) -> None:
        self.client.close()


class SampleDumper:
    """-samplefile writer: raw IQ dumped when packets are found
    (main.go:279-289), with tell() for LogMessage offsets (main.go:244-246).
    """

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f: Optional[io.BufferedWriter] = None
        if path and path != os.devnull:
            self._f = open(path, "wb")

    @property
    def active(self) -> bool:
        return self._f is not None

    def offset(self) -> int:
        return self._f.tell() if self._f else 0

    def write(self, iq: np.ndarray) -> None:
        if self._f:
            self._f.write(np.asarray(iq, np.uint8).tobytes())

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class SampleRing:
    """Exact simulation of the reference's rolling sample buffer.

    The reference keeps a bytes.Buffer of the most recent ~BufferLength*2
    bytes: before decoding each block it discards one block from the front
    once the buffer exceeds BufferLength*2 and appends the new block
    (main.go:225-230); every LogMessage records Length = sampleBuf.Len()
    (main.go:247) and Offset = the samplefile's current write position
    (main.go:244-246); after a block that produced messages, the WHOLE
    buffer contents are dumped without draining (main.go:279-284) — so a
    dump always carries the halo needed to re-decode its packet.

    The window pipeline decodes whole windows with one-window dispatch-ahead
    latency, so raw block bytes are retained here from feed time until their
    messages (if any) surface, then the reference's per-block ring walk is
    replayed lazily up to each message's block.
    """

    def __init__(
        self,
        dumper: "SampleDumper",
        block_bytes: int,
        buffer_bytes: int,
        max_lag_blocks: int = 1 << 30,
    ):
        self.dumper = dumper
        self.block_bytes = block_bytes
        self.buffer_bytes = buffer_bytes
        #: decode latency bound: messages for a block surface within this
        #: many blocks of the feed frontier (dispatch-ahead depth); older
        #: stored blocks are pruned. Pass 2*window_blocks + ring capacity.
        self.max_lag_blocks = max_lag_blocks
        self._store: dict[int, np.ndarray] = {}
        self._tail = np.zeros(0, np.uint8)  # partial block of fed bytes
        self._next_fed = 0  # next global block index to store
        self._ring: list[int] = []  # block indices currently in the buffer
        self._ring_len = 0
        self._sim_block = -1  # ring state reflects blocks [.., _sim_block]

    def feed(self, chunk: np.ndarray) -> None:
        """Record raw stream bytes (before decode) at block granularity."""
        data = np.concatenate([self._tail, np.asarray(chunk, np.uint8)])
        nb = data.size // self.block_bytes
        for i in range(nb):
            blk = data[i * self.block_bytes : (i + 1) * self.block_bytes]
            if self.dumper.active:
                self._store[self._next_fed] = blk.copy()
            self._next_fed += 1
        self._tail = data[nb * self.block_bytes :]
        # Prune blocks that can no longer appear in any future ring walk.
        min_keep = self._next_fed - self.max_lag_blocks
        if min_keep > 0 and self._store:
            in_ring = set(self._ring)
            for b in [k for k in self._store if k < min_keep]:
                if b not in in_ring:
                    del self._store[b]

    def advance_to(self, block: int) -> None:
        """Replay the reference's per-block ring update through ``block``."""
        for b in range(self._sim_block + 1, block + 1):
            if self._ring_len > self.buffer_bytes:
                # io.CopyN(io.Discard, sampleBuf, len(block)) (main.go:228)
                drop = self._ring.pop(0)
                self._ring_len -= self.block_bytes
                self._store.pop(drop, None)
            self._ring.append(b)
            self._ring_len += self.block_bytes
        self._sim_block = max(self._sim_block, block)

    def resume_at(self, block: int, history: Optional[np.ndarray] = None) -> None:
        """Start the walk of a stream resumed at ``block`` in the state of
        one that walked blocks [0, block), so Length continues as in an
        uninterrupted run. ``history``, the stream bytes that end where
        ``block`` starts, fills the ring's stored blocks for dumps."""
        n = min(block, self.buffer_bytes // self.block_bytes + 1)
        self._ring = list(range(block - n, block))
        self._ring_len = n * self.block_bytes
        self._next_fed = block
        self._sim_block = block - 1
        if self.dumper.active and history is not None:
            for b in self._ring:
                end = history.size - (block - 1 - b) * self.block_bytes
                if end - self.block_bytes >= 0:
                    self._store[b] = history[end - self.block_bytes : end].copy()

    @property
    def length(self) -> int:
        """sampleBuf.Len() for LogMessage.Length (main.go:247)."""
        return self._ring_len

    def dump(self) -> None:
        """Write the buffer contents after a packet block (main.go:279-284)."""
        if not self.dumper.active:
            return
        for b in self._ring:
            blk = self._store.get(b)
            if blk is not None:
                self.dumper.write(blk)
