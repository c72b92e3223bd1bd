"""The queue of stream bytes a streaming decoder has been fed and not yet
decoded: the narrowband decoders' IQ bytes and the wideband decoders'
wideband bytes alike."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ByteQueue:
    """Unconsumed u8 stream bytes, held as a list of chunks so that many
    small pushes do not copy the whole queue once each: the chunks are
    joined by one concatenate when whole units are taken. ``size`` is the
    bytes queued; ``data`` the bytes queued at first (a :meth:`state`)."""

    def __init__(self, data=()) -> None:
        self._set(np.array(data, np.uint8))

    def push(self, data: np.ndarray) -> None:
        """Queue a copy of ``data``, so the caller may reuse its buffer."""
        chunk = np.array(data, np.uint8, copy=True).reshape(-1)
        if chunk.size:
            self._chunks.append(chunk)
            self.size += int(chunk.size)

    def take(self, n: int) -> List[np.ndarray]:
        """Remove and return the whole units of ``n`` bytes at the head, as
        views of one buffer; the rest stays queued."""
        if self.size < n:
            return []
        buf = self._joined()
        k = buf.size // n
        self._set(buf[k * n :])
        return [buf[i * n : (i + 1) * n] for i in range(k)]

    def take_blocks(self, block: int, window: int) -> Tuple[Optional[np.ndarray], int]:
        """Remove the whole blocks of ``block`` bytes at the head; return
        them zero-padded to ``window`` bytes, and their count (None and 0
        when there is no whole block)."""
        k = self.size // block
        if not k:
            return None, 0
        buf = self._joined()
        padded = np.zeros(window, np.uint8)
        padded[: k * block] = buf[: k * block]
        self._set(buf[k * block :])
        return padded, k

    def discard(self) -> int:
        """Drop every queued byte; returns how many."""
        n = self.size
        self._set(np.zeros(0, np.uint8))
        return n

    def state(self) -> np.ndarray:
        """A copy of the queued bytes."""
        return self._joined().copy()

    def _joined(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros(0, np.uint8)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]

    def _set(self, value: np.ndarray) -> None:
        self._chunks: List[np.ndarray] = [value] if value.size else []
        self.size = int(value.size)
