"""The end of the CLI call that the harness holds: the ``out`` its encoder
writes to."""

from __future__ import annotations

import io
import time
from typing import List, Tuple


class StampSink(io.TextIOBase):
    """Stands in for ``sys.stdout`` during a CLI call: keeps each line the
    encoder writes with the ``time.monotonic()`` at which its newline was
    written."""

    def __init__(self):
        super().__init__()
        self.lines: List[Tuple[float, str]] = []
        self._part: List[str] = []

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        if "\n" not in s:
            self._part.append(s)
            return len(s)
        now = time.monotonic()
        head, *rest = s.split("\n")
        self.lines.append((now, "".join(self._part) + head))
        for line in rest[:-1]:
            self.lines.append((now, line))
        self._part = [rest[-1]] if rest[-1] else []
        return len(s)
