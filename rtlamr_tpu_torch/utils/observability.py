"""Observability: counters, the receive-rate watchdog, profiler capture and
the tracer.

The reference's observability is slog text logging (main.go:298-317), a
startup config dump (decode.go:73-90) and a receive-rate watchdog warning
below 90% of the configured sample rate (main.go:189-196). This module
provides the watchdog plus what a GPU deployment adds: counters at the
decoder's layer boundaries, torch.profiler trace capture around the hot
loop, and the tracer.

The tracer times the layers of the live path and of set-up with spans
(``-metrics`` turns it on for a CLI run, :func:`enable` for a library
caller). A span records its name, its start and end on
``time.monotonic_ns()`` (CLOCK_MONOTONIC), the span that caused it (its
parent) and the window it belongs to; per-name totals (calls, seconds and
the seconds no child span covers) are kept besides, and the records go into
a bounded buffer that counts what it drops. Off, a span costs one attribute
check. While a torch profiler is recording, each span also opens a
``record_function`` of its name, so a profiler trace shows the program's
spans on the profiler's clock.

Each window of the CLI loop has a root span, ``cli.window``, from the
return of the read that completed the window to the end of the emit of its
messages; its layers' spans are its children and share its window index:

- ``cli.read``       the CLI loop's source read (totals only: it fires once a
                     block)
- ``pipeline.stage`` the window's staging: zeroed buffer, carry, copy, the
                     host-to-device enqueue and the carry refresh
- ``frontend.enqueue`` the window program's enqueue (its first in the
                     process is ``setup.first_window``, CUDA's lazy module
                     loads with it); inside it on the card,
                     ``frontend.search_replay``: K1's outputs copied into
                     the search's CUDA graph, its replay and the copy of
                     its packed result, or ``frontend.search_capture``: the
                     graph's capture, once a spec, device and stream
- ``pipeline.fetch_wait`` the wait for the packed result on the host
- ``pipeline.parse`` unpack, escalation, parse, filter and dedup
- ``cli.emit``       encode, ring walk, dump and write of its messages

The wideband decoder's window is a super-step (``parallel/wideband.py``):
its root has

- ``wideband.stage`` the queue's take of the super-step's bytes, their u16
                     view and the host-to-device enqueue (pageable)
- ``wideband.step``  K2's launch into the staged batch and the N channels'
                     window programs' enqueue (``frontend.search_replay``
                     and K1 inside)
- ``wideband.fetch_wait`` the wait for the (N, P) packed results on the host
- ``wideband.parse`` the N channels' ``pipeline.parse`` and the optional
                     cross-channel dedup
- ``wideband.poll``  a feed's query that found the super-step's results
                     landed on the host, when that completed it (not when the
                     next dispatch or a flush did)
- ``cli.emit``

Under dispatch-ahead (the throughput preset) a super-step completes in the
first feed whose poll finds its results on the host, and its root closes
once its messages are emitted there. A ``WindowDecoder`` window completes
when the next one is dispatched, in the next feed that completes a window:
its root then includes the hold of one window's airtime. With ``-latency``
each window completes in its own feed.

A window's look-ahead (``WindowDecoder``'s search of the next window's
first blocks) runs outside the windows' roots: ``frontend.lookahead_replay``
(or ``frontend.lookahead_capture``) enqueues its search once the window's
buffer has left, and ``pipeline.lookahead``, in a later feed, fetches,
unpacks and resolves it, entered once a window whose look-ahead resolves
blocks; the parse of those blocks, in the feeds that bring them, has no
span.

Set-up has ``setup.device_init`` (the CUDA context of each card) and
``setup.kernel_load`` (each CUDA library: dlopen, or ``nvcc`` first).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

log = logging.getLogger("rtlamr_tpu_torch")


@dataclass
class Metrics:
    """Counters at the decoder's layer boundaries (the reference has none)."""

    started: float = field(default_factory=time.monotonic)
    samples_in: int = 0
    windows_decoded: int = 0
    messages_out: int = 0
    messages_dropped_filter: int = 0
    messages_dropped_dup: int = 0
    hit_overflows: int = 0
    #: windows completed by a poll that found their fetch landed, before
    #: the next dispatch (``WidebandDecoder.poll``); a decoder's own count,
    #: so not among the :meth:`counters` that sum across decoders
    windows_polled: int = 0
    extra: Dict[str, float] = field(default_factory=dict)

    def elapsed(self) -> float:
        return time.monotonic() - self.started

    def counters(self) -> Dict[str, float]:
        """Every count and total, which sum across decoders."""
        return {
            "samples_in": self.samples_in,
            "windows_decoded": self.windows_decoded,
            "messages_out": self.messages_out,
            "messages_dropped_filter": self.messages_dropped_filter,
            "messages_dropped_dup": self.messages_dropped_dup,
            "hit_overflows": self.hit_overflows,
            **self.extra,
        }

    def snapshot(self) -> Dict[str, float]:
        return {"elapsed_s": round(self.elapsed(), 3), **self.counters()}


class RateWatchdog:
    """Warn when the receive rate drops below 90% of the configured sample
    rate, checked at 1 Hz (main.go:161,189-196)."""

    def __init__(self, sample_rate: int, warn=None):
        self.sample_rate = sample_rate
        self.warn = warn or (lambda msg: log.warning(msg))
        self._last_tick = time.monotonic()
        self._bytes = 0

    def add_bytes(self, n: int) -> None:
        self._bytes += n
        now = time.monotonic()
        if now - self._last_tick >= 1.0:
            rate = self._bytes >> 1  # bytes -> samples
            if rate < self.sample_rate * 9 // 10:
                self.warn(f"not keeping up with sample stream rate={rate}")
            self._bytes = 0
            self._last_tick = now


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace capture around the decode loop: host and CUDA
    activity, written as a Chrome trace (``trace.json``) into ``log_dir``.
    No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- the tracer ---------------------------------------------------------------

#: the root span of each window of the CLI loop
WINDOW = "cli.window"
#: spans kept as totals only, never as records
TOTALS_ONLY = frozenset({"cli.read"})
#: the name of the first span of a name in the process
FIRST = {"frontend.enqueue": "setup.first_window"}
#: records the buffer holds; a traced benchmark run makes about 7 a window
CAPACITY = 1 << 16


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    #: the name of the span that caused it, None at the top
    parent: Optional[str]
    #: the stream index of its window, -1 for none
    window: int


class Snapshot(NamedTuple):
    """The tracer at one moment: records appended so far, and name ->
    (calls, total ns, self ns: the part no child span covers)."""

    seq: int
    totals: Dict[str, Tuple[int, int, int]]


_profiling = torch._C._autograd._profiler_enabled


class _Span:
    """An open span (a context manager); also an open window's root."""

    __slots__ = ("tracer", "name", "window", "parent", "start", "child_ns", "rf")

    def __init__(self, tracer: "Tracer", name: str, window: int, start: int = 0):
        self.tracer, self.name, self.window, self.start = tracer, name, window, start
        self.parent: Optional[_Span] = None
        self.child_ns = 0
        self.rf = None

    def _open_profiled(self) -> None:
        if _profiling():
            from torch.autograd.profiler import record_function

            self.rf = record_function(self.name)
            self.rf.__enter__()

    def __enter__(self) -> "_Span":
        t = self.tracer
        stack = t._stack
        if stack:
            self.parent = stack[-1]
            if self.window < 0:
                self.window = self.parent.window
        elif self.window >= 0:
            self.parent = t._root(self.window)
        if self.name in t._first:
            self.name = t._first.pop(self.name)
        self._open_profiled()
        stack.append(self)
        if not self.start:
            self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer._stack.pop()
        self._close(time.monotonic_ns())

    def _close(self, end: int) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        t = self.tracer
        tot = t.totals.get(self.name)
        if tot is None:
            tot = t.totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child_ns
        if self.name not in TOTALS_ONLY:
            t.records.append(Record(self.name, self.start, end,
                                    None if parent is None else parent.name, self.window))
            t.seq += 1


class Tracer:
    """Spans, their per-name totals and a bounded buffer of their records
    (the oldest go first once it is full; :attr:`dropped` counts them)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self.reset()

    def reset(self) -> None:
        """Forget every record and total; the next ``frontend.enqueue`` is
        ``setup.first_window`` again."""
        self.records: deque = deque(maxlen=self.capacity)
        self.seq = 0
        self.totals: Dict[str, List[int]] = {}
        self._stack: List[_Span] = []
        self._first = dict(FIRST)
        self._roots: Dict[int, _Span] = {}
        self._read_end = 0

    @property
    def dropped(self) -> int:
        return max(0, self.seq - self.capacity)

    # -- the windows' roots: opened at their first child, at the last read's
    # return; closed by the CLI loop once their messages are emitted.

    def read_returned(self) -> None:
        """A source read returned now: a window dispatched before the next
        read starts its root span here."""
        self._read_end = time.monotonic_ns()

    def _root(self, window: int) -> Optional[_Span]:
        root = self._roots.get(window)
        if root is None and self._read_end:
            root = self._roots[window] = _Span(self, WINDOW, window, self._read_end)
            root._open_profiled()
        return root

    def last_completed(self, n: int) -> int:
        """The window of the last of the ``n`` oldest open roots (the windows
        completed since the last read), -1 when none is open."""
        roots = list(itertools.islice(self._roots, n))
        return roots[-1] if roots else -1

    def close_windows(self, n: int) -> None:
        """Close the ``n`` oldest open roots now."""
        end = time.monotonic_ns()
        for w in list(itertools.islice(self._roots, n)):
            self._roots.pop(w)._close(end)

    def end_windows(self) -> None:
        """Drop the roots still open, unrecorded (a CLI run ends)."""
        for root in self._roots.values():
            if root.rf is not None:
                root.rf.__exit__(None, None, None)
        self._roots.clear()
        self._read_end = 0

    # -- reading

    def snapshot(self) -> Snapshot:
        return Snapshot(self.seq, {k: tuple(v) for k, v in self.totals.items()})

    def between(self, a: Snapshot, b: Optional[Snapshot] = None
                ) -> Tuple[Dict[str, Tuple[int, int, int]], List[Record]]:
        """Totals from snapshot ``a`` to ``b`` (now when None), and the
        records appended between them that the buffer still holds."""
        b = b or self.snapshot()
        totals = {}
        for k, (calls, total, own) in b.totals.items():
            c0, t0, s0 = a.totals.get(k, (0, 0, 0))
            if calls > c0:
                totals[k] = (calls - c0, total - t0, own - s0)
        first = self.seq - len(self.records)
        lo, hi = max(a.seq, first) - first, max(b.seq, first) - first
        return totals, list(itertools.islice(self.records, lo, hi))

    def summary(self, a: Snapshot) -> List[str]:
        """Lines for ``-metrics``: each span since ``a`` (calls, total ms,
        ms a call), then the windows' turnaround."""
        totals, records = self.between(a)
        lines = [f"{'span':<22}{'calls':>9}{'total_ms':>14}{'ms_per_call':>13}"]
        for name in sorted(totals):
            calls, total, _ = totals[name]
            lines.append(f"{name:<22}{calls:>9}{total / 1e6:>14.3f}{total / 1e6 / calls:>13.4f}")
        turn = sorted((r.end_ns - r.start_ns) / 1e6 for r in records if r.name == WINDOW)
        if turn:
            lines.append(f"turnaround_ms ({WINDOW}, {len(turn)} windows): "
                         f"p50 {percentile(turn, 50):.3f} p95 {percentile(turn, 95):.3f} "
                         f"max {turn[-1]:.3f}")
        if self.dropped:
            lines.append(f"records dropped: {self.dropped}")
        return lines


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of ``values``, sorted ascending, with
    linear interpolation between the closest ranks."""
    pos = (len(values) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


#: the process's tracer
TRACER = Tracer()
_OFF = contextlib.nullcontext()


def span(name: str, window: int = -1, since: int = 0):
    """A span of ``name`` in window ``window`` (-1: its parent's), to use in
    a ``with``; it starts at ``since`` (a :func:`stamp`) when given, else at
    its entry. A shared no-op context while the tracer is off."""
    if TRACER.on:
        return _Span(TRACER, name, window, since)
    return _OFF


def stamp() -> int:
    """``time.monotonic_ns()`` while the tracer is on, else 0."""
    return time.monotonic_ns() if TRACER.on else 0


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False
