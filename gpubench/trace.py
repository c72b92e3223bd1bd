"""The traced run: host spans over the window and a torch.profiler trace of
a short steady part of it (the sub-window), reduced to what the per-layer
readers of ``metrics/`` take.

A traced run has two phases. Over the measured window, as an untraced run
has it, the spans of ``spans.py`` time the host layers. When the window's
seconds are up (at the next source read) the profiler starts, and it stops
``trace_seconds`` after it is up (again at a source read); the run then
ends. The host metrics
take the first phase, the device metrics the second: kernels launch more
slowly while the profiler records. The process's first
profiler session loads and starts the device tracer, which takes seconds;
set-up runs it (:meth:`SubWindow.warm`), so the start on the CLI's thread
holds the read for a fraction of a second and the receiver's ingest ring
does not fill meanwhile. Each profiler session opens with ``OPENERS`` spin
kernels on each card, which the reduction leaves out: a session of an
older process can lose its first kernels' records.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats
from .spans import HostTimer, between

#: spin kernels that open each session, and their clock cycles (about 1 ms)
OPENERS, OPENER_CYCLES = 8, 2_000_000
#: the spin kernel's name in the profiler's record
OPENER_KERNEL = "spin_kernel"
#: the record_function that marks the profiled sub-window
MARK = "gpubench.traced_window"
#: label of device idle time while no span of the main thread was open
NO_SPAN = "outside_spans"


@dataclass
class TraceData:
    """What the readers of ``metrics/`` read."""

    #: span -> (seconds, calls) over the host phase of the window
    host: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    #: span -> (seconds, calls) over the profiled sub-window
    profiled: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    #: (name, device, start_s, end_s) of every kernel in the sub-window
    kernels: List[Tuple[str, int, float, float]] = field(default_factory=list)
    #: device -> seconds an operation ran on it in the sub-window
    busy_s: Dict[int, float] = field(default_factory=dict)
    window_s: float = 0.0
    #: what the reference computed, for the roofline readers
    reference: Dict[str, object] = field(default_factory=dict)
    #: {"sms", "clock_max_mhz"} of card 0
    card: Dict[str, float] = field(default_factory=dict)
    breakdown: Dict[str, list] = field(default_factory=dict)


class SubWindow:
    """Starts and stops the profiler from the CLI loop's own thread, at the
    reads that ``tick`` is called from."""

    def __init__(self, timer: HostTimer, devices: Sequence[int]):
        self.timer = timer
        self.devices = list(devices)
        self.prof = None
        self._mark = None
        self.host_from: Optional[dict] = None
        self.prof_from: Optional[dict] = None
        self.prof_to: Optional[dict] = None
        self.started = self.stopped = False
        #: when the profiler was up and its spin kernels done
        self.t_up = 0.0

    def open_window(self) -> None:
        """The window opens: the host phase starts."""
        if self.host_from is None:
            self.host_from = self.timer.snapshot()

    def _session(self):
        """A profiler session, entered and opened by the spin kernels."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        for d in self.devices:
            torch.cuda.synchronize(d)
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.devices else [])
        prof = profile(activities=activities)
        prof.__enter__()
        for d in self.devices:
            with torch.cuda.device(d):
                for _ in range(OPENERS):
                    torch.cuda._sleep(OPENER_CYCLES)
        for d in self.devices:
            torch.cuda.synchronize(d)
        return prof

    def warm(self) -> None:
        """A throwaway session, in set-up: the process's first one starts
        the device tracer."""
        self._session().__exit__(None, None, None)

    def start(self) -> None:
        from torch.profiler import record_function

        self.started = True
        self.prof_from = self.timer.snapshot()
        self.prof = self._session()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.t_up = time.monotonic()

    def stop(self) -> None:
        import torch

        if not self.started or self.stopped:
            return
        self.stopped = True
        self._mark.__exit__(None, None, None)
        self.prof_to = self.timer.snapshot()
        for d in self.devices:
            torch.cuda.synchronize(d)
        self.prof.__exit__(None, None, None)

    def reduce(self, span_names: Sequence[str]) -> TraceData:
        """The host phase's spans and the sub-window's device record."""
        from torch.autograd import DeviceType

        out = TraceData()
        out.host = between(self.host_from or {}, self.prof_from or self.timer.snapshot())
        if self.prof is None:
            return out
        out.profiled = between(self.prof_from, self.prof_to)
        events = self.prof.events()
        marks = [e for e in events if e.name == MARK]
        if not marks:
            return out
        lo, hi = marks[0].time_range.start / 1e6, marks[0].time_range.end / 1e6
        out.window_s = hi - lo
        busy = defaultdict(list)
        by_name = defaultdict(float)
        main_thread = marks[0].thread
        names = set(span_names)
        host = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name) for e in events
                if e.device_type == DeviceType.CPU and e.name in names and e.thread == main_thread]
        for e in events:
            # record_function ranges also appear on the device's timeline as
            # annotations; they are not work.
            if (e.device_type != DeviceType.CUDA or OPENER_KERNEL in e.name
                    or e.name in names or e.name == MARK
                    or getattr(e, "is_user_annotation", False)):
                continue
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if b <= lo or a >= hi:
                continue
            busy[e.device_index].append((a, b))
            by_name[e.name] += min(b, hi) - max(a, lo)
            if not e.name.startswith(("Memcpy", "Memset")):
                out.kernels.append((e.name, e.device_index, a, b))
        segments = stats.innermost_segments(host, lo, hi, NO_SPAN)
        gaps_by_label = defaultdict(float)
        for d in self.devices:
            out.busy_s[d] = stats.union_length(busy.get(d, []), lo, hi)
            gaps = stats.idle_gaps(busy.get(d, []), lo, hi)
            for label, s in stats.overlap_by_label(gaps, segments).items():
                gaps_by_label[label] += s / len(self.devices)
        out.breakdown = {
            "device_ops": [[n[:120], s] for n, s in sorted(by_name.items(), key=lambda t: -t[1])[:10]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps_by_label.items(), key=lambda t: -t[1])[:10]],
        }
        return out
