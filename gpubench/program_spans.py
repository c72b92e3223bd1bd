"""The receiver's own spans (``rtlamr_tpu_torch.utils.observability``'s
tracer) in the traced run, for the per-layer readers that import this
module.

:func:`install` makes the traced run's :class:`gpubench.trace.SubWindow`
turn the tracer on when it is made, before the warm-up call, and snapshot
it where it snapshots its host spans: at window open, at the profiler's
start and at its stop. Its ``reduce`` then gives the
:class:`~gpubench.trace.TraceData` three more attributes, each a
:class:`Phase`:

- ``program_setup``: from the tracer's start to window open (set-up);
- ``program_host``: window open to the profiler's start (the host phase);
- ``program_profiled``: the profiled sub-window.

A receiver without the tracer leaves them out, and the readers return None.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: the root span of each window of the CLI loop
WINDOW = "cli.window"


@dataclass
class Phase:
    """The tracer's spans over one phase of the run."""

    #: span -> (calls, seconds, seconds no child span covers)
    spans: Dict[str, Tuple[int, float, float]] = field(default_factory=dict)
    #: the ms of each window's root span that closed in the phase
    windows_ms: List[float] = field(default_factory=list)


def _observability():
    """The receiver's tracer module, None when it has no tracer."""
    try:
        from rtlamr_tpu_torch.utils import observability
    except ImportError:
        return None
    if not hasattr(observability, "TRACER") or not hasattr(observability, "enable"):
        return None
    return observability


def phase(tracer, a, b=None) -> Phase:
    """The tracer's spans from snapshot ``a`` to ``b`` (now when None)."""
    totals, records = tracer.between(a, b)
    return Phase({k: (c, t / 1e9, s / 1e9) for k, (c, t, s) in totals.items()},
                 [(r.end_ns - r.start_ns) / 1e6 for r in records if r.name == WINDOW])


def install() -> None:
    """Hook :class:`gpubench.trace.SubWindow` to the receiver's tracer
    (once; nothing when the receiver has none)."""
    from . import trace

    sub = trace.SubWindow
    obs = _observability()
    if obs is None or getattr(sub, "_program_spans", False):
        return
    sub._program_spans = True
    tracer = obs.TRACER
    init, open_window, start, stop, reduce = (
        sub.__init__, sub.open_window, sub.start, sub.stop, sub.reduce)

    def init_(self, *args, **kwargs):
        init(self, *args, **kwargs)
        obs.enable()
        self.program = {"enabled": tracer.snapshot()}

    def open_window_(self):
        if self.host_from is None:
            self.program["open"] = tracer.snapshot()
        open_window(self)

    def start_(self):
        self.program["start"] = tracer.snapshot()
        start(self)

    def stop_(self):
        if self.started and not self.stopped:
            self.program["stop"] = tracer.snapshot()
        stop(self)

    def reduce_(self, span_names):
        out = reduce(self, span_names)
        p = self.program
        if "open" in p:
            out.program_setup = phase(tracer, p["enabled"], p["open"])
            out.program_host = phase(tracer, p["open"], p.get("start"))
        if "stop" in p:
            out.program_profiled = phase(tracer, p["start"], p["stop"])
        return out

    sub.__init__, sub.open_window, sub.start, sub.stop, sub.reduce = (
        init_, open_window_, start_, stop_, reduce_)


def per_window_ms(data, name: str) -> Optional[float]:
    """Host ms of span ``name`` a window closed in the host phase; None when
    no window closed or the span never ran."""
    host: Optional[Phase] = getattr(data, "program_host", None)
    if host is None or name not in host.spans or WINDOW not in host.spans:
        return None
    return host.spans[name][1] * 1e3 / host.spans[WINDOW][0]


def setup_seconds(data, name: str, own: bool = False) -> Optional[float]:
    """Seconds of span ``name`` before window open (``own``: less its child
    spans); None when it never ran."""
    setup: Optional[Phase] = getattr(data, "program_setup", None)
    if setup is None or name not in setup.spans:
        return None
    return setup.spans[name][2 if own else 1]
