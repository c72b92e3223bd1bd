"""Per-layer metrics, one reader a file, named as the metric.

Each ``<metric>.py`` defines ``SPANS``, the host spans it needs (the
harness installs the union over a cell's metrics in its traced run), and
``read(data)``, which takes a :class:`gpubench.trace.TraceData` and returns
the metric's value, or None when the run has nothing for it to read (the
harness then leaves the metric out of the result line). A share of a
roofline is never 0 by default: no kernel seen means None.
"""

PIPELINE = "rtlamr_tpu_torch.decoder.pipeline"

FEED = PIPELINE + ":WindowDecoder.feed"
ENQUEUE = PIPELINE + ":decode_window_staged_packed"
COMPLETE = PIPELINE + ":WindowDecoder._complete_inflight"
DISPATCH = PIPELINE + ":WindowDecoder.process_host_staged"


def per_call(spans, name, divisor):
    """Host ms of span ``name`` per call of span ``divisor``; None when
    neither ran."""
    from ..spans import short_name

    s = spans.get(short_name(name))
    d = spans.get(short_name(divisor))
    if s is None or d is None or d[1] == 0:
        return None
    return s[0] * 1e3 / d[1]


def idle_share(data):
    """100 - the busy share of the sub-window, averaged over the cards."""
    if not data.busy_s or data.window_s <= 0:
        return None
    busy = sum(data.busy_s.values()) / len(data.busy_s)
    return 100.0 * (1.0 - busy / data.window_s)


def mean_kernel_s(data, name: str):
    """Mean device seconds of the kernels whose name holds ``name``."""
    runs = [b - a for k, _, a, b in data.kernels if name in k]
    return sum(runs) / len(runs) if runs else None
