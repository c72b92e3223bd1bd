"""The 50th percentile over every planted packet whose last sample was due
in the window of (the time its message line was written) less (the time
the feeder was due to send that sample's block), in ms. A packet never
emitted counts as over any limit."""

from ..stats import percentile


def read(run):
    return run.latency_value(percentile(run.latencies_ms, 50))
