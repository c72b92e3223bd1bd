"""The metric arithmetic, from synthetic samples and intervals."""

import math

import pytest

from gpubench import catalog, stats
from gpubench.trace import TraceData


def test_percentile_and_missing():
    v = list(range(1, 101))
    assert stats.percentile(v, 50) == pytest.approx(50.5)
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    # A missing packet is over any limit: enough of them and the tail is inf.
    assert math.isinf(stats.percentile([1.0] * 90 + [math.inf] * 10, 95))
    assert stats.percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0


def test_union_and_gaps():
    spans = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (6.5, 9.0)]
    assert stats.union_length(spans, 0.0, 7.0) == pytest.approx(3.5)
    assert stats.idle_gaps(spans, 0.0, 7.0) == [(0.0, 1.0), (3.0, 5.0), (6.0, 6.5)]
    assert stats.union_length([], 0.0, 1.0) == 0.0


def test_segments_label_gaps_by_innermost_span():
    spans = [(0, 10, "feed"), (2, 5, "enqueue"), (6, 8, "complete")]
    segs = stats.innermost_segments(spans, 0, 12, "outside")
    assert segs == [(0, 2, "feed"), (2, 5, "enqueue"), (5, 6, "feed"), (6, 8, "complete"),
                    (8, 10, "feed"), (10, 12, "outside")]
    assert stats.overlap_by_label([(1, 3), (7, 11)], segs) == {
        "feed": 3.0, "enqueue": 1.0, "complete": 1.0, "outside": 1.0}


def test_idle_share_and_kernels_from_synthetic_trace():
    idle = catalog.reader("metrics", "device.idle_share.live")
    kernels = catalog.reader("metrics", "frontend.kernels_per_window")
    d = TraceData(busy_s={0: 0.25, 1: 0.75}, window_s=2.0)
    assert idle.read(d) == pytest.approx(75.0)
    assert idle.read(TraceData()) is None
    d.kernels = [("k", 0, 0.0, 1e-6)] * 644 * 3
    d.profiled = {"pipeline.WindowDecoder.process_host_staged": (0.1, 3)}
    assert kernels.read(d) == pytest.approx(644.0)


def test_host_span_readers():
    feed = catalog.reader("metrics", "pipeline.feed_ms_per_window")
    enq = catalog.reader("metrics", "frontend.enqueue_ms_per_window.live")
    d = TraceData(host={
        "pipeline.WindowDecoder.feed": (2.0, 640),
        "pipeline.decode_window_staged_packed": (0.5, 10),
        "pipeline.WindowDecoder._complete_inflight": (0.1, 10),
        "pipeline.WindowDecoder.process_host_staged": (0.7, 10),
    })
    assert feed.read(d) == pytest.approx(140.0)
    assert enq.read(d) == pytest.approx(50.0)
    assert feed.read(TraceData()) is None
