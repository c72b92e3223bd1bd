"""The reader of ``frontend.search_replay_share`` on synthetic traces: the
share of the host phase's window-program enqueues that replayed the
search's CUDA graph, and nothing from a receiver without that span."""

import pytest

from gpubench import catalog
from gpubench.program_spans import WINDOW, Phase
from gpubench.trace import TraceData


def host_phase(enqueues, replays):
    spans = {WINDOW: (enqueues, enqueues * 0.006, 0.0005),
             "frontend.enqueue": (enqueues, enqueues * 0.0004, enqueues * 0.0003)}
    if replays is not None:
        spans["frontend.search_replay"] = (replays, replays * 0.0001, replays * 0.0001)
    d = TraceData()
    d.program_host = Phase(spans, [6.0] * enqueues)
    return d


@pytest.mark.parametrize("enqueues, replays, share", [
    (360, 360, 100.0),
    (360, 359, 100.0 * 359 / 360),
    (4, 1, 25.0),
])
def test_share_of_replays(enqueues, replays, share):
    mod = catalog.reader("metrics", "frontend.search_replay_share")
    assert mod.SPANS == ()
    assert mod.read(host_phase(enqueues, replays)) == pytest.approx(share)


def test_nothing_without_the_span():
    """The parent of the graph has the tracer but no replay span: no value
    (not 0), and none without the tracer at all."""
    mod = catalog.reader("metrics", "frontend.search_replay_share")
    assert mod.read(host_phase(360, None)) is None
    assert mod.read(TraceData()) is None
    d = TraceData()
    d.program_host = Phase({"frontend.search_replay": (3, 0.001, 0.001)})
    assert mod.read(d) is None
