"""The share, in %, of the window program's enqueues in the host phase that
replayed the search from its CUDA graph: 100 x calls of the receiver's
``frontend.search_replay`` span over calls of its ``frontend.enqueue``
span. A receiver with no such span reads nothing."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    host = getattr(data, "program_host", None)
    if host is None:
        return None
    replay = host.spans.get("frontend.search_replay")
    enqueue = host.spans.get("frontend.enqueue")
    if replay is None or enqueue is None:
        return None
    return 100.0 * replay[0] / enqueue[0]
