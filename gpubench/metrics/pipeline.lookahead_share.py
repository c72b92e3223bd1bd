"""The share, in %, of the window program's enqueues in the host phase
whose look-ahead emitted blocks: 100 x calls of the receiver's
``pipeline.lookahead`` span over calls of its ``frontend.enqueue`` span. A
receiver with no such span reads nothing."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    host = getattr(data, "program_host", None)
    if host is None:
        return None
    ahead = host.spans.get("pipeline.lookahead")
    enqueue = host.spans.get("frontend.enqueue")
    if ahead is None or enqueue is None:
        return None
    return 100.0 * ahead[0] / enqueue[0]
