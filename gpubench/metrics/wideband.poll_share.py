"""The share, in %, of the super-steps dispatched in the host phase that a
feed's poll completed, once their results were on the host, before the
next dispatch: 100 x calls of the receiver's ``wideband.poll`` span over
calls of its ``wideband.step`` span. A receiver with no such span reads
nothing."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    host = getattr(data, "program_host", None)
    if host is None:
        return None
    poll = host.spans.get("wideband.poll")
    step = host.spans.get("wideband.step")
    if poll is None or step is None:
        return None
    return 100.0 * poll[0] / step[0]
