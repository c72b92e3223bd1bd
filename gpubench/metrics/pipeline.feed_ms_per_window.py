"""Host ms inside ``WindowDecoder.feed`` less the window program's enqueue
and the completion of the previous window, a window: the feed path's
buffer copies, staging and host-to-device copy."""

from . import COMPLETE, DISPATCH, ENQUEUE, FEED, per_call

SPANS = (FEED, ENQUEUE, COMPLETE, DISPATCH)


def read(data):
    parts = [per_call(data.host, s, DISPATCH) for s in (FEED, ENQUEUE, COMPLETE)]
    if None in parts:
        return None
    return parts[0] - parts[1] - parts[2]
