"""Host ms inside ``WindowDecoder._complete_inflight`` (the wait for the
card, the unpack, the parse and dedup), a window."""

from . import COMPLETE, DISPATCH, per_call

SPANS = (COMPLETE, DISPATCH)


def read(data):
    return per_call(data.host, COMPLETE, DISPATCH)
