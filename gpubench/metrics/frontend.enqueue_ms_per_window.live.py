"""Host ms inside ``decode_window_staged_packed`` (the enqueue of the
window program: K1 and the search's kernels), a window."""

from . import DISPATCH, ENQUEUE, per_call

SPANS = (ENQUEUE, DISPATCH)


def read(data):
    return per_call(data.host, ENQUEUE, DISPATCH)
