"""Host ms of the receiver's ``pipeline.stage`` span a window closed in the
host phase: the window's staging where it happens (zeroed buffer, carry,
copy, the host-to-device enqueue and the carry refresh), without the
window program's enqueue."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "pipeline.stage")
