"""Host ms of the receiver's ``pipeline.parse`` span a window closed in the
host phase: unpack, escalation, parse, filter and dedup of the window's
result."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "pipeline.parse")
