"""Host ms of the receiver's ``pipeline.fetch_wait`` span a window closed
in the host phase: the wait on the event of the packed result's copy to
the host."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "pipeline.fetch_wait")
