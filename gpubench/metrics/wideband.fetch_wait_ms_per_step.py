"""Host ms of the receiver's ``wideband.fetch_wait`` span a super-step closed
in the host phase: the wait for the super-step's (N, P) packed results on
the host. None in a one-channel run, which has no super-step."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "wideband.fetch_wait")
