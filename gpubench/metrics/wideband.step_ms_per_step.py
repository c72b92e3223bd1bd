"""Host ms of the receiver's ``wideband.step`` span a super-step closed in
the host phase: K2's launch into the staged batch and the enqueue of the N
channels' window programs. None in a one-channel run, which has no
super-step."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "wideband.step")
