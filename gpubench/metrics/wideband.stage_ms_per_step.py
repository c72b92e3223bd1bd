"""Host ms of the receiver's ``wideband.stage`` span a super-step closed in
the host phase: the queue's take of the super-step's bytes, their u16 view
and the pageable host-to-device enqueue. None in a one-channel run, which
has no super-step."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "wideband.stage")
