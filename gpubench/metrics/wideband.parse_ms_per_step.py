"""Host ms of the receiver's ``wideband.parse`` span a super-step closed in
the host phase: the N channels' parse of their rows (unpack, escalation,
parse, filter and dedup). None in a one-channel run, which has no
super-step."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "wideband.parse")
