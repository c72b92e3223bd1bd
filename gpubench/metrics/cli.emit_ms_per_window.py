"""Host ms of the receiver's ``cli.emit`` span a window closed in the host
phase: encode, ring walk, dump and write of the messages (one span an
iteration of the CLI loop that completed a window)."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.per_window_ms(data, "cli.emit")
