"""Seconds in the receiver's ``setup.first_window`` span before window
open, less the kernel loads inside it: the process's first enqueue of the
window program, with CUDA's lazy module loads."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.setup_seconds(data, "setup.first_window", own=True)
