"""Seconds in the receiver's ``setup.kernel_load`` span before window
open: loading each CUDA library of ``ops/build.py`` (dlopen, or nvcc on
a checkout's first run)."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.setup_seconds(data, "setup.kernel_load")
