"""Seconds in the receiver's ``setup.device_init`` span before window
open: the CUDA context of each card, made once when the decoder resolves
its device."""

from .. import program_spans

SPANS = ()
program_spans.install()


def read(data):
    return program_spans.setup_seconds(data, "setup.device_init")
