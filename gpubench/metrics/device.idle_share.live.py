"""100% less the share of the profiled sub-window in which a kernel or a
copy ran on the card (the union of their intervals), averaged over the
cards the cell uses."""

from . import idle_share

SPANS = ()


def read(data):
    return idle_share(data)
