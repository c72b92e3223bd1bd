"""CUDA kernels the profiler records in the sub-window, a window
dispatched in it: in a narrowband cell every kernel is the window
program's (K1 and the search); copies are not kernels."""

from . import DISPATCH

SPANS = (DISPATCH,)


def read(data):
    from ..spans import short_name

    windows = data.profiled.get(short_name(DISPATCH), (0.0, 0))[1]
    if windows == 0 or not data.kernels:
        return None
    return len(data.kernels) / windows
