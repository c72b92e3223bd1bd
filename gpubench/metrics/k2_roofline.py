"""K2's share of its roofline: the bound of ``yardstick.channelizer_work``
on the run's super-step shape (``k2_shape``: channels, taps a branch,
frames) over the mean device time of K2's launches in the profiled
sub-window, in %. None in a one-channel run, which launches no K2."""

from . import mean_kernel_s

SPANS = ()
KERNEL = "channelize_kernel"


def read(data):
    from .. import yardstick

    t = mean_kernel_s(data, KERNEL)
    shape = data.reference.get("k2_shape")
    if t is None or shape is None or not data.card:
        return None
    rate = yardstick.card_rate(yardstick.FP32_INSTR_PER_CLOCK_PER_SM, data.card)
    work = yardstick.channelizer_work(*shape, rate=rate)
    return 100.0 * work["bound_ms"] / (t * 1e3)
