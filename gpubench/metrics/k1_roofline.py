"""K1's share of its roofline: the bound of ``yardstick.stencil_work`` on
the checked window (its shapes, and the reference's own bits for the
preamble bank's count) over the mean device time of K1's launches in the
profiled sub-window, in %."""

from . import mean_kernel_s

SPANS = ()
KERNEL = "decode_stencil_kernel"


def read(data):
    from .. import yardstick

    t = mean_kernel_s(data, KERNEL)
    ref = data.reference
    if t is None or "k1_live_words" not in ref or not data.card:
        return None
    rate = yardstick.card_rate(yardstick.INT32_PER_CLOCK_PER_SM, data.card)
    work = yardstick.stencil_work(ref["k1_geo"], ref["k1_live_words"], rate)
    return 100.0 * work["bound_ms"] / (t * 1e3)
