"""The whole-band cell's readers: the four ``wideband.*`` span readers and
the turnaround read a number on a traced run of the test-only wideband
cell and None on the narrowband one; ``k2_roofline`` reads K2's bound on
the run's super-step over its launches' device time, and None without a
K2 launch, a super-step shape or a card."""

import pytest

from conftest import tiny, wide_tiny
from gpubench import catalog, yardstick
from gpubench.trace import TraceData

SEED = 3_240_000_029
WIDEBAND = ["wideband.stage_ms_per_step", "wideband.step_ms_per_step",
            "wideband.fetch_wait_ms_per_step", "wideband.parse_ms_per_step"]
READERS = WIDEBAND + ["cli.turnaround_ms_p95", "k2_roofline"]


@pytest.fixture
def one_thread():
    """One torch thread for the run: beside other test workers, a thread
    per core each makes a CPU window program take seconds."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traced(cell, run_tiny):
    """The readers' values on a traced run of ``cell``, with ``-latency``:
    a feed then takes at most one window, so windows close all through
    the host phase however slow the CPU is."""
    cell.per_layer = list(READERS)
    cell.units.update({m: unit(m) for m in READERS})
    if "-latency" not in cell.traffic["flags"]:
        cell.traffic["flags"] = ["-latency"] + cell.traffic["flags"]
    res = run_tiny(cell, seed=SEED, seconds=4.0, trace=True)
    assert res["correct"], res["checks"]
    return {k: v["value"] for k, v in res["metrics"].items()}


def unit(metric):
    return next(m["unit"] for m in catalog.load_benchmark()["per_layer"] if m["name"] == metric)


def test_readers_on_a_traced_wideband_run(run_tiny, one_thread):
    got = traced(wide_tiny("parallel"), run_tiny)
    for m in WIDEBAND + ["cli.turnaround_ms_p95"]:
        assert m in got and got[m] > 0, (m, got)
    # the super-step's root holds its four spans (and the emit)
    assert sum(got[m] for m in WIDEBAND) < got["cli.turnaround_ms_p95"] * 2
    # no K2 kernel on the CPU: no roofline
    assert "k2_roofline" not in got


def test_readers_on_a_traced_narrowband_run(run_tiny, one_thread):
    got = traced(tiny("nb_all.live16"), run_tiny)
    assert "cli.turnaround_ms_p95" in got
    assert not set(got) & set(WIDEBAND + ["k2_roofline"])


def k2_data(shape=(12, 8, 64 * 8192), runs=(3.2e-5, 3.4e-5)):
    d = TraceData()
    d.kernels = [("void channelize_kernel<12, 12, 8>(unsigned short const*)", 0, 1.0, 1.0 + t)
                 for t in runs]
    d.kernels.append(("void decode_stencil_kernel<4>(unsigned short const*)", 0, 2.0, 2.5))
    if shape is not None:
        d.reference = {"k2_shape": shape}
    d.card = {"sms": 132, "clock_max_mhz": 1980.0}
    return d


def test_k2_roofline_reads_the_bound_over_the_mean_launch():
    mod = catalog.reader("metrics", "k2_roofline")
    assert mod.SPANS == ()
    d = k2_data()
    rate = yardstick.card_rate(yardstick.FP32_INSTR_PER_CLOCK_PER_SM, d.card)
    bound = yardstick.channelizer_work(12, 8, 64 * 8192, rate)["bound_ms"]
    assert mod.read(d) == pytest.approx(100.0 * bound / 0.033)
    # a 1024-block super-step of twelve channels: the published K2 bound
    big = k2_data(shape=(12, 8, 1024 * 8192), runs=(0.45052e-3,))
    assert mod.read(big) == pytest.approx(100.0 * 0.29889 / 0.45052, rel=1e-3)


@pytest.mark.parametrize("missing", ["kernel", "shape", "card"])
def test_k2_roofline_none_without_its_inputs(missing):
    mod = catalog.reader("metrics", "k2_roofline")
    d = k2_data(shape=None if missing == "shape" else (12, 8, 64 * 8192))
    if missing == "kernel":
        d.kernels = d.kernels[-1:]
    if missing == "card":
        d.card = {}
    assert mod.read(d) is None
    assert mod.read(TraceData()) is None
