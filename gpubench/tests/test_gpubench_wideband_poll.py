"""``wideband.poll_share`` reads a share on a traced run of the test-only
wideband cell in the throughput preset (256 KiB reads, dispatch-ahead), and
nothing on a narrowband run, which has no super-step."""

import pytest

from conftest import tiny, wide_tiny
from gpubench import catalog

SEED = 3_250_000_041
METRIC = "wideband.poll_share"


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
    cell.per_layer = [METRIC, "wideband.step_ms_per_step"]
    cell.units.update({m["name"]: m["unit"] for m in catalog.load_benchmark()["per_layer"]
                       if m["name"] in cell.per_layer})
    res = run_tiny(cell, seed=SEED, seconds=4.0, trace=True)
    assert res["correct"], res["checks"]
    return {k: v["value"] for k, v in res["metrics"].items()}


def test_poll_share_on_a_traced_wideband_run(run_tiny, one_thread):
    cell = wide_tiny("parallel")
    assert "-latency" not in cell.traffic["flags"]
    got = traced(cell, run_tiny)
    # a 256 KiB read holds four 16-block super-steps of the test stream: the
    # next read's poll completes the last of them, the dispatches the rest
    assert 0 < got[METRIC] <= 100 and got["wideband.step_ms_per_step"] > 0, got


def test_poll_share_none_on_a_narrowband_run(run_tiny, one_thread):
    got = traced(tiny("nb_all.live16"), run_tiny)
    assert METRIC not in got


def test_poll_share_reads_the_spans():
    mod = catalog.reader("metrics", METRIC)
    assert mod.SPANS == ()

    class Host:
        spans = {"wideband.step": (40, 0.2, 0.1), "wideband.poll": (38, 0.001, 0.001)}

    class Data:
        program_host = Host()

    assert mod.read(Data()) == pytest.approx(95.0)
    del Host.spans["wideband.poll"]
    assert mod.read(Data()) is None  # the parent: no such span
    assert mod.read(object()) is None
