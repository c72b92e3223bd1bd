"""The readers of the receiver's own spans (``program_spans.py`` and the
eight metrics that read it) on synthetic traces, and the hook that
snapshots the receiver's tracer beside the host spans of a traced run."""

import pytest

from gpubench import catalog, program_spans
from gpubench.program_spans import WINDOW, Phase
from gpubench.trace import TraceData

PER_WINDOW = {
    "pipeline.stage_ms_per_window": "pipeline.stage",
    "pipeline.fetch_wait_ms_per_window": "pipeline.fetch_wait",
    "pipeline.parse_ms_per_window": "pipeline.parse",
    "cli.emit_ms_per_window": "cli.emit",
}
SETUP = {
    "setup.device_init_s": "setup.device_init",
    "setup.kernel_load_s": "setup.kernel_load",
    "setup.first_window_s": "setup.first_window",
}


def synthetic(windows_ms):
    d = TraceData()
    spans = {"pipeline.stage": (len(windows_ms), 0.018, 0.018),
             "pipeline.fetch_wait": (len(windows_ms), 0.002, 0.002),
             "pipeline.parse": (len(windows_ms), 0.005, 0.005),
             "cli.emit": (len(windows_ms), 0.001, 0.001)}
    if windows_ms:
        spans[WINDOW] = (len(windows_ms), sum(windows_ms) / 1e3, 0.004)
    d.program_host = Phase(spans, list(windows_ms))
    d.program_setup = Phase({"setup.device_init": (1, 0.4, 0.4),
                             "setup.kernel_load": (1, 0.05, 0.05),
                             "setup.first_window": (1, 1.25, 1.2)})
    return d


@pytest.mark.parametrize("metric", sorted(PER_WINDOW))
def test_per_window_readers(metric):
    mod = catalog.reader("metrics", metric)
    assert mod.SPANS == ()
    d = synthetic([14.0] * 10)
    assert mod.read(d) == pytest.approx(d.program_host.spans[PER_WINDOW[metric]][1] * 1e3 / 10)
    assert mod.read(synthetic([])) is None
    assert mod.read(TraceData()) is None


def test_turnaround_p95():
    mod = catalog.reader("metrics", "cli.turnaround_ms_p95")
    assert mod.read(synthetic([float(v) for v in range(1, 102)])) == pytest.approx(96.0)
    assert mod.read(synthetic([])) is None
    assert mod.read(TraceData()) is None


@pytest.mark.parametrize("metric", sorted(SETUP))
def test_setup_readers(metric):
    mod = catalog.reader("metrics", metric)
    d = synthetic([14.0])
    calls, total, own = d.program_setup.spans[SETUP[metric]]
    # the first window is read less the kernel loads inside it
    assert mod.read(d) == pytest.approx(own if metric == "setup.first_window_s" else total)
    d.program_setup = Phase()
    assert mod.read(d) is None
    assert mod.read(TraceData()) is None


def test_hook_snapshots_the_tracer_by_phase():
    """A SubWindow on the CPU turns the tracer on when made; spans before
    window open are set-up, then the host phase, then the profiled one."""
    from rtlamr_tpu_torch.utils import observability
    from rtlamr_tpu_torch.utils.observability import TRACER, span

    from gpubench.spans import HostTimer
    from gpubench.trace import SubWindow

    program_spans.install()
    TRACER.reset()
    try:
        sub = SubWindow(HostTimer(), [])
        assert TRACER.on
        with span("setup.device_init"):
            pass
        sub.open_window()
        for w in range(3):
            TRACER.read_returned()
            with span("pipeline.stage", w):
                pass
            TRACER.close_windows(1)
        sub.start()
        with span("pipeline.stage", 3):
            pass
        sub.stop()
        data = sub.reduce([])
    finally:
        observability.disable()
        TRACER.reset()
    assert set(data.program_setup.spans) == {"setup.device_init"}
    assert data.program_host.spans["pipeline.stage"][0] == 3
    assert len(data.program_host.windows_ms) == 3 and data.program_host.spans[WINDOW][0] == 3
    assert data.program_profiled.spans["pipeline.stage"][0] == 1
    assert program_spans.per_window_ms(data, "pipeline.stage") is not None
