"""The port's tracer (``rtlamr_tpu_torch/utils/observability.py``): the
spans of the live CLI path and their windows in both presets, the message
stream unchanged by tracing, nothing recorded while it is off, its spans in
a torch.profiler record, the bound of its buffer, what ``-metrics`` prints,
and its host cost a window."""

import contextlib
import io
import re
import socket
import struct
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import CAPACITY, TRACER, WINDOW, span, stamp
from test_torch_cli import FakeRtlTcp

torch.set_num_threads(1)

TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\dT[\d:.]+Z?")
CHIP = 8
BLOCK = build_decoder_config([new_parser("scm", CHIP)]).block_size
#: two of the throughput preset's 256 KiB reads and 2 blocks more: the
#: throughput preset decodes 128 windows of 4 blocks (its last, short read
#: ends the stream), the latency preset those and a partial one it flushes
BLOCKS = 514
WINDOW_BLOCKS = 4
N_WINDOWS = {"throughput": 128, "latency": 129}
PRESETS = {"throughput": [f"-windowblocks={WINDOW_BLOCKS}"],
           "latency": ["-latency", f"-windowblocks={WINDOW_BLOCKS}"]}
N_MESSAGES = 8
#: the spans every window of the single-card path has besides its root
PER_WINDOW = {"pipeline.stage", "pipeline.fetch_wait", "pipeline.parse"}
ENQUEUE = {"frontend.enqueue", "setup.first_window"}
SPANS = PER_WINDOW | ENQUEUE | {WINDOW, "cli.read", "cli.emit"}


class ClosingRtlTcp(FakeRtlTcp):
    """A :class:`FakeRtlTcp` that sends its whole stream at once and then
    ends it: the CLI reads to the end, flushes and exits."""

    def run(self):
        conn, _ = self.sock.accept()
        try:
            conn.sendall(b"RTL0" + struct.pack(">II", 5, 29) + self.iq)
            conn.shutdown(socket.SHUT_WR)
            conn.settimeout(15.0)
            while conn.recv(4096):  # the tuner commands, until the client closes
                pass
        except OSError:
            pass
        finally:
            conn.close()
            self.sock.close()


@pytest.fixture(scope="module")
def iq():
    """SCM packets in several windows of a chip-length-8 stream."""
    bursts = [synth.bits_to_burst(synth.make_scm_bits(meter_id=7000 + k, consumption=k),
                                  BLOCK * (2 + 60 * k)) for k in range(N_MESSAGES)]
    return synth.render_iq(BLOCK * BLOCKS, bursts, CHIP, noise=2.0, seed=11)


@pytest.fixture
def tracer():
    """The process's tracer, empty; left off and empty after the test."""
    TRACER.reset()
    yield TRACER
    observability.disable()
    TRACER.capacity = CAPACITY
    TRACER.reset()


def run_cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, device="cpu")
    assert rc == 0, err.getvalue()
    return TIMESTAMP.sub("<time>", out.getvalue()), err.getvalue()


def live(iq, preset, extra=()):
    server = ClosingRtlTcp(iq)
    server.start()
    try:
        return run_cli(["-msgtype=scm", f"-symbollength={CHIP}", "-format=json",
                        f"-server=127.0.0.1:{server.port}", "-duration=60s",
                        *PRESETS[preset], *extra])
    finally:
        server.join(timeout=20)


def from_file(iq, tmp_path, extra=()):
    path = tmp_path / "cap.bin"
    np.asarray(iq, np.uint8).tofile(path)
    return run_cli(["-msgtype=scm", f"-symbollength={CHIP}", "-format=json",
                    f"-fromfile={path}", *PRESETS["throughput"], *extra])


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_live_windows_and_their_spans(iq, preset, tracer):
    """Each window closes one root span; its children share its index, lie
    inside it and sum to at most it; the message stream is byte-identical
    to an untraced run's."""
    want, _ = live(iq, preset)
    assert tracer.seq == 0 and not tracer.totals
    observability.enable()
    got, _ = live(iq, preset)
    assert got == want and len(got.splitlines()) == N_MESSAGES
    records = list(tracer.records)
    assert tracer.dropped == 0 and tracer.seq == len(records)
    roots = {}
    for r in records:
        if r.name == WINDOW:
            assert r.window not in roots and r.parent is None
            roots[r.window] = r
    assert sorted(roots) == list(range(N_WINDOWS[preset]))
    children = {w: [] for w in roots}
    for r in records:
        if r.parent == WINDOW:
            children[r.window].append(r)
    for w, root in roots.items():
        kids = children[w]
        names = {k.name for k in kids}
        assert PER_WINDOW <= names and len(names & ENQUEUE) == 1, (w, names)
        assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)
        assert sum(k.end_ns - k.start_ns for k in kids) <= root.end_ns - root.start_ns
    assert {r.name for r in records} <= SPANS - {"cli.read"}
    # every emitting iteration has one emit, inside the last window it closes
    assert 1 <= sum(r.name == "cli.emit" for r in records) <= N_WINDOWS[preset]
    assert tracer.totals["cli.read"][0] > 0 and "cli.read" not in {r.name for r in records}
    first = [r for r in records if r.name == "setup.first_window"]
    assert len(first) == 1 and first[0].window == 0
    # the self time of a root is what no child covers
    calls, total, own = tracer.totals[WINDOW]
    assert calls == N_WINDOWS[preset] and 0 <= own <= total


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_spans_under_the_profiler(iq, tmp_path, tracer, on):
    """On, each span is a record_function of the main thread in a profiler's
    record; off, no span is recorded or profiled."""
    if on:
        observability.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.main_thread"):
            from_file(iq[: 2 * BLOCK * 66], tmp_path)
    events = prof.events()
    main_thread = next(e.thread for e in events if e.name == "test.main_thread")
    seen = {e.name for e in events if e.name in SPANS}
    if not on:
        assert not seen and tracer.seq == 0 and not tracer.totals
        return
    assert PER_WINDOW | {WINDOW, "cli.read", "cli.emit", "setup.first_window"} <= seen
    assert all(e.thread == main_thread for e in events if e.name in SPANS)
    assert tracer.seq > 0


def test_off_span_is_one_shared_noop(tracer):
    assert span("pipeline.stage", 3) is span("cli.read") and stamp() == 0
    with span("pipeline.stage", 3):
        pass
    assert tracer.seq == 0 and not tracer.totals


def test_buffer_bound_and_dropped(tracer):
    tracer.capacity = 4
    tracer.reset()
    observability.enable()
    a = tracer.snapshot()
    for w in range(10):
        with span("cli.read"):
            pass
        with span("pipeline.parse", w):
            with span("setup.kernel_load"):
                pass
    assert len(tracer.records) == 4 and tracer.seq == 20 and tracer.dropped == 16
    assert [r.window for r in tracer.records] == [8, 8, 9, 9]
    # a nested span takes its parent's window and names it
    r = tracer.records[-2]
    assert (r.name, r.parent, r.window) == ("setup.kernel_load", "pipeline.parse", 9)
    totals, records = tracer.between(a)
    assert totals["cli.read"][0] == 10 and totals["pipeline.parse"][0] == 10
    assert records == list(tracer.records)
    calls, total, own = totals["pipeline.parse"]
    assert own == total - totals["setup.kernel_load"][1]
    assert "records dropped: 16" in tracer.summary(a)


def test_metrics_prints_spans_and_turnaround(iq, tmp_path, tracer):
    """-metrics turns the tracer on for the run (and off after it) and
    prints the counters, each span and the turnaround."""
    _, err = from_file(iq, tmp_path, ["-metrics"])
    assert not tracer.on
    counters = next(line for line in err.splitlines() if line.startswith("metrics:"))
    assert "'windows_decoded': %d" % N_WINDOWS["latency"] in counters
    assert "feed_to_emit" not in err and "samples_per_second" not in err
    table = err[err.index("span "):]
    for name in PER_WINDOW | {WINDOW, "cli.read", "cli.emit", "setup.first_window"}:
        assert re.search(rf"^{re.escape(name)} +\d+ +[\d.]+ +[\d.]+$", table, re.M), name
    m = re.search(rf"turnaround_ms \({WINDOW}, (\d+) windows\): p50 ([\d.]+) p95 ([\d.]+) "
                  r"max ([\d.]+)", err)
    assert m and int(m.group(1)) == N_WINDOWS["latency"]
    assert float(m.group(2)) <= float(m.group(3)) <= float(m.group(4))


def one_window(index: int) -> None:
    """The spans of one window of the live -latency path, 16 reads."""
    for _ in range(16):
        with span("cli.read"):
            pass
    TRACER.read_returned()
    since = stamp()
    with span("pipeline.stage", index, since):
        pass
    with span("frontend.enqueue", index):
        pass
    with span("pipeline.fetch_wait", index):
        pass
    with span("pipeline.parse", index):
        pass
    with span("cli.emit", TRACER.last_completed(1)):
        pass
    TRACER.close_windows(1)


def test_host_cost_a_window(tracer):
    """The tracer on costs at most 0.1 ms of host time a window (the best of
    several repeats, so other load on the machine does not count)."""
    observability.enable()
    n = 200
    best = float("inf")
    for rep in range(7):
        tracer.reset()
        t = time.perf_counter()
        for i in range(n):
            one_window(i)
        best = min(best, (time.perf_counter() - t) / n)
    assert tracer.totals[WINDOW][0] == n and tracer.dropped == 0
    assert best < 1e-4, f"{best * 1e3:.4f} ms a window"
