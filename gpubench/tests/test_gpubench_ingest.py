"""The check judges only the stream the receiver was given: the ingest
tap's readings, and whole runs on the CPU with the Python rtl_tcp client
standing in for a ring that drops a stretch of the timed connection, past
the window and inside it, which fail the run; a traced run starts its
profiler once in set-up."""

from types import SimpleNamespace

import numpy as np
import pytest

from conftest import tiny, wide_tiny
from gpubench import check, harness
from test_gpubench_faults import _one_line_planted

SEED = 3_180_000_021


def test_ingest_tap_reads_the_counter_after_each_read():
    """The counter after the timed call's last read, a read that raises
    included; the tap is restored."""

    class Source:
        def __init__(self):
            self.dropped = 0

        def read(self, n):
            if n < 0:
                raise EOFError
            return np.zeros(n, np.uint8)

        def dropped_bytes(self):
            return self.dropped

    orig = Source.read
    tap = harness.IngestTap(SimpleNamespace(RtlTcpSource=Source))
    source = Source()
    with tap:
        source.read(100)
        assert tap.dropped == 0
        source.dropped = 6
        source.read(10)
        assert tap.dropped == 6
        source.dropped = 10
        with pytest.raises(EOFError):
            source.read(-1)
        source.dropped = 12
    assert Source.read is orig
    assert tap.dropped == 10


def test_a_packet_the_flush_finds_before_found_by_is_known():
    """A stream cut after a short packet's end but before the sample
    ``found_by`` names: the CLI's flush decodes it from what was sent, and
    so does the reference, its stretch cut where the stream was."""
    from gpubench.traffic.plan import Stream, make_plan, render

    cell = tiny("nb_all.live16")
    plan = make_plan(cell.config, cell.traffic, SEED, 2.0)
    stream = Stream(plan, render(cell.config, plan))
    bs = plan.block_size
    p = next(p for p in plan.packets[2:] if p.kind == "scm")
    (_, full), = [check.decode_segment(t) for t in check.segment_tasks(
        cell.config, stream, [p], plan.samples)]
    assert len(full) == 1
    cuts = range(-(-p.end // bs) * bs, plan.found_by(p), bs)
    found = [sent for sent in cuts
             if check.decode_segment(check.segment_tasks(cell.config, stream, [p], sent)[0])[1] == full]
    assert found, "no cut before found_by decodes the packet"
    assert found[0] < plan.found_by(p)


def _python_client_dropping(monkeypatch, cell, at_s: float, pairs: int):
    """The cell's CLI on the Python rtl_tcp client, given ``stats`` like the
    native ring's: on the timed connection, once ``at_s`` seconds of the
    stream are delivered, ``pairs`` I/Q pairs are dropped there (a stretch
    of the stream the receiver never sees) and counted."""
    from rtlamr_tpu_torch.io.rtltcp import RtlTcpClient

    cell.config["flags"] = cell.config["flags"] + ["-ingest=python"]
    rate = 2 * int(cell.config.get("channels", 1)) * cell.config["sample_rate"]
    at, drop = int(at_s * rate), 2 * pairs
    orig = RtlTcpClient.read_samples
    state = {}

    def read_samples(self, n_bytes, deadline=5.0):
        s = state.setdefault(id(self), [0, 0])
        hole = at - s[0]
        if not s[1] and 0 <= hole < n_bytes:
            data = orig(self, n_bytes + drop, deadline)
            out = np.concatenate([data[:hole], data[hole + drop:]])
            s[1] = drop
        else:
            out = orig(self, n_bytes, deadline)
        s[0] += out.size
        return out

    def stats(self):
        s = state.get(id(self), [0, 0])
        return s[0], s[1], 0

    monkeypatch.setattr(RtlTcpClient, "read_samples", read_samples)
    monkeypatch.setattr(RtlTcpClient, "stats", stats, raising=False)
    return drop


def _numbers(res):
    return {k: v["value"] for k, v in res["checks"].items()}


@pytest.mark.parametrize("at_s", [1.0 + 2.0 + 0.7, 1.0 + 1.2], ids=["past", "inside"])
def test_a_drop_fails_the_run(at_s, monkeypatch, run_tiny):
    """4,097 pairs, not a whole number of 4-channel frames, dropped 0.7 s
    past the window's end or 1.2 s into it: the receiver decoded a stream
    the reference never had, and the run is not correct."""
    cell = wide_tiny("parallel")
    drop = _python_client_dropping(monkeypatch, cell, at_s, 4097)
    res = run_tiny(cell, seed=SEED, seconds=2.0)
    numbers = _numbers(res)
    assert not res["correct"], numbers
    assert numbers["ingest_dropped_bytes"] == drop > 0 and res["attempted"] > 0


def test_a_line_planted_past_a_drop_still_counts(monkeypatch, run_tiny):
    """A line the stream does not hold, planted past an earlier drop of
    whole 4-channel frames, is still an extra line: nothing past a drop is
    left out of the comparison."""
    cell = wide_tiny("parallel")
    _one_line_planted(monkeypatch)
    drop = _python_client_dropping(monkeypatch, cell, 0.8, 4 * 64)
    res = run_tiny(cell, seed=SEED, seconds=2.0)
    numbers = _numbers(res)
    assert not res["correct"]
    assert numbers["extra"] >= 1 and numbers["ingest_dropped_bytes"] == drop, numbers


OLD_CHECKS = {"missing", "extra", "out_of_order", "k1_bits_diff", "k1_q6_diff", "k1_mask_diff"}


@pytest.mark.parametrize("name", ["nb_all.live16", "wb4_test.parallel"])
def test_no_drop_compares_every_line_as_before(name, monkeypatch, run_tiny):
    """With nothing dropped every line the CLI printed is compared, in its
    order, as before the ingest tap; the checks are the earlier ones plus
    ``ingest_dropped_bytes`` at 0."""
    seen = {}
    orig_compare = check.compare_messages

    def compare(want, emitted, known, order=None):
        seen["compared"] = list(emitted)
        return orig_compare(want, emitted, known, order)

    sinks = []

    class Sink(harness.StampSink):
        def __init__(self):
            super().__init__()
            sinks.append(self)

    monkeypatch.setattr(check, "compare_messages", compare)
    monkeypatch.setattr(harness, "StampSink", Sink)
    wide = name.startswith("wb4_test.")
    cell = wide_tiny("parallel") if wide else tiny(name)
    res = run_tiny(cell, seed=SEED)
    lines = [check.canonical_line(line) for _, line in sinks[-1].lines]
    assert res["correct"], _numbers(res)
    assert len(lines) > 10 and seen["compared"] == lines
    assert set(res["checks"]) == OLD_CHECKS | {"ingest_dropped_bytes"} | (
        {"k2_frames_diff"} if wide else set())
    assert all(v == 0 for v in _numbers(res).values())


def test_a_traced_run_starts_the_profiler_in_set_up(monkeypatch, run_tiny):
    """The traced run's first profiler session comes after the warm-up CLI
    call and before the timed one, and leaves no profiler running; the
    timed call's start then holds the read for well under a second."""
    import importlib

    import torch

    from gpubench import trace

    cli = importlib.import_module("rtlamr_tpu_torch.cli.main")

    events = []
    orig_main, orig_warm = cli.main, trace.SubWindow.warm

    def main(*args, **kwargs):
        events.append("cli")
        return orig_main(*args, **kwargs)

    def warm(self):
        orig_warm(self)
        events.append(("warm", torch.autograd.profiler._is_profiler_enabled))

    monkeypatch.setattr(cli, "main", main)
    monkeypatch.setattr(trace.SubWindow, "warm", warm)
    res = run_tiny(tiny("nb_all.live16"), seed=SEED, trace=True)
    assert events == ["cli", ("warm", False), "cli"]
    assert res["correct"], _numbers(res)
    assert 0 <= res["trace_start_s"] < 1.0
