"""The wideband decoder's spans and counters (``parallel/wideband.py``,
``utils/observability.py``): in the live CLI loop each super-step is a
window with its root ``cli.window`` and the four ``wideband.*`` spans
under it, in both presets, the message stream unchanged by tracing;
nothing is recorded while the tracer is off; ``windows_decoded`` counts
super-steps; and ``-metrics`` reports the ingest's dropped bytes and the
super-step counters at ``-channels>1``."""

import re

import numpy as np
import pytest
import torch

from rtlamr_tpu_torch.io.capture import RtlTcpSource
from rtlamr_tpu_torch.parallel import WidebandDecoder
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import CAPACITY, TRACER, WINDOW
from test_torch_observability import ClosingRtlTcp, run_cli

torch.set_num_threads(1)

N = 4
CHIP = 8
NAMES = ("scm", "scm+", "idm", "r900")
WINDOW_BLOCKS = 24
BLOCK = build_decoder_config([new_parser(p, CHIP) for p in NAMES]).block_size
#: samples of a channel in a super-step
STEP = WINDOW_BLOCKS * BLOCK
#: super-steps of the stream: three of the throughput preset's 256 KiB
#: reads exactly, so no read is short and every super-step completes
STEPS = 8
PRESETS = {"throughput": [f"-windowblocks={WINDOW_BLOCKS}"],
           "latency": ["-latency", f"-windowblocks={WINDOW_BLOCKS}"]}
#: the spans every super-step has under its root
PER_STEP = {"wideband.stage", "wideband.step", "wideband.fetch_wait", "wideband.parse"}
#: super-steps a poll completes: of the throughput preset's three reads,
#: the second and third each find the one before's last super-step in
#: flight (the rest complete at the next dispatch, the last at the flush);
#: -latency drains every feed
POLLED = {"throughput": 2, "latency": 0}


@pytest.fixture(scope="module")
def wb():
    """A four-channel stream of STEPS super-steps with packets of every
    type on every channel, one straddling a super-step boundary."""
    planted = []
    for k in range(STEPS):
        c = k % N
        at = k * STEP + 2000 + 300 * c
        if k % 4 == 0:
            burst = synth.bits_to_burst(synth.make_scm_bits(meter_id=9100 + k, consumption=k), at)
        elif k % 4 == 1:
            burst = synth.bits_to_burst(
                synth.make_scmplus_bits(endpoint_id=9100 + k, consumption=k), (k + 1) * STEP - 700)
        elif k % 4 == 2:
            burst = synth.r900_burst(synth.make_r900_symbols(meter_id=9100 + k), at)
        else:
            burst = synth.bits_to_burst(synth.make_idm_bits(serial=9100 + k), at)
        planted.append((c, burst))
    out = synth.render_wideband(STEPS * STEP, planted, N, CHIP, amplitude=90.0, noise=2.0,
                                seed=24)
    assert out.size == STEPS * 2 * N * STEP and out.size % (1 << 18) == 0
    return out


@pytest.fixture
def tracer():
    """The process's tracer, empty; left off and empty after the test."""
    TRACER.reset()
    yield TRACER
    observability.disable()
    TRACER.capacity = CAPACITY
    TRACER.reset()


def live(iq, preset, extra=()):
    server = ClosingRtlTcp(iq)
    server.start()
    try:
        return run_cli(["-msgtype=all", f"-symbollength={CHIP}", f"-channels={N}",
                        "-format=json", f"-server=127.0.0.1:{server.port}", "-duration=60s",
                        *PRESETS[preset], *extra])
    finally:
        server.join(timeout=20)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_live_super_steps_and_their_spans(wb, preset, tracer):
    """Off, a run records nothing. On, each super-step closes one root;
    the four wideband spans lie inside it with its index, the channels'
    parses inside ``wideband.parse``; the stream is byte-identical to the
    untraced run's."""
    want, _ = live(wb, preset)
    assert tracer.seq == 0 and not tracer.totals
    observability.enable()
    got, _ = live(wb, preset)
    assert got == want and len(got.splitlines()) >= STEPS - 1
    records = list(tracer.records)
    assert tracer.dropped == 0
    roots = {r.window: r for r in records if r.name == WINDOW}
    assert sorted(roots) == list(range(STEPS)) and tracer.totals[WINDOW][0] == STEPS
    assert all(r.parent is None for r in roots.values())
    for w, root in roots.items():
        kids = [r for r in records if r.parent == WINDOW and r.window == w]
        assert PER_STEP <= {k.name for k in kids}, (w, kids)
        assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns for k in kids)
        assert sum(k.end_ns - k.start_ns for k in kids) <= root.end_ns - root.start_ns
        for name in PER_STEP:
            assert sum(k.name == name for k in kids) == 1, (w, name)
    parses = [r for r in records if r.name == "pipeline.parse"]
    assert len(parses) == N * STEPS
    assert all(r.parent == "wideband.parse" for r in parses)
    # nothing of the narrowband path's own staging or enqueue
    assert not {"pipeline.stage", "frontend.enqueue", "pipeline.fetch_wait"} & set(tracer.totals)


def test_windows_decoded_counts_super_steps(wb, tracer):
    """The decoder counts a super-step completed once; its channels count
    their windows; a library call (no CLI read) opens no root."""
    observability.enable()
    dec = WidebandDecoder([new_parser(p, CHIP) for p in NAMES], n_channels=N,
                          window_blocks=WINDOW_BLOCKS, device="cpu")
    msgs = dec.decode_capture(wb)
    assert msgs and dec.metrics.windows_decoded == STEPS
    assert dec.metrics_snapshot()["windows_decoded"] == N * STEPS
    assert tracer.totals["wideband.step"][0] == STEPS and WINDOW not in tracer.totals
    observability.disable()
    tracer.reset()
    dec.decode_capture(wb)
    assert dec.metrics.windows_decoded == 2 * STEPS and tracer.seq == 0 and not tracer.totals


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_metrics_reports_bytes_dropped_and_super_steps(wb, preset, tracer, monkeypatch):
    """At -channels>1, -metrics reports the bytes the ingest dropped, as at
    -channels=1, and the super-steps with their window programs and K2
    launches (none on the CPU, which runs K2's plain version)."""
    monkeypatch.setattr(RtlTcpSource, "dropped_bytes", lambda self: 2 * N * 1000)
    _, err = live(wb, preset, ["-metrics"])
    counters = next(line for line in err.splitlines() if line.startswith("metrics:"))
    assert f"'bytes_dropped': {2 * N * 1000}" in counters
    assert f"'windows_decoded': {N * STEPS}" in counters
    assert "ingest ring overflow" in err
    assert re.search(rf"^super-steps: {STEPS} \({POLLED[preset]} completed by a poll\), "
                     rf"window programs a super-step: {N}\.0, K2 launches: 0$", err, re.M)
    m = re.search(rf"turnaround_ms \({WINDOW}, (\d+) windows\)", err)
    assert m and int(m.group(1)) == STEPS


def test_metrics_reports_no_drop_from_a_file(wb, tmp_path, tracer):
    """A capture file drops nothing and records no ``bytes_dropped``."""
    path = tmp_path / "wb.bin"
    np.asarray(wb, np.uint8).tofile(path)
    _, err = run_cli(["-msgtype=all", f"-symbollength={CHIP}", f"-channels={N}",
                      "-format=json", f"-fromfile={path}", "-metrics", *PRESETS["throughput"]])
    counters = next(line for line in err.splitlines() if line.startswith("metrics:"))
    assert "bytes_dropped" not in counters
    assert re.search(rf"^super-steps: {STEPS} \({POLLED['throughput']} completed by a poll\), ",
                     err, re.M)
