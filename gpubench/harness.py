"""One run of one cell: inputs, load generator, set-up, the measured window
through the CLI's own loop, the reference, and the result.

The window drives ``rtlamr_tpu_torch.cli.main.main(argv)`` in this
process, with the cell's flags and ``-format=json``; its ``sys.stdout`` is
a :class:`~gpubench.endpoints.StampSink`. Traffic comes from a feeder
process (``traffic/feeder.py``): an rtl_tcp server on ``127.0.0.1``
(``-server``), pacing one block at a time on an absolute schedule; the
window is ``seconds`` of that schedule after ``lead_seconds``.

Every run also reads the receiver's ingest counter of bytes dropped after
each read of the timed call (:class:`IngestTap`): past a drop the receiver
decodes a stream the reference never had, so any drop fails the run
(``ingest_dropped_bytes``). A traced run starts its profiler once in
set-up, so that the timed call's start does not hold the read long enough
to fill the ingest's ring.

Set-up is everything before the window that the program needs: imports,
the CUDA context, the kernels (built on a checkout's first run), a warm-up
CLI call with the same flags over a short stream, in a traced run the
profiler's first session, and the timed call up to the feeder's accepting
its connection. Generating the inputs comes before
and is reported apart. After the window: the device memory peak, the check
that no JAX module was loaded, then the reference and the comparison
(``check.py``).

A configuration with ``channels`` N > 1 is one wideband stream of N
channels (``-channels N``): a block on the wire is N channel blocks'
worth, ``2 N block_size`` bytes every ``block_size / sample_rate``
seconds, and channel block b comes from wideband block b. The stream lives
in a memory file that the feeder and the reference's workers map. The
taps then also keep K2's rows for one super-step (``K2Tap``), and K1's
index ``i`` is super-step ``i // N``, channel ``i % N`` (the super-step
launches a window program a channel, in channel order).
"""

from __future__ import annotations

import contextlib
import importlib
import math
import multiprocessing
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import catalog, check
from .spans import short_name
from .endpoints import StampSink
from .reference import stencil as ref_stencil
from .traffic import feeder
from .traffic.plan import Stream, decoder_config, make_plan, render, render_wideband, window_blocks

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "rtlamr_tpu")
#: the live flag's source
SERVER = "127.0.0.1"
#: the span at whose entries a traced run starts and stops the profiler:
#: the CLI loop's source read
READ_SPAN = "capture.RtlTcpSource.read"


class NoCard(RuntimeError):
    """The run found fewer cards than the cell asks for."""


class HarnessFault(RuntimeError):
    """The harness, not the program, failed the run (a late feeder)."""


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the run."""


@dataclass
class Run:
    """What a run measured; the end-to-end readers read it."""

    rate: float
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    #: a missing packet's latency is over any limit; the result line shows
    #: this finite stand-in (the run's whole schedule, in ms) for it
    latency_cap_ms: float = 0.0

    def latency_value(self, v: float) -> float:
        return self.latency_cap_ms if math.isinf(v) else v


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class K1Tap:
    """Keeps a device copy of K1's outputs for one window of the timed call
    (the ``index``-th launch at the window spec; the high-capacity
    escalation spec is not counted)."""

    def __init__(self, frontend, index: int):
        self.frontend, self.index = frontend, index
        self.orig = frontend.decode_stencil
        self.spec = None
        self.calls = 0
        self.out = None

    def __call__(self, spec, staged, first):
        res = self.orig(spec, staged, first)
        if self.spec is None:
            self.spec = spec
        if spec is self.spec:
            if self.calls == self.index:
                bits, q6, mask = res
                self.out = (bits.clone(), None if q6 is None else q6.clone(), mask.clone(), bool(first))
            self.calls += 1
        return res

    def __enter__(self):
        self.frontend.decode_stencil = self
        return self

    def __exit__(self, *exc):
        self.frontend.decode_stencil = self.orig

    def host(self):
        if self.out is None:
            return None
        bits, q6, mask, first = self.out
        return (bits.cpu().numpy(), None if q6 is None else q6.cpu().numpy(),
                mask.cpu().numpy(), first)


class K2Tap:
    """Keeps a device copy of K2's channel rows for one super-step of the
    timed call (the ``index``-th call of the name the wideband step calls,
    ``parallel.wideband.channelize_requantize_fused``)."""

    def __init__(self, wideband, index: int):
        self.wideband, self.index = wideband, index
        self.orig = wideband.channelize_requantize_fused
        self.calls = 0
        self.out = None

    def __call__(self, spec, hist, wb, first, out=None, **kw):
        res = self.orig(spec, hist, wb, first, out=out, **kw)
        if self.calls == self.index:
            self.out = (res.clone(), bool(first))
        self.calls += 1
        return res

    def __enter__(self):
        self.wideband.channelize_requantize_fused = self
        return self

    def __exit__(self, *exc):
        self.wideband.channelize_requantize_fused = self.orig

    def host(self):
        if self.out is None:
            return None
        rows, first = self.out
        return rows.cpu().numpy(), first


class IngestTap:
    """Reads ``dropped_bytes()`` of the ``RtlTcpSource`` after every read of
    the timed call (the CLI loop's only read of a live stream): the native
    ingest drops the newest bytes when its ring is full and counts them; a
    client with no counter (the Python one) drops nothing, as TCP's
    back-pressure holds the sender."""

    def __init__(self, capture):
        self.owner = capture.RtlTcpSource
        #: bytes dropped, at the last read
        self.dropped = 0

    def __enter__(self):
        # Taken here, so a traced run's span around the read stays inside.
        self.orig = orig = self.owner.read

        def read(source, *args, **kwargs):
            try:
                return orig(source, *args, **kwargs)
            finally:
                self.dropped = int(source.dropped_bytes())

        self.owner.read = read
        return self

    def __exit__(self, *exc):
        self.owner.read = self.orig


@contextlib.contextmanager
def cli_io():
    """``sys.stdout`` swapped for a :class:`StampSink` for the call."""
    sink = StampSink()
    old_out = sys.stdout
    sys.stdout = sink
    try:
        yield sink
    finally:
        sys.stdout = old_out


def card_line(chips: int) -> Dict[str, object]:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.split()
        out["power_limit_w"] = [float(x) for x in lines[:chips]]
    except (OSError, subprocess.SubprocessError, ValueError):
        out["power_limit_w"] = None
    return out


def draw(seed: int, lo: int, hi: int, tag: int) -> int:
    """An integer of ``[lo, hi]`` drawn from the run's seed (``tag`` keeps
    the draws apart)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, tag]))
    return int(rng.integers(lo, hi + 1))


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, log=None) -> dict:
    """Run ``cell`` once; returns the result line's object. ``device``
    (tests only) runs the CLI on that device (``"cpu"``) with no card."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    if device is None:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"want {cell.chips} CUDA card(s), have "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    config, traffic = cell.config, cell.traffic
    n = int(config.get("channels", 1))

    # Inputs (before set-up; not counted in it). A traced run streams on
    # past the window while the profile is taken; the profiler's start
    # alone takes seconds.
    t = time.monotonic()
    extra = float(traffic.get("trace_extra_seconds", 0.0)) if trace else 0.0
    plan = make_plan(config, traffic, seed, seconds + extra)
    shared = clipped = None
    if n > 1:
        shared = feeder.SharedBytes(plan.stream_bytes)
        clipped = render_wideband(config, plan, shared.array)
        stream = Stream(plan, shared.array)
    else:
        stream = Stream(plan, render(config, plan))
    inputs_s = time.monotonic() - t
    log(f"inputs: {len(plan.packets)} packets planted, {plan.stream_bytes} bytes "
        f"of stream, {inputs_s:.3f} s" + (f", {clipped} components clipped" if n > 1 else ""))

    geo = ref_stencil.window_geometry(decoder_config(config), window_blocks(traffic))
    # The window checked: a super-step, and a channel of it, in a wideband
    # stream.
    check_index = draw(seed, *traffic["check_windows"], tag=5)
    check_channel = draw(seed, 0, n - 1, tag=6) if n > 1 else 0
    e2e = catalog.readers("end_to_end", cell.end_to_end)
    per_layer = catalog.readers("metrics", cell.per_layer) if trace else {}
    spans = [s for m in per_layer.values() for s in m.SPANS]
    if trace:
        spans.append("rtlamr_tpu_torch.io.capture:RtlTcpSource.read")
    span_names = [short_name(s) for s in spans]
    run = Run(rate=float(n * config["sample_rate"]))
    argv = cell.flags + ["-format=json"]
    sub = None
    timer = None

    cli = importlib.import_module("rtlamr_tpu_torch.cli.main")
    from rtlamr_tpu_torch.ops import frontend

    tap = K1Tap(frontend, check_index * n + check_channel)
    ingest = IngestTap(importlib.import_module("rtlamr_tpu_torch.io.capture"))
    k2tap = contextlib.nullcontext()
    if n > 1:
        k2tap = K2Tap(importlib.import_module("rtlamr_tpu_torch.parallel.wideband"), check_index)
    if trace:
        from .spans import HostTimer
        from .trace import SubWindow

        timer = HostTimer()
        sub = SubWindow(timer, list(range(cell.chips)) if device is None else [])
    trace_s = float(traffic["trace_seconds"])

    ctx = multiprocessing.get_context("spawn")
    ctl, ctl_child = ctx.Pipe()
    block_bytes = 2 * plan.wide_block
    block_s = plan.wide_block / run.rate
    lead = float(traffic["lead_seconds"])
    warm_blocks = traffic["warmup_blocks"]
    if shared is None:
        args = (ctl_child, stream.bytes(0, warm_blocks * plan.block_size),
                stream.bytes(0, plan.samples), block_bytes, block_s)
    else:
        args = (ctl_child, shared, shared, block_bytes, block_s, warm_blocks)
    proc = ctx.Process(target=feeder.rtl_tcp_feeder, args=args, daemon=True)
    proc.start()
    ctl_child.close()
    msgs: Dict[str, tuple] = {}
    #: seconds the profiler's start held the read it started in
    trace_start_s = None

    def poll() -> None:
        # Nothing follows "done": past it the pipe reads as closed.
        while "done" not in msgs and ctl.poll():
            m = ctl.recv()
            msgs[m[0]] = m[1:]

    try:
        if not ctl.poll(60):
            raise RuntimeError("the rtl_tcp feeder did not start")
        poll()
        server = f"-server={SERVER}:{msgs['port'][0]}"
        # Set-up: the warm-up call reads its stream to the end.
        with cli_io():
            rc = cli.main(argv + [server], device=device)
        if rc != 0:
            raise RuntimeError(f"warm-up CLI call exited {rc}")
        if sub is not None:
            sub.warm()

        def on_enter(name: str) -> None:
            nonlocal trace_start_s
            if name != READ_SPAN:
                return
            if "t0" not in msgs:
                poll()
                if "t0" not in msgs:
                    return
            now = time.monotonic()
            ws = msgs["t0"][0] + lead
            if now >= ws:
                sub.open_window()
            if not sub.started and now >= ws + seconds:
                sub.start()
                trace_start_s = sub.t_up - now
            elif sub.started and not sub.stopped and now - sub.t_up >= trace_s:
                # The feeder first: the stream ends while the profiler stops.
                ctl.send("stop")
                sub.stop()

        if timer is not None:
            timer.on_enter = on_enter
            timer.install(spans)
        with tap, k2tap, ingest, cli_io() as sink:
            rc = cli.main(argv + [server], device=device)
        if rc != 0:
            raise RuntimeError(f"timed CLI call exited {rc}")
        while "done" not in msgs:
            if not ctl.poll(120):
                raise RuntimeError("the rtl_tcp feeder sent no report")
            try:
                poll()
            except EOFError:
                proc.join(10)
                raise RuntimeError(f"the rtl_tcp feeder ended (exit code {proc.exitcode}) "
                                   "without its report") from None
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
    report = msgs["done"][0]
    if "error" in report:
        raise HarnessFault(f"rtl_tcp feeder: {report['error']}")
    t0, accepted = msgs["t0"]
    run.setup_s = accepted - t_start - inputs_s
    run.window_s = float(seconds)
    ws = t0 + lead
    bs = plan.block_size
    # A packet is due when the block holding its last sample was due, or
    # when the feeder was ready to send that block if it ran late on its
    # own account (a send held up by the receiver keeps its due time).
    own = report.pop("own_late_s")
    due_at = {}
    for p in plan.packets:
        k = (p.end - 1) // bs
        due_at[p.index] = t0 + (k + 1) * block_s + (own[k] if k < len(own) else 0.0)
    due = [p for p in plan.packets if ws <= due_at[p.index] < ws + seconds]
    # Every packet the CLI could have emitted: begun before the last block
    # sent (the reference decodes what was sent, as the CLI's flush does).
    sent = report["blocks"] * bs
    ref_packets = [p for p in plan.packets if p.offset < sent]
    run.latency_cap_ms = (plan.stream_samples / run.rate + 1.0) * 1e3
    log(f"feeder: {report}")
    limit_ms = traffic["feeder_late_limit_blocks"] * report["block_ms"]
    if report["own_late_ms_max"] > limit_ms:
        raise HarnessFault(f"the rtl_tcp feeder ran {report['own_late_ms_max']:.3f} ms late on "
                           f"its own account (the limit is {limit_ms:.3f} ms)")

    if timer is not None:
        sub.stop()
        timer.restore()
    memory_peak = 0
    if device is None:
        import torch

        memory_peak = max(int(torch.cuda.max_memory_allocated(d)) for d in range(cell.chips))
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"loaded in the run: {', '.join(bad[:20])}")
    kernel_out = tap.host()
    k2_out = k2tap.host() if n > 1 else None
    trace_data = sub.reduce(span_names) if sub is not None else None
    del tap, k2tap
    if device is None:
        import torch

        torch.cuda.empty_cache()

    # The reference, after the window.
    t = time.monotonic()
    order = None
    strays: List[str] = []
    if n == 1:
        with check.pool() as pool:
            tasks = check.segment_tasks(config, stream, ref_packets, sent)
            seg = pool.map(check.decode_segment, tasks, chunksize=2)
            samples = ref_stencil.window_samples(geo, stream.samples_u16, check_index)
            kres = check.k1_reference(pool, geo, samples, check_index == 0)
            expected = dict(seg)
    else:
        # The channels' streams, which the workers channelize into.
        channels = feeder.SharedBytes(plan.stream_bytes)
        with check.pool(shared, channels) as pool:
            found = check.wideband_messages(pool, config, plan, sent)
            rows = check.superstep_rows(pool, n, geo, check_index)
            kres = check.k1_reference(pool, geo, rows[check_channel], check_index == 0)
        del channels
        # What the receiver may emit, in its order: block, then channel. A
        # message of no planted meter is due when its block was.
        planted = {p.meter_id: p.index for p in plan.packets}
        expected = {p.index: [] for p in plan.packets}
        order = {}
        for b, c, mid, m in found:
            order[m] = (b, c)
            if mid in planted:
                expected[planted[mid]].append(m)
            elif ws <= t0 + (b + 1) * block_s < ws + seconds:
                strays.append(m)
    reference_s = time.monotonic() - t

    known = {m for v in expected.values() for m in v} | set(order or ())
    # A packet the reference does not decode is no answer due.
    due = [p for p in due if expected[p.index]]
    want: List[str] = list(strays)
    for p in due:
        want.extend(expected[p.index])
    if order is not None:
        want.sort(key=order.__getitem__)
    emitted = [check.canonical_line(line) for _, line in sink.lines]
    numbers = check.compare_messages(want, emitted, known, order)
    # Past a drop the receiver decoded a stream the reference never had.
    numbers["ingest_dropped_bytes"] = ingest.dropped
    numbers.update(check.compare_k1(
        None if kernel_out is None else (*kernel_out, check_index == 0), kres))
    if n > 1:
        numbers.update(check.compare_k2(
            None if k2_out is None else (*k2_out, check_index == 0), rows[:, geo.halo_staged:]))
    stamps: Dict[str, float] = {}
    for (stamp, _), m in zip(sink.lines, emitted):
        stamps.setdefault(m, stamp)
    for p in due:
        want_p = expected[p.index]
        if all(m in stamps for m in want_p):
            done = max(stamps[m] for m in want_p)
            run.latencies_ms.append((done - due_at[p.index]) * 1e3)
        else:
            run.latencies_ms.append(math.inf)
    failed = numbers["missing"] + numbers["extra"] + numbers["out_of_order"]
    correct = all(v <= 0 for v in numbers.values())

    result: dict = {"correct": correct, "attempted": len(due), "failed": failed}
    metrics: Dict[str, dict] = {}
    if not trace:
        for name, mod in e2e.items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": cell.units[name]}
    else:
        trace_data.reference = {"k1_geo": geo, "k1_live_words": kres[3]}
        if n > 1:
            from . import yardstick
            from .reference.channelizer import TAPS

            # K2's work on one super-step: what a k2 roofline reads.
            trace_data.reference["k2_shape"] = (n, TAPS, geo.window)
            trace_data.reference["k2_work"] = yardstick.channelizer_work(n, TAPS, geo.window)
        if device is None:
            from . import yardstick

            trace_data.card = yardstick.card_clock(0)
        for name, mod in per_layer.items():
            v = mod.read(trace_data)
            if v is not None:
                metrics[name] = {"value": v, "unit": cell.units[name]}
    result["metrics"] = metrics
    dev = card_line(cell.chips) if device is None else {"platform": "cpu", "kind": "cpu",
                                                         "count": cell.chips}
    dev["memory_peak_bytes"] = memory_peak
    if trace and trace_data is not None:
        busy = list(trace_data.busy_s.values())
        dev["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = trace_data.breakdown
    result["device"] = dev
    result["workload"] = cell.name
    result["seed"] = seed
    result["inputs_s"] = inputs_s
    result["reference_s"] = reference_s
    result["window_s"] = run.window_s
    if trace:
        result["trace_start_s"] = trace_start_s
        log(f"trace: the profiler's start held the read {trace_start_s} s")
    result["feeder"] = {k: v for k, v in report.items() if k != "commands"}
    if n > 1:
        result["clipped"] = clipped
    for name, v in numbers.items():
        log(f"check {name} = {v} (limit 0)")
    result["checks"] = {name: {"value": v, "limit": 0} for name, v in numbers.items()}
    return result
