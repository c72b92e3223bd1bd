#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``rtlamr_tpu_torch``) on one CUDA card.

Usage, from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

Each phase prints one JSON line; any mismatch or exception ends the run with
a non-zero exit code and no result line:

1. device   the card's name and power limit (nvidia-smi).
2. build    the hand-written CUDA kernels from ``rtlamr_tpu_torch/csrc``
            (one ``nvcc`` per library, all started together; the
            channelizer is one library for each channel count and tap
            class that the later phases launch) and what
            ``-Xptxas -v`` says about registers and shared memory.
3. cli      ``python -m rtlamr_tpu_torch`` in-process on the golden capture
            ``tests/fixtures/sample.bin``: exactly its 14 SCM messages; the
            same through ``WindowDecoder`` with block indices, also with one
            candidate slot a window, so that windows escalate to the
            high-capacity program and to the exact host path.
4. decode   the narrowband path: four 1024-block windows of a synthetic
            all-protocol capture fed through ``WindowDecoder.feed`` in the
            CLI's chunk size; the decoded set equals the planted set. Prints
            samples/s, where the host time of a window goes, and the device
            time and kernel count of one window program.
   lookahead  the window program's look-ahead (each streamed window's
            search of the next window's first blocks): its mask kernel
            against ``masks_plain`` on K1's bits of the same window, byte
            for byte, at the benchmark cell's shape (all four protocols,
            chip length 72, 16-block windows) and ``-latency``'s 4-block
            windows on planted, random and all-zero windows, and all six
            types at chip length 8; then the decode phase's capture through
            the CLI's ``-latency -windowblocks=16``, launch counts set to 0
            just before: the throughput preset's records, the mask kernel
            launched once a window looked ahead, the look-ahead engaged.
5. batch    the same capture device-resident through
            ``decode_staged_batch``: the same message stream; and
            ``run_window`` on the raw u8 bytes of windows 0 and 1 (halo
            first), equal to the decode of the host-staged buffer, K1 once
            a call.
6. wideband the wideband path at full width: 12 channels at chip length 72,
            1024-block windows, two full super-steps and a flushed partial
            one of a synthetic capture (``bench_wideband.py``'s recipe)
            through ``WidebandDecoder.feed`` in the CLI's chunk size; the
            decoded (channel, type, id) set equals the planted set. Prints
            wideband samples/s, where the host time of a super-step goes,
            and the device time of one super-step.
7. wideband_cli  ``python -m rtlamr_tpu_torch -channels=4`` in-process on a
            small four-channel capture: exactly its planted (channel, id)
            set.
8. resume   stream checkpoints on the card at full width: the decode
            phase's capture cut at byte 0, inside window 2 and inside the
            flush's partial window, and the wideband phase's cut inside its
            second super-step, each drained, saved, loaded into a fresh
            decoder, restored and run to the end (K1, and K2 on the restored
            history); then ``-checkpoint`` through the CLI, ``-channels=1``
            and ``-channels=12``, with SIGINT raised during a read, and the
            resumed run. Every stream equals its straight run. Prints
            save_ms, load_restore_ms and the CLI's skip-read ms.
            resume_oracle: the port's NumPy oracle
            ``ReferenceDecoder(arithmetic="int")`` over the decode phase's
            capture, run in worker processes during the wideband_cli and
            resume phases, equals the straight stream, and so every resumed
            one.
9. native   the C++ transport (``rtlamr_tpu_torch/native``, built with g++
            on first use; a failed build fails the phase): the decode
            phase's capture through ``NativeFileSource.read_staged`` into a
            ring of pinned ``torch.uint16`` buffers, each refilled once the
            event after its copy to the card has completed, then
            ``process_host_staged``: the feed path's 206 messages. Prints
            host ms a window by part beside the feed path's. Then the CLI
            with ``-ingest=native`` against ``-ingest=python`` on the golden
            capture and on the decode phase's, and a live run: the capture
            streamed by an in-process rtl_tcp server into a
            ``NativeRtlTcpClient`` CLI run, equal to the file run, 0 bytes
            dropped.
10. mesh    the time-sharded ``MeshDecoder`` with 1, 2 and 4 shards on the
            card over the decode phase's capture: the ``WindowDecoder``'s
            stream; ``dryrun`` at 2 and 4 shards (each boundary packet
            once); the CLI's ``-mesh`` (every card, and two shards on card
            0) equal to the plain run, and ``-mesh -checkpoint`` with SIGINT
            during a read, then resumed, equal to the straight run.
            Prints K1's launches.
    mesh_staged  the device-resident mesh super-batch: the decode phase's
            capture staged with ``stage_superbatch``, resident on the card,
            through ``MeshDecoder.decode_superbatch_staged`` with 2 and 4
            shards on the card, K = 2, twice each: the streaming mesh's
            stream and the planted set, K1 once a window of every
            super-batch plus once an escalation, exactly, the second decode
            of the batch equal to the first. Prints the device-resident
            rate (samples/s by CUDA events around the decode and drain).
11. wide_mesh  the channel x time ``WidebandMeshDecoder`` at full width on
            the wideband phase's capture: mesh (2, 2), one window a time
            shard, its four shards on the card (K2 launched once a shard a
            super-batch, for the shard's block of six channel rows), equal
            to the wideband phase's stream (127 packets); prints K1's and
            K2's launches, host ms a super-batch by part and wideband
            samples/s, the layout's cost on one card. Then the CLI's
            -channels=12 -mesh on every card and, with -checkpoint, on two
            devices of the card (SIGINT during a read, then the resumed
            run), equal to the plain -channels=12 run.
12. multihost  ``python -m rtlamr_tpu_torch -coordinator`` in two processes
            on the card (gloo over localhost) on the decode phase's capture
            written to a file, with -checkpoint: a run interrupted by
            SIGINT and its resumed run, whose records together partition
            the plain CLI's, at Offset = block x block bytes, each process
            in window order; K1 launched once a dispatched window and once
            an escalation. Prints the halo ring's and the seam dedup's host
            ms a super-batch and K1's launches per process.
13. k1      the decode-stencil kernel against its plain PyTorch version on
            the card, byte for byte (bits, q6, mask), at the throughput spec
            (all four ``-msgtype=all`` protocols, chip length 72, 1024
            blocks a window) on random, planted, all-zero and 0x8080
            windows, at the SCM-only chip length 78 spec (no q6) and at chip
            length 8 with 4 blocks (fewer strips than SMs), ``first`` both
            ways; then the kernel's time by CUDA events around the wrapper
            and by torch.profiler's record of the kernel (L2 flushed before
            each launch), the plain version's, and the bound (bytes at the
            HBM rate against integer operations at the card's int32 rate).
14. k2      the channelizer kernel against its plain PyTorch version on
            the card, byte for byte, at N = 1, 2, 3, 4, 5, 8, 12, 16, 31 and
            32 channels with 8 taps a branch and at N = 12 with 4 and 12,
            over a ragged frame count and fewer frames than one CTA's tile,
            with the stream head's zero history, a carried history and a
            chunk that starts off 16-byte alignment, into a fresh tensor and
            into rows at an odd column; the channel blocks phase wide_mesh
            launches (rows 0-5 and 6-11 of 12) equal to the same rows of the
            full launch and to the plain block; then at full width (N = 12,
            8,388,608 frames, into the staged batch) its time (CUDA events
            around the wrapper and torch.profiler's record of the kernel, L2
            flushed before each launch), the plain version's, the bound
            (bytes at the HBM rate against float32 instructions at 128 x SMs
            x clocks.max.sm, counted in the cheapest exact form and in the
            reference's order), the runtime tap loop's time at the same
            shape (checked byte-equal too) beside the compiled-in taps', and
            what ``-Xptxas -v`` says about each instantiation.
   lookahead_time  the mask kernel's time at the cell's shape (CUDA
            events around the wrapper and torch.profiler's record of the
            kernel, L2 flushed before each launch), the plain version's,
            and the bound (bytes at the HBM rate against the bank's
            integer operations at the card's int32 rate).
15. search  the search kernels (``csrc/search.cu``) against the plain
            ``pack_results(search_slice(...))`` on the card, byte for byte:
            the benchmark cell's spec and its look-ahead's (guards
            included) on planted windows 1 and 5 of the decode phase's
            capture, on a window that keeps a packet of every type and on
            random bytes, the cell's spec under a dense planted mask that
            overflows every capacity, the throughput spec on a planted
            window, and escalation's high-capacity spec on both; then the
            time of a search at the cell's shape (the all-types window,
            which the kernels line reports, and window 1) and at the
            throughput shape, each beside the packets it kept (CUDA events
            around the wrapper, and torch.profiler's
            record of the three kernels summed, L2 flushed before each
            call), the plain version's, and the bound: the mask read and
            the packed buffer written at the HBM rate for the kernels' own
            time; for the time by events, that or the launch floor (three
            empty kernels replayed from a CUDA graph, by events), the
            larger.
16. the kernels line, the card line, and the result line.

Launch counts are set to 0 just before each path is driven and read just
after; launches made to compare a kernel with its plain version do not count.
"""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import re
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from rtlamr_tpu_torch import native
from rtlamr_tpu_torch.cli.main import main as cli_main
from rtlamr_tpu_torch.decoder import WindowDecoder
from rtlamr_tpu_torch.decoder import pipeline as pipeline_mod
from rtlamr_tpu_torch.decoder.pipeline import StagingRing
from rtlamr_tpu_torch.decoder.checkpoint import (
    capture_checkpoint,
    load_checkpoint,
    restore_checkpoint,
)
from rtlamr_tpu_torch.io import capture as capture_mod
from rtlamr_tpu_torch.ops import build
from rtlamr_tpu_torch.ops.channelizer import ChannelizerSpec
from rtlamr_tpu_torch.ops import channelizer_fused
from rtlamr_tpu_torch.ops.channelizer_fused import (
    FIXED_TAPS,
    channelize_requantize_fused,
    channelize_requantize_plain,
    kernel_library,
)
from rtlamr_tpu_torch.ops.channelizer_mix import mix_op_count
from rtlamr_tpu_torch.ops.frontend import (
    decode_window_staged_packed,
    pack_results,
    run_window,
    unpack_results,
)
from rtlamr_tpu_torch.ops.search import lookahead_guards, search_kernel, search_slice
from rtlamr_tpu_torch.ops.spec import (
    lookahead_geometry,
    lookahead_spec,
    make_frontend_spec,
    packed_size,
    stage_host,
    staged_geometry,
)
from rtlamr_tpu_torch.ops.stencil import decode_stencil, lookahead_mask, masks_plain, stencil_plain
from rtlamr_tpu_torch.parallel import WidebandDecoder, WidebandMeshDecoder
from rtlamr_tpu_torch.parallel import wideband as wideband_mod
from rtlamr_tpu_torch.parallel import wideband_mesh as wideband_mesh_mod
from rtlamr_tpu_torch.parallel.mesh import MeshDecoder, dryrun, stage_superbatch
from rtlamr_tpu_torch.protocols import new_parser
from rtlamr_tpu_torch.protocols.base import build_decoder_config
from rtlamr_tpu_torch.ref import ReferenceDecoder, synth
from rtlamr_tpu_torch.utils import observability
from rtlamr_tpu_torch.utils.observability import TRACER

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE_BIN = os.path.join(ROOT, "tests", "fixtures", "sample.bin")
ALL = ("scm", "scm+", "idm", "r900")  # -msgtype=all
#: the hand-written kernels: csrc/decode_stencil.cu holds the first two
KERNELS = ("decode_stencil", "lookahead_mask", "channelizer", "search")
WIDE_CHANNELS = 12  # bench_wideband.py's N: the whole 902-928 MHz band
#: worker processes of the oracle run (the card machine has 8 cores)
ORACLE_WORKERS = 8

#: H100 SXM HBM rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer add, compare, logic, shift and multiply-add results per
#: clock per SM on Hopper (16 INT32 lanes in each of 4 partitions; CUDA C++
#: Programming Guide, throughput table, compute capability 9.0). Times the
#: SM count and the card's maximum SM clock, the decode stencil's bound.
INT32_PER_CLOCK_PER_SM = 64
#: float32 add and multiply instructions per clock per SM (32 FP32 lanes in
#: each of 4 partitions, the same table), also the SM's whole issue width.
#: The channelizer may fuse nothing, so each of its products and sums is one
#: such instruction: its bound counts them at this rate, not at the 67
#: TFLOP/s data-sheet figure, which counts an FMA as two operations.
FP32_INSTR_PER_CLOCK_PER_SM = 128

#: (block, meter ID, consumption) of the 14 SCM messages in sample.bin at
#: chip length 78 (tests/test_ref_decoder.py SAMPLE_BIN_GOLDEN).
SAMPLE_BIN_GOLDEN = [
    (4, 17580293, 111414),
    (8, 17578504, 243171),
    (13, 17479804, 798754),
    (17, 17564085, 102314),
    (23, 17563920, 101614),
    (27, 17565073, 1657255),
    (32, 58418772, 102814),
    (37, 17565099, 101614),
    (41, 17561667, 61799),
    (46, 17569243, 101714),
    (51, 31553606, 7120),
    (55, 17556728, 110714),
    (59, 17556726, 1407059),
    (68, 20240556, 3907400),
]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def build_capture(cfg, n_windows: int, window_samples: int, halo: int):
    """bench.py's all-protocol capture recipe (SCM, IDM and R900 bursts
    every PacketLength + 7 blocks in noise, seed 2), padded with zeros to a
    whole number of blocks so no planted packet is cut. Returns the u8 IQ
    and the planted set of (message type, meter id)."""
    total = halo + n_windows * window_samples
    bursts, planted = [], set()
    gap = cfg.packet_length + 7 * cfg.block_size
    offset = cfg.block_size
    i = 0
    while offset + cfg.packet_length < total:
        if i % 3 == 0:
            bits = synth.make_scm_bits(meter_id=1_000_000 + i, consumption=i)
            bursts.append(synth.bits_to_burst(bits, offset))
            planted.add(("SCM", 1_000_000 + i))
        elif i % 3 == 1:
            bits = synth.make_idm_bits(serial=2_000_000 + i)
            bursts.append(synth.bits_to_burst(bits, offset))
            planted.add(("IDM", 2_000_000 + i))
        else:
            digits = synth.make_r900_symbols(meter_id=3_000_000 + i)
            bursts.append(synth.r900_burst(digits, offset))
            planted.add(("R900", 3_000_000 + i))
        offset += gap
        i += 1
    iq = synth.render_iq(total, bursts, cfg.chip_length, noise=3.0, seed=2)
    padded = np.zeros(-(-iq.size // cfg.block_size2) * cfg.block_size2, np.uint8)
    padded[: iq.size] = iq
    return padded, planted


def staged_windows(spec, iq: np.ndarray, k: int) -> np.ndarray:
    """(k, staged_samples) u16 windows of a capture whose sample 0 is the
    stream's first sample: window i searches samples [i*W, (i+1)*W), as
    ``WindowDecoder.feed`` stages them."""
    geo = staged_geometry(spec)
    w, hs = spec.window, spec.halo_staged
    full = np.zeros((k - 1) * w + geo.staged_samples, np.uint16)
    u16 = iq.view(np.uint16)[: full.size - hs]
    full[hs : hs + u16.size] = u16
    return np.stack([full[i * w : i * w + geo.staged_samples] for i in range(k)])


def event_ms(fn, reps: int = 20, warm: int = 3, flush=None) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events
    around each call; ``flush`` (a large tensor) is zeroed before each call
    so the inputs come from device memory, not the 50 MB L2."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


class HostClock:
    """Host seconds spent inside named callables, accumulated per name.

    ``wrap(owner, name)`` replaces ``owner.name`` (an instance's method or a
    module's function) with a timed call of the same thing; ``restore()``
    puts every original back."""

    def __init__(self):
        self.s: dict = {}
        self._undo = []

    def wrap(self, owner, name: str) -> None:
        fn = getattr(owner, name)
        self.s[name] = 0.0

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[name] += time.perf_counter() - t

        self._undo.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, timed)

    def restore(self) -> None:
        for owner, name, old in reversed(self._undo):
            if old is None:
                delattr(owner, name)  # an instance attribute over the method
            else:
                setattr(owner, name, old)
        self._undo.clear()


def card_rate(per_clock_per_sm: int) -> float:
    """``per_clock_per_sm`` x the SM count x the maximum SM clock that
    nvidia-smi reports: a rate of the card, per second."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_clock_per_sm * sms * float(mhz) * 1e6


def stencil_work(spec, bits: torch.Tensor, int_rate: float):
    """(bytes, int ops, ms of bytes, ms of ops, bound ms, bound by) of the
    stencil function on this input: the staged buffer read once and bits,
    q6 and mask written once, at HBM_BYTES_PER_S; 32-bit integer operations
    at ``int_rate``, each part counted in the cheapest form the function is
    shown to take (the kernel's own, or less):

    - magnitude and running sum, 2 a sample read: one dp4a of the I and Q
      bytes against their complements, one multiply-add into the sum
      ((255 - 2x)^2 = 65025 - 4x(255 - x); the constant cancels in every
      filter);
    - Manchester bit, 3 a position: 2 for 2 W1 - W0 - W2 of prefix values,
      1 for the sign;
    - R900 symbol, 19 a position: 7 for a0, a1, a2 from five prefix values,
      3 absolute values, 3 for the strict argmax, 6 selects and adds;
    - preamble bank over 32-position words of packed bits: for each word
      and symbol k, one funnel shift and one xor-and for each group still
      alive in the word, while some group is; a group's word stops at the
      first symbol after which none of its positions matches, as this data
      needs. Packing the bits and unpacking the mask are not counted."""
    geo = staged_geometry(spec)
    sl, w = spec.symbol_length, spec.window
    r900 = spec.wants_r900
    n_bytes = 2 * geo.staged_samples + geo.lp + (geo.lq if r900 else 0) + w
    bank = bank_ops(spec, bits, w)
    n_read = geo.lp + sl + (4 * spec.chip_length if r900 else 0)
    ops = 2 * n_read + 3 * geo.lp + bank + (19 * geo.lq if r900 else 0)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    return n_bytes, ops, t_bytes, t_ops, max(t_bytes, t_ops), bound_by


def bank_ops(spec, bits: torch.Tensor, n: int) -> int:
    """32-bit integer operations of the preamble bank over the first ``n``
    positions of ``bits``, in 32-position words: for each word and symbol
    k, one word of bits k SL on (a funnel shift in K1, a ballot in the
    look-ahead's kernel) and one xor-and for each group still alive in the
    word, while some group is; a group's word stops at the first symbol
    after which none of its positions matches, as this data needs."""
    sl = spec.symbol_length
    n_words = -(-n // 32)
    max_len = max(len(g.bits) for g in spec.groups)
    # live[g][k]: words in which group g has a position alive before symbol k.
    live = torch.zeros(len(spec.groups), max_len, n_words, dtype=torch.bool,
                       device=bits.device)
    for gi, g in enumerate(spec.groups):
        alive = torch.zeros(32 * n_words, dtype=torch.bool, device=bits.device)
        alive[:n] = True
        for k, b in enumerate(g.bits):
            live[gi, k] = alive.view(n_words, 32).any(1)
            alive[:n] &= bits[k * sl : k * sl + n] == b
    return int(live.sum()) + int(live.any(0).sum())


#: spin kernels (``torch.cuda._sleep``) that open each torch.profiler
#: session, and the clock cycles of each, about 1 ms at 1.98 GHz
PROFILE_OPENERS, OPENER_CYCLES = 8, 2_000_000
#: the spin kernel's name in the profiler's record
OPENER_KERNEL = "spin_kernel"


@contextlib.contextmanager
def device_profile():
    """torch.profiler over CPU and CUDA activity, opened by PROFILE_OPENERS
    spin kernels that no caller counts. Once the process has run about 30
    s, a session's record loses its first one to three kernels, whatever
    the host waits first (seen on an H100 with torch 2.11: 19 of 20
    launches recorded); the spin kernels take that loss."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_OPENERS):
            torch.cuda._sleep(OPENER_CYCLES)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def kernel_ms(fn, kernel: str, reps: int = 20, warm: int = 3, flush=None,
              per_call: int = 1) -> float:
    """Mean device time a call of ``fn`` spends in the ``per_call`` CUDA
    kernels whose names hold ``kernel``, over ``reps`` calls, from
    torch.profiler's record of them (so no host gap is counted), with
    ``flush`` zeroed before each call as in :func:`event_ms`. Raises when
    the profiler did not record every launch."""
    from torch.autograd import DeviceType

    for _ in range(warm):
        fn()
    with device_profile() as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in rows)
    if n != reps * per_call:
        starts = sorted(e.time_range.start for e in prof.events()
                        if e.device_type == DeviceType.CUDA and kernel in e.key)
        gaps = [round(b - a) for a, b in zip(starts, starts[1:])]
        check(False, f"profiler: {n} launches of {kernel} recorded for {reps} calls; "
              f"us between recorded starts {gaps}")
    return sum(e.self_device_time_total for e in rows) / reps / 1e3


def profile_window(fn):
    """torch.profiler over one call of ``fn``: the number of CUDA kernels it
    ran, their summed device time in ms, and the six with the most device
    time as (name, calls, ms). All are empty or 0 when the profiler records
    no device activity."""
    from torch.autograd import DeviceType

    fn()
    with device_profile() as prof:
        fn()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and OPENER_KERNEL not in e.key]

    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in rows[:6]]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return sum(e.count for e in rows), busy_ms, top


def phase_device():
    card = card_line()
    print(card, flush=True)
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return card


def ptxas_lines(name: str):
    """What ``-Xptxas -v`` said about registers, shared memory and spills."""
    log = str(build.BUILD_LOG[name]["log"])
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "smem" in ln or "spill" in ln]


def phase_build():
    t0 = time.perf_counter()
    # the channelizer's libraries: each (N, tap class) that phase k2 launches,
    # which covers the wideband paths' N = 12 and 4 at 8 taps, and the
    # channel blocks of phase wide_mesh
    libs = list(build.build_many(["decode_stencil", "search"] + list(dict.fromkeys(
        kernel_library(n, p == FIXED_TAPS) for n, p in K2_CASES)) + [
        kernel_library(n, True, c0, rows) for n, c0, rows in K2_BLOCKS]))  # one nvcc each, together
    secs = time.perf_counter() - t0
    emit("build", kernels=list(KERNELS), seconds=round(secs, 3),
         nvcc_seconds={k: round(float(build.BUILD_LOG[k]["seconds"]), 3) for k in libs},
         ptxas={"decode_stencil": ptxas_lines("decode_stencil"),
                "channelizer": ptxas_summary("channelizer"),
                "search": ptxas_summary("search")})


def ptxas_summary(name: str) -> dict:
    """Entries, most registers and spilled bytes over the entries of
    ``csrc/<name>.cu`` (each entry's own in the k2_time line)."""
    ent = ptxas_by_entry(name)
    return {"entries": len(ent), "max_registers": max((r[0] or 0) for r in ent.values()),
            "spill_bytes": sum((r[1] or 0) + (r[2] or 0) for r in ent.values())}


def k1_cases(capture: np.ndarray):
    """(spec, label, staged u16 window) of the k1 phase: the throughput spec
    at full width on random, planted, all-zero (each magnitude 130,050, so
    a strip's uint32 prefix wraps; every bit 1) and 0x8080 (ties) windows;
    SCM only at chip length 78 (no q6) on random bytes and the golden
    capture; chip length 8 at 4 blocks (fewer strips than SMs)."""
    spec72 = make_frontend_spec(build_decoder_config([new_parser(n, 72) for n in ALL]), 1024)
    spec78 = make_frontend_spec(build_decoder_config([new_parser("scm", 78)]), 1024)
    spec8 = make_frontend_spec(build_decoder_config([new_parser(n, 8) for n in ALL]), 4)
    rng = np.random.default_rng(7)

    def rand(spec):
        n = staged_geometry(spec).staged_samples
        return rng.integers(0, 256, 2 * n, dtype=np.uint8).view(np.uint16)

    def const(spec, value):
        return np.full(staged_geometry(spec).staged_samples, value, np.uint16)

    return [
        (spec72, "all@72x1024:random", rand(spec72)),
        (spec72, "all@72x1024:packets", staged_windows(spec72, capture, 1)[0]),
        (spec72, "all@72x1024:zeros", const(spec72, 0)),
        (spec72, "all@72x1024:0x8080", const(spec72, 0x8080)),
        (spec78, "scm@78x1024:random", rand(spec78)),
        (spec78, "scm@78x1024:packets",
         staged_windows(spec78, np.fromfile(SAMPLE_BIN, np.uint8), 1)[0]),
        (spec8, "all@8x4:random", rand(spec8)),
        (spec8, "all@8x4:zeros", const(spec8, 0)),
    ]


def phase_k1(card: str, capture: np.ndarray):
    dev = torch.device("cuda")
    cases = k1_cases(capture)
    spec72 = cases[0][0]
    max_err = 0
    for spec, label, host in cases:
        staged = torch.from_numpy(host).to(dev)
        for first in (True, False):
            got = decode_stencil(spec, staged, first)
            want = stencil_plain(spec, staged, first)
            torch.cuda.synchronize()
            for name, a, b in zip(("bits", "q6", "mask"), got, want):
                check((a is None) == (b is None), f"k1 {label} {name}: presence")
                if a is None:
                    continue
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"k1 {label} {name}: shape/dtype {a.shape} {b.shape}")
                err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(a, b), f"k1 {label} first={first} {name}: "
                      f"{int((a != b).sum())} positions differ")
            if label.endswith(":zeros") and not first:
                check(bool(got[0].all()), f"k1 {label}: a bit is 0 where every f is 0")
        emit("k1_parity", case=label, first=[True, False], exact=True)

    # Time at the throughput spec, on the planted-packet window.
    staged = torch.from_numpy(cases[1][2]).to(dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = event_ms(lambda: decode_stencil(spec72, staged, False), flush=flush)
    k_ms = kernel_ms(lambda: decode_stencil(spec72, staged, False), "decode_stencil_kernel",
                     flush=flush)
    plain_ms = event_ms(lambda: stencil_plain(spec72, staged, False), flush=flush)
    bits = stencil_plain(spec72, staged, False)[0]
    rate = card_rate(INT32_PER_CLOCK_PER_SM)
    n_bytes, ops, bytes_ms, ops_ms, bound_ms, bound_by = stencil_work(spec72, bits, rate)
    del flush
    emit("k1_time", card=card, spec="all@72x1024", ms=ms, kernel_ms=k_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes, bytes_ms=bytes_ms,
         int_ops=ops, int32_ops_per_s=rate, ops_ms=ops_ms,
         roofline_share=bound_ms / k_ms, roofline_share_events=bound_ms / ms,
         max_abs_err=max_err, ptxas=ptxas_lines("decode_stencil"))
    return {"ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max_err}


def phase_cli() -> int:
    argv = ["-msgtype=scm", "-symbollength=78", "-format=json",
            f"-fromfile={SAMPLE_BIN}", "-duration=0", "-windowblocks=16"]
    decode_stencil.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    launches = decode_stencil.launches
    check(rc == 0, f"cli: exit code {rc}")
    recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    got = [(r["Message"]["ID"], r["Message"]["Consumption"]) for r in recs]
    check(got == [(i, c) for _, i, c in SAMPLE_BIN_GOLDEN],
          f"cli: {len(got)} messages, not the 14 golden ones: {got}")
    check(launches > 0, "cli: the decode stencil kernel was not launched")
    # The same capture through the library boundary, with block indices; then
    # with one candidate slot a window, so windows overflow and escalate to
    # the high-capacity program on the card and, when that is cut down to
    # overflow too, to the exact host path.
    iq = np.fromfile(SAMPLE_BIN, np.uint8)
    overflows = []
    for max_hits, exact in ((256, False), (1, False), (1, True)):
        dec = WindowDecoder([new_parser("scm", 78)], window_blocks=16,
                            max_hits=max_hits)
        if exact:
            dec._big_spec_cache = dataclasses.replace(
                dec.spec, max_hits=1, gather_hits=4, slice_hits=2, gather_rows=1)
        blocks = [(b, m.ID, m.Consumption) for b, m in dec.decode_capture(iq)]
        check(blocks == SAMPLE_BIN_GOLDEN,
              f"library (max_hits={max_hits}, exact={exact}): {blocks}")
        overflows.append(dec.metrics.hit_overflows)
    check(overflows[0] == 0 and min(overflows[1:]) > 0,
          f"library: overflow escalations {overflows}")
    emit("cli", messages=len(got), golden=True, launches=launches,
         escalations=overflows)
    return launches


def phase_decode(card: str, iq: np.ndarray, planted: set):
    def fresh():
        return WindowDecoder([new_parser(n, 72) for n in ALL],
                             window_blocks=1024, max_hits=256)

    dec = fresh()
    chunk = max(dec.cfg.block_size2, 1 << 18)  # the CLI's chunk size

    def feed_all(d):
        msgs = []
        for pos in range(0, iq.size, chunk):
            msgs.extend(d.feed(iq[pos : pos + chunk]))
        msgs.extend(d.flush())
        return msgs

    feed_all(fresh())  # warm-up: allocator and pinned-memory pools
    torch.cuda.synchronize()

    # Where the feed path's host time goes. The timed calls nest:
    # _process_window > process_host_staged > {the window program's enqueue,
    # _dispatch > _complete_inflight > {fetch, complete > _parse_window},
    # enqueue_fetch}; flush's drain calls _complete_inflight outside _dispatch.
    clock = HostClock()
    for name in ("_process_window", "process_host_staged", "_dispatch",
                 "_complete_inflight", "_parse_window"):
        clock.wrap(dec, name)
    for name in ("decode_window_staged_packed", "fetch", "enqueue_fetch"):
        clock.wrap(pipeline_mod, name)
    decode_stencil.launches = lookahead_mask.launches = search_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        msgs = feed_all(dec)
    finally:
        clock.restore()
    elapsed = time.perf_counter() - t0
    launches, la_launches = decode_stencil.launches, lookahead_mask.launches
    search_launches = search_kernel.launches
    s = clock.s
    n_win = dec.metrics.windows_decoded
    host_ms = {k: v * 1e3 / n_win for k, v in {
        "stage": s["_process_window"] - s["process_host_staged"],
        "h2d": (s["process_host_staged"] - s["decode_window_staged_packed"]
                - s["_dispatch"] - s["enqueue_fetch"]),
        "enqueue_window_program": s["decode_window_staged_packed"],
        "enqueue_d2h": s["enqueue_fetch"],
        "wait_for_card": s["fetch"],
        "parse": s["_parse_window"],
        "unpack": s["_complete_inflight"] - s["fetch"] - s["_parse_window"],
        "feed_other": elapsed - s["_process_window"]
        - (s["_complete_inflight"] - s["_dispatch"]),
    }.items()}
    got = {(m.msg_type(), m.meter_id()) for _, m in msgs}
    check(got == planted, f"decode: missing {sorted(planted - got)[:8]}, "
          f"extra {sorted(got - planted)[:8]}")
    check(len(msgs) == len(planted), f"decode: {len(msgs)} messages for "
          f"{len(planted)} planted packets")
    check(launches > 0, "decode: the decode stencil kernel was not launched")
    # every window but the stream's first and the flush's short one looks ahead
    check(la_launches == launches - 2,
          f"decode: {la_launches} look-ahead mask launches for {launches} windows")
    # one search a window program (escalations included) and a look-ahead
    check(search_launches == launches + la_launches,
          f"decode: {search_launches} search launches for {launches} windows and "
          f"{la_launches} look-aheads")

    # Where the device time of one window goes (a planted window, not first).
    spec = dec.spec
    staged = torch.from_numpy(staged_windows(spec, iq, 2)[1]).cuda()
    no_gates = dataclasses.replace(spec, device_validate=False)
    window_ms = event_ms(lambda: decode_window_staged_packed(spec, staged, False), reps=10)
    no_gate_ms = event_ms(lambda: decode_window_staged_packed(no_gates, staged, False), reps=10)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        decode_window_staged_packed(spec, staged, False)
    enqueue_ms = (time.perf_counter() - t) / 5 * 1e3
    torch.cuda.synchronize()
    kernels, busy_ms, top = profile_window(lambda: decode_window_staged_packed(spec, staged, False))
    samples = iq.size // 2
    emit("decode", card=card, windows=dec.metrics.windows_decoded,
         messages=len(msgs), planted=len(planted), launches=launches,
         lookahead_launches=la_launches, search_launches=search_launches, samples=samples, seconds=elapsed, samples_per_s=samples / elapsed,
         hit_overflows=dec.metrics.hit_overflows,
         host_ms_per_window=host_ms,
         window_program_ms=window_ms, window_program_no_gates_ms=no_gate_ms,
         window_program_host_enqueue_ms=enqueue_ms,
         window_program_kernels=kernels, window_program_kernel_ms=busy_ms,
         window_program_top_kernels=top)
    return msgs, (launches, la_launches, search_launches), host_ms


def phase_batch(iq: np.ndarray, want_msgs) -> int:
    dec = WindowDecoder([new_parser(n, 72) for n in ALL], window_blocks=1024,
                        max_hits=256)
    k = -(-(iq.size // 2) // dec.spec.window)
    batch = torch.from_numpy(staged_windows(dec.spec, iq, k)).cuda()
    decode_stencil.launches = 0
    msgs = dec.decode_staged_batch(batch)
    launches = decode_stencil.launches
    got = [(b, str(m)) for b, m in msgs]
    want = [(b, str(m)) for b, m in want_msgs]
    check(got == want, f"batch: {len(got)} messages differ from the feed "
          f"path's {len(want)}")
    check(launches > 0, "batch: the decode stencil kernel was not launched")
    dec.reset()
    seq = [(b, str(m)) for b, m in dec.decode_staged(list(batch))]
    check(seq == want, "decode_staged: the stream differs from the feed path's")
    # run_window on the raw u8 bytes of windows 0 and 1, halo first (zeros
    # before the stream), equal to the decode of the host-staged buffer.
    spec = dec.spec
    w, halo = spec.window, spec.halo
    raw = np.concatenate([np.zeros(2 * halo, np.uint8), iq[: 4 * w]])
    host_staged = [unpack_results(spec, decode_window_staged_packed(
        spec, batch[i], i == 0).cpu().numpy()) for i in range(2)]
    decode_stencil.launches = 0
    by_run_window = [run_window(spec, raw[2 * i * w : 2 * ((i + 1) * w + halo)], i == 0)
                     for i in range(2)]
    rw_launches = decode_stencil.launches
    check(rw_launches == 2, f"run_window: {rw_launches} K1 launches for 2 windows")
    for i, (got_i, want_i) in enumerate(zip(by_run_window, host_staged)):
        check(results_equal(got_i, want_i),
              f"run_window: window {i} differs from the host-staged decode")
    emit("batch", windows=k, messages=len(got), equal_to_feed=True,
         staged_equal_to_feed=True, launches=launches,
         run_window_equal_to_host_staged=True, run_window_launches=rw_launches)
    return launches, rw_launches


def lookahead_cases(capture: np.ndarray):
    """(spec, label, staged u16 window) of the lookahead phase: the
    benchmark cell's shape (``-msgtype=all``, chip length 72, 16-block
    windows) on planted windows 1 and 5 of the decode phase's capture, on
    random bytes and all-zero (every bit 1, so every preamble bit of 1
    matches); the ``-latency`` preset's 4-block windows on a planted window;
    all six types at chip length 8 on random bytes."""
    cfg72 = build_decoder_config([new_parser(n, 72) for n in ALL])
    spec16 = make_frontend_spec(cfg72, 16)
    spec4 = make_frontend_spec(cfg72, 4)
    six = ("scm", "scm+", "idm", "netidm", "r900", "r900bcd")
    spec8 = make_frontend_spec(build_decoder_config([new_parser(n, 8) for n in six]), 24)
    rng = np.random.default_rng(11)

    def rand(spec):
        n = staged_geometry(spec).staged_samples
        return rng.integers(0, 256, 2 * n, dtype=np.uint8).view(np.uint16)

    return [
        (spec16, "all@72x16:packets1", staged_windows(spec16, capture, 2)[1]),
        (spec16, "all@72x16:packets5", staged_windows(spec16, capture, 6)[5]),
        (spec16, "all@72x16:random", rand(spec16)),
        (spec16, "all@72x16:zeros", np.zeros(staged_geometry(spec16).staged_samples, np.uint16)),
        (spec4, "all@72x4:packets", staged_windows(spec4, capture, 10)[9]),
        (spec8, "six@8x24:random", rand(spec8)),
    ]


def lookahead_want(spec, bits: torch.Tensor) -> torch.Tensor:
    """``masks_plain`` over the look-ahead's positions of ``bits``."""
    n = lookahead_geometry(spec).extent
    return masks_plain(dataclasses.replace(spec, window=n), bits[spec.window:])


def phase_lookahead(card: str, iq: np.ndarray, planted: set):
    dev = torch.device("cuda")
    hits = {}
    for spec, label, host in lookahead_cases(iq):
        bits = decode_stencil(spec, torch.from_numpy(host).to(dev), False)[0]
        got = lookahead_mask(spec, bits)
        want = lookahead_want(spec, bits)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"lookahead {label}: shape/dtype {got.shape} {want.shape}")
        check(torch.equal(got, want), f"lookahead {label}: "
              f"{int((got != want).sum())} positions differ")
        hits[label] = int((got != 0).sum())
    check(hits["all@72x16:packets1"] + hits["all@72x16:packets5"] > 0,
          "lookahead: no preamble hit in the planted windows' look-ahead")
    emit("lookahead_parity", cases=list(hits), exact=True, hit_positions=hits)

    # The -latency receiver at the cell's window on the decode phase's
    # capture: the throughput preset's records, the mask kernel launched
    # once a window looked ahead.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capture.bin")
        iq.tofile(path)
        base = ["-msgtype=all", "-format=json", f"-fromfile={path}", "-duration=0"]
        rc, want, _ = run_cli(base)
        check(rc == 0, f"lookahead: throughput CLI exit code {rc}")
        calls = {"ahead": 0, "all": 0}
        orig = pipeline_mod.decode_window_staged_packed

        def counted(*args, **kwargs):
            calls["all"] += 1
            calls["ahead"] += bool(kwargs.get("lookahead"))
            return orig(*args, **kwargs)

        TRACER.reset()
        observability.enable()
        pipeline_mod.decode_window_staged_packed = counted
        decode_stencil.launches = lookahead_mask.launches = 0
        try:
            rc, got, _ = run_cli(base + ["-latency", "-windowblocks=16"])
            launches, k1 = lookahead_mask.launches, decode_stencil.launches
            totals = TRACER.snapshot().totals
        finally:
            pipeline_mod.decode_window_staged_packed = orig
            observability.disable()
            TRACER.reset()
    engaged = totals.get("pipeline.lookahead", (0,))[0]
    check(rc == 0, f"lookahead: -latency CLI exit code {rc}")
    check(got == want, f"lookahead: -latency gives {len(got)} records, the throughput "
          f"preset {len(want)}, or they differ")
    check(len(got) == len(planted),
          f"lookahead: {len(got)} records for {len(planted)} planted packets")
    check(calls["ahead"] > 0 and launches == calls["ahead"],
          f"lookahead: {launches} mask kernel launches for {calls['ahead']} windows looked ahead")
    check(k1 == calls["all"], f"lookahead: {k1} K1 launches for {calls['all']} windows")
    check(engaged > 0, "lookahead: no window's look-ahead resolved a block")
    emit("lookahead", card=card, records=len(got), windows=calls["all"],
         windows_looked_ahead=calls["ahead"], mask_launches=launches, k1_launches=k1,
         lookahead_spans=engaged)
    return launches


def phase_lookahead_time(card: str, iq: np.ndarray):
    dev = torch.device("cuda")
    spec, _, host = lookahead_cases(iq)[0]
    bits = decode_stencil(spec, torch.from_numpy(host).to(dev), False)[0]
    n = lookahead_geometry(spec).extent
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = event_ms(lambda: lookahead_mask(spec, bits), flush=flush)
    k_ms = kernel_ms(lambda: lookahead_mask(spec, bits), "lookahead_mask_kernel", flush=flush)
    plain_ms = event_ms(lambda: lookahead_want(spec, bits), flush=flush)
    del flush
    reach = staged_geometry(spec).pre_reach
    n_bytes = (n + reach) + n  # the bits read once, the mask written once
    ops = bank_ops(spec, bits[spec.window:], n)
    rate = card_rate(INT32_PER_CLOCK_PER_SM)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / rate * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    emit("lookahead_time", card=card, spec="all@72x16", positions=n, ms=ms, kernel_ms=k_ms,
         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
         bytes_ms=bytes_ms, int_ops=ops, ops_ms=ops_ms, roofline_share=bound_ms / k_ms,
         roofline_share_events=bound_ms / ms)
    return {"ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def all_types_window(spec) -> np.ndarray:
    """A staged window of ``spec`` (16 blocks, ``-msgtype=all``) that finds
    one packet of each type: SCM, SCM+, R900 and IDM bursts, one after the
    other, all starting in the samples window 1 searches (``window -
    halo`` on, a hit marking a packet's start), window 1 staged."""
    w, b = spec.window, spec.block_size
    first = w - spec.halo
    bursts = [
        synth.bits_to_burst(synth.make_scm_bits(meter_id=1_000_001, consumption=7), first + b),
        synth.bits_to_burst(synth.make_scmplus_bits(endpoint_id=4_000_002, consumption=8),
                            first + 7 * b // 2),
        synth.r900_burst(synth.make_r900_symbols(meter_id=3_000_003), first + 13 * b // 2),
        synth.bits_to_burst(synth.make_idm_bits(serial=2_000_004), first + 19 * b // 2),
    ]
    iq = synth.render_iq(3 * w + spec.halo, bursts, spec.chip_length, noise=3.0, seed=2)
    return staged_windows(spec, iq, 2)[1]


def dense_mask(mask2d: torch.Tensor, n_groups: int, seed: int = 17) -> torch.Tensor:
    """A mask of ``mask2d``'s shape with each group's bit set at one
    position in 16, at random: every capacity overflows."""
    rng = np.random.default_rng(seed)
    hits = rng.random((*mask2d.shape, n_groups)) < 1 / 16
    out = (hits.astype(np.uint8) << np.arange(n_groups, dtype=np.uint8)).sum(-1)
    out = out.astype(np.uint8)
    return torch.from_numpy(out).to(mask2d.device)


def search_cases(capture: np.ndarray):
    """(spec, label, staged u16 window, look-ahead, dense mask) of the
    search phase: the benchmark cell's spec (``-msgtype=all``, chip length
    72, 16-block windows) on planted windows 1 and 5 of the decode phase's
    capture, on a window that keeps a packet of every type, on random
    bytes, and under a dense planted mask, with its look-ahead but for the
    last; the throughput spec (1024 blocks) on a planted window;
    escalation's high-capacity spec of both on a planted window."""
    specs = {n: WindowDecoder([new_parser(x, 72) for x in ALL], window_blocks=n,
                              max_hits=256) for n in (16, 1024)}
    rng = np.random.default_rng(13)
    spec16, spec1024 = specs[16].spec, specs[1024].spec
    n16 = staged_geometry(spec16).staged_samples
    every = all_types_window(spec16)
    return [
        (spec16, "all@72x16:packets1", staged_windows(spec16, capture, 2)[1], True, False),
        (spec16, "all@72x16:packets5", staged_windows(spec16, capture, 6)[5], True, False),
        (spec16, "all@72x16:all_types", every, True, False),
        (spec16, "all@72x16:random",
         rng.integers(0, 256, 2 * n16, dtype=np.uint8).view(np.uint16), True, False),
        (spec16, "all@72x16:dense", every, False, True),
        (spec1024, "all@72x1024:packets", staged_windows(spec1024, capture, 1)[0], False, False),
        (specs[16]._big_spec(), "all@72x16-big:packets1", staged_windows(spec16, capture, 2)[1],
         False, False),
        (specs[1024]._big_spec(), "all@72x1024-big:packets",
         staged_windows(spec1024, capture, 1)[0], False, False),
    ]


def search_plain(spec, bits, q6, mask2d) -> torch.Tensor:
    return pack_results(search_slice(spec, bits, q6, mask2d))


#: the search phase's timed cases; the kernels line takes the first, the
#: cell's shape with a packet of every type kept
SEARCH_TIMED = ("all@72x16:all_types", "all@72x16:packets1", "all@72x1024:packets")


def phase_search(card: str, iq: np.ndarray):
    dev = torch.device("cuda")
    kept, raw, inputs = {}, {}, {}
    for spec, label, host, ahead, dense in search_cases(iq):
        bits, q6, mask2d = decode_stencil(spec, torch.from_numpy(host).to(dev), False)
        if dense:
            mask2d = dense_mask(mask2d, len(spec.groups))
        inputs[label] = (spec, (bits, q6, mask2d))
        pairs = [("window", search_kernel(spec, bits, q6, mask2d),
                  search_plain(spec, bits, q6, mask2d))]
        if ahead:
            w, la = spec.window, lookahead_spec(spec)
            amask = lookahead_mask(spec, bits)
            pairs.append(("lookahead",
                          search_kernel(la, bits[w:], q6[w:], amask, lookahead_geometry(spec).fits),
                          torch.cat([search_plain(la, bits[w:], q6[w:], amask),
                                     lookahead_guards(spec, amask).view(torch.uint8)])))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            check(got.shape == want.shape, f"search {label} {name}: size {got.shape} {want.shape}")
            check(torch.equal(got, want), f"search {label} {name}: "
                  f"{int((got != want).sum())} bytes differ")
        res = unpack_results(spec, pairs[0][1].cpu().numpy())
        kept[label] = [int(x) for x in res["counts"][:, 1]]
        raw[label] = [int(x) for x in res["counts"][:, 0]]
    check(min(kept["all@72x16:all_types"]) >= 1,
          f"search: a type kept no packet in the all-types window: {kept['all@72x16:all_types']}")
    k_gather = inputs["all@72x16:dense"][0].gather_hits
    check(min(raw["all@72x16:dense"]) > k_gather,
          f"search: the dense mask overflowed no capacity: {raw['all@72x16:dense']}")
    emit("search_parity", cases=list(kept), exact=True, kept=kept, raw=raw)

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    # The launch floor: three empty kernels replayed from a CUDA graph, as
    # the search's three are on the main path.
    empty = torch.cuda.CUDAGraph()
    with torch.cuda.graph(empty, stream=torch.cuda.Stream(dev)):
        for _ in range(3):
            torch.cuda._sleep(0)
    floor_ms = event_ms(empty.replay)
    out = {}
    for label in SEARCH_TIMED:
        spec, args = inputs[label]
        ms = event_ms(lambda: search_kernel(spec, *args), flush=flush)
        k_ms = kernel_ms(lambda: search_kernel(spec, *args), "search_", flush=flush, per_call=3)
        plain_ms = event_ms(lambda: search_plain(spec, *args), reps=5, flush=flush)
        n_bytes = spec.window + packed_size(spec)  # the mask read, the buffer written
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # kernel_ms (the kernels' own device time) is held to the bytes; ms
        # (by events, the gaps between launches included) to the larger of
        # the bytes and the launch floor, which is timed the same way.
        out[label] = {"ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms, "bound_ms": bytes_ms,
                      "bound_by": "bytes", "launch_floor_ms": floor_ms, "kept": kept[label]}
        emit("search_time", card=card, spec=label, kept=kept[label], ms=ms, kernel_ms=k_ms,
             plain_ms=plain_ms, bytes=n_bytes, bound_ms=bytes_ms, bound_by="bytes",
             roofline_share=bytes_ms / k_ms, launch_floor_ms=floor_ms,
             floor_share_events=max(bytes_ms, floor_ms) / ms, ptxas=ptxas_summary("search"))
    del flush
    return {"by_shape": out, **out[SEARCH_TIMED[0]]}


def results_equal(a, b) -> bool:
    """Whether two unpacked window results (dicts of arrays, lists of
    arrays) are equal element for element."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(results_equal(a[x], b[x]) for x in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(results_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def channelizer_work(spec: ChannelizerSpec, frames: int, rate: float, c0: int = 0,
                     rows: int = 0) -> dict:
    """What the channelizer function needs on this input: bytes (the chunk
    and the history read once, the C channel rows written once; C = N, or
    the ``rows`` of a channel block from ``c0``) at
    HBM_BYTES_PER_S, and instructions at ``rate``, none fused, each part
    counted in its cheapest exact form. A frame takes 4 N P - 2 N for the
    branches (a product and a sum a tap and component, each chain starting
    with its first product, not 0 + it), 6 N for the DC removal (two bit
    operations and a subtraction a component: the byte into the float 2^22
    + byte, minus 2^22 + 127.5), 9 N for the requantize (an add, a max, a
    min and the rounding add a component, one byte permute), and the DFT mix
    counted from the float32 tables (ops/channelizer_mix.py ``mix_op_count``:
    one product a distinct coefficient magnitude of a branch, none for 1,
    nothing for 0, a copy for each accumulator's first accumulation).
    Leaving out a ``0 +`` or a product by 0 changes only a zero's sign, which
    the requantize cannot see. In the reference's order the branches take 4
    N P and the mix 8 N^2. The bound is the larger of the bytes' time and the
    cheapest count's. A block runs every branch and DC removal, and the mix
    (8 N C in the reference's order) and the requantize of its C rows."""
    n, p = spec.n_channels, spec.taps_per_branch
    c = rows or n
    n_bytes = 2 * n * frames + 2 * n * p + 2 * c * frames
    muls, adds = mix_op_count(n, c0, c)
    ops = frames * (4 * n * p - 2 * n + 6 * n + 9 * c + muls + adds)
    ops_ref = frames * (4 * n * p + 6 * n + 9 * c + 8 * n * c)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops, t_ref = ops / rate * 1e3, ops_ref / rate * 1e3
    return {"bytes": n_bytes, "bytes_ms": t_bytes, "f32_instr": ops, "f32_instr_ms": t_ops,
            "f32_instr_reference_order": ops_ref, "bound_ms": max(t_bytes, t_ops),
            "bound_ms_reference_order": max(t_bytes, t_ref),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_by_entry(name: str) -> dict:
    """What ``-Xptxas -v`` said of each kernel entry of ``csrc/<name>.cu``
    over the libraries it is built as:
    {entry: [registers, spill stores, spill loads]}, an entry of a library
    named for its instantiation by that name (``N12P8`` for
    ``channelizer.n12p8``, all 12 rows, and ``N12C6x6P8`` for
    ``channelizer.n12c6x6p8``, the block of rows 6 to 11)."""
    out = {}
    for lib, v in build.BUILD_LOG.items():
        if lib.partition(".")[0] != name:
            continue
        m = re.fullmatch(r"n(\d+)(?:c(\d+)x(\d+))?p(\d+)", lib.partition(".")[2])
        label = (f"N{m[1]}P{m[4]}" if m[2] is None else f"N{m[1]}C{m[2]}x{m[3]}P{m[4]}") if m else None
        entry = None
        for ln in str(v["log"]).splitlines():
            e = re.search(r"Compiling entry function '(\w+)'", ln)
            if e:
                entry = label or e.group(1)
                out[entry] = [None, None, None]
            elif entry and "spill stores" in ln:
                st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
                out[entry][1:] = [int(st.group(1)), int(st.group(2))]
            elif entry and "registers" in ln:
                out[entry][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def u16_diff(a: torch.Tensor, b: torch.Tensor):
    """(positions that differ, largest difference of one u8 component)."""
    x, y = a.to(torch.int32), b.to(torch.int32)
    err = max(int(((x & 255) - (y & 255)).abs().max()), int(((x >> 8) - (y >> 8)).abs().max()))
    return int((x != y).sum()), err


def random_u16(rng, n_elems: int, dev) -> torch.Tensor:
    """Seeded random interleaved u8 IQ as its u16 pair view, on ``dev``."""
    return torch.from_numpy(rng.integers(0, 256, 2 * n_elems, dtype=np.uint8).view(np.uint16)).to(dev)


#: (N, P) of the k2 parity phase: every compiled-in N class at P = 8 and
#: the runtime tap loop at P = 4 and 12
K2_CASES = [(n, 8) for n in (1, 2, 3, 4, 5, 8, 12, 16, 31, 32)] + [(12, 4), (12, 12)]
#: the wide_mesh phase's layout: (channel shards, time shards) of the
#: 12-channel decoder, its windows a time shard, and its channel blocks
#: (N, c0, rows), the K2 instantiations it launches besides the full one;
#: its CLI runs take two cards' devices, which the CLI lays out as (2, 1)
WIDE_MESH, WIDE_MESH_SCAN, WIDE_MESH_CLI_DEVICES = (2, 2), 1, 2
K2_BLOCKS = [(WIDE_CHANNELS, c0, WIDE_CHANNELS // WIDE_MESH[0])
             for c0 in range(0, WIDE_CHANNELS, WIDE_CHANNELS // WIDE_MESH[0])]


def phase_k2(card: str):
    dev = torch.device("cuda")
    # ragged: at 2 frames a thread and 512 a tile the last tile holds 125
    # frames and its last thread one; 37 frames are less than one tile
    max_err = 0
    for n, p in K2_CASES:
        spec = ChannelizerSpec(n_channels=n, taps_per_branch=p)
        rng = np.random.default_rng(100 + n + p)
        for f in (3 * 8192 + 640 + 37, 37):
            s1, s2 = random_u16(rng, n * f, dev), random_u16(rng, n * f + 1, dev)
            zero = torch.zeros(p * n, dtype=torch.uint16, device=dev)
            hist2 = random_u16(rng, p * n, dev)
            for label, hist, chunk, first in (("head", zero, s1, True),
                                              ("carried", hist2, s2[: n * f], False),
                                              ("misaligned", hist2, s2[1:], False)):
                got = channelize_requantize_fused(spec, hist, chunk, first)
                want = channelize_requantize_plain(spec, hist, chunk, first)
                torch.cuda.synchronize()
                check(got.shape == want.shape == (n, f) and got.dtype == want.dtype,
                      f"k2 N={n} P={p} {label}: shape/dtype {got.shape} {want.shape}")
                differ, err = u16_diff(got, want)
                max_err = max(max_err, err)
                check(differ == 0, f"k2 N={n} P={p} F={f} {label}: {differ} samples differ "
                      f"(max {err} LSB)")
                # Into rows wider than the frames, at an odd column: nothing
                # is written outside the view.
                rows = torch.zeros((n, f + 256), dtype=torch.uint16, device=dev)
                channelize_requantize_fused(spec, hist, chunk, first, out=rows[:, 3 : 3 + f])
                torch.cuda.synchronize()
                check(torch.equal(rows[:, 3 : 3 + f].view(torch.int16), want.view(torch.int16))
                      and not bool(rows[:, :3].view(torch.int16).any())
                      and not bool(rows[:, 3 + f :].view(torch.int16).any()),
                      f"k2 N={n} P={p} F={f} {label}: strided output differs or overruns")
        emit("k2_parity", n=n, p=p, frames=[3 * 8192 + 640 + 37, 37],
             histories=["head", "carried", "misaligned"], exact=True)

    # The channel blocks the wideband mesh launches: byte-equal to the same
    # rows of the full launch and to the plain version of the block, at the
    # mesh's shape (one time shard's frames, into a staged row buffer at
    # the halo's offset) and at a ragged one.
    for n, c0, rows in K2_BLOCKS:
        spec = ChannelizerSpec(n_channels=n)
        p = spec.history_frames
        rng = np.random.default_rng(200 + c0)
        for f in (8 * 1024 * 1024, 3 * 8192 + 640 + 37):
            chunk, hist = random_u16(rng, n * f, dev), random_u16(rng, n * p, dev)
            for first in (True, False):
                full = channelize_requantize_fused(spec, hist, chunk, first)
                want = channelize_requantize_plain(spec, hist, chunk, first, c0, rows)
                buf = torch.zeros((rows, f + 106496 + 64), dtype=torch.uint16, device=dev)
                got = channelize_requantize_fused(spec, hist, chunk, first,
                                                  out=buf[:, 106496 : 106496 + f],
                                                  channel_start=c0, channel_count=rows)
                torch.cuda.synchronize()
                differ, err = u16_diff(got, want)
                max_err = max(max_err, err)
                check(differ == 0 and torch.equal(got.view(torch.int16),
                                                  full[c0 : c0 + rows].view(torch.int16))
                      and not bool(buf[:, :106496].view(torch.int16).any())
                      and not bool(buf[:, 106496 + f :].view(torch.int16).any()),
                      f"k2 block N={n} [{c0}, {c0 + rows}) F={f} first={first}: {differ} samples "
                      "differ from the plain block, or from the full launch's rows, or it "
                      "overruns")
            del full, want, buf, got, chunk
        emit("k2_parity", n=n, block=[c0, rows], p=p, frames=[8 * 1024 * 1024, 3 * 8192 + 640 + 37],
             histories=["head", "carried"], exact=True, equal_to_full_rows=True)

    # Full width, as the wideband path runs it: N = 12, one super-step's
    # frames, written into the columns of a staged batch behind the halo.
    n, w = WIDE_CHANNELS, 8 * 1024 * 1024
    spec = ChannelizerSpec(n_channels=n)
    p = spec.history_frames
    rng = np.random.default_rng(7)
    chunk = random_u16(rng, n * w, dev)
    hist = random_u16(rng, n * p, dev)
    wide_spec = make_frontend_spec(build_decoder_config([new_parser(x, 72) for x in ALL]), 1024)
    assert wide_spec.window == w
    hs = wide_spec.halo_staged
    staged = torch.zeros((n, staged_geometry(wide_spec).staged_samples),
                         dtype=torch.uint16, device=dev)
    out = staged[:, hs : hs + w]
    channelize_requantize_fused(spec, hist, chunk, False, out=out)
    want = channelize_requantize_plain(spec, hist, chunk, False)
    torch.cuda.synchronize()
    differ, err = u16_diff(out, want)
    max_err = max(max_err, err)
    check(differ == 0, f"k2 full width: {differ} samples differ (max {err} LSB)")
    check(not bool(staged[:, :hs].view(torch.int16).any())
          and not bool(staged[:, hs + w :].view(torch.int16).any()),
          "k2 full width: written outside its columns of the staged batch")
    # The runtime tap loop at the same shape: byte-equal, and its time beside
    # that of the compiled-in taps, which it would replace.
    def runtime_taps():
        channelizer_fused._launch(spec, hist, chunk, False, out, fixed_taps=False)

    out.zero_()
    runtime_taps()
    torch.cuda.synchronize()
    differ, err = u16_diff(out, want)
    max_err = max(max_err, err)
    check(differ == 0, f"k2 full width, runtime tap loop: {differ} samples differ (max {err} LSB)")
    del want
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = event_ms(lambda: channelize_requantize_fused(spec, hist, chunk, False, out=out), flush=flush)
    k_ms = kernel_ms(lambda: channelize_requantize_fused(spec, hist, chunk, False, out=out),
                     "channelize_kernel", flush=flush)
    k_ms_runtime = kernel_ms(runtime_taps, "channelize_kernel", flush=flush)
    plain_ms = event_ms(lambda: channelize_requantize_plain(spec, hist, chunk, False), flush=flush)
    rate = card_rate(FP32_INSTR_PER_CLOCK_PER_SM)
    # The wideband mesh's channel blocks at the same shape, by events.
    blocks = []
    for _, c0, rows in K2_BLOCKS:
        rows_out = staged[c0 : c0 + rows, hs : hs + w]
        block_ms = event_ms(lambda: channelize_requantize_fused(
            spec, hist, chunk, False, out=rows_out, channel_start=c0, channel_count=rows),
            flush=flush)
        bw = channelizer_work(spec, w, rate, c0, rows)
        blocks.append({"block": [c0, rows], "ms": block_ms, "bound_ms": bw["bound_ms"],
                       "bound_by": bw["bound_by"], "f32_instr": bw["f32_instr"],
                       "roofline_share_events": bw["bound_ms"] / block_ms})
    del flush, staged
    work = channelizer_work(spec, w, rate)
    emit("k2_time", card=card, n=n, frames=w, ms=ms, kernel_ms=k_ms,
         kernel_ms_runtime_taps=k_ms_runtime, plain_ms=plain_ms,
         **work, f32_instr_per_s=rate, roofline_share=work["bound_ms"] / k_ms,
         roofline_share_events=work["bound_ms"] / ms,
         roofline_share_reference_order=work["bound_ms_reference_order"] / k_ms,
         blocks=blocks, max_abs_err=max_err, ptxas=ptxas_by_entry("channelizer"))
    return {"ms": ms, "kernel_ms": k_ms, "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"], "max_abs_err": max_err}


def render_wideband_sliced(total: int, channel_bursts, n: int, chip_length: int,
                           amplitude: float, noise: float, seed: int) -> np.ndarray:
    """``synth.render_wideband``'s signal (each burst's chip envelope on a
    carrier at its channel's centre, complex Gaussian noise, u8 at DC 127.5)
    rendered in slices on a few threads and kept only as u8 bytes, so a
    full-width capture needs neither a complex128 array nor minutes of one
    core. The noise of each slice comes from its own seeded generator."""
    total_wide = total * n
    rng = np.random.default_rng(seed)
    spans = []
    for channel, burst in channel_bursts:
        chips = np.asarray(burst.chips, np.float64)
        start = burst.offset * n
        end = min(start + chips.size * chip_length * n, total_wide)
        spans.append((start, end, channel, chips, rng.uniform(0, 2 * np.pi)))
    out = np.empty(2 * total_wide, np.uint8)
    step = 1 << 22

    def render(k: int) -> None:
        lo, hi = k * step, min((k + 1) * step, total_wide)
        g = np.random.default_rng([seed, k])
        re = g.standard_normal(hi - lo, dtype=np.float32) * np.float32(noise) + np.float32(127.5)
        im = g.standard_normal(hi - lo, dtype=np.float32) * np.float32(noise) + np.float32(127.5)
        for start, end, channel, chips, phase in spans:
            a, b = max(start, lo), min(end, hi)
            if a >= b:
                continue
            t = np.arange(a, b)
            env = amplitude * chips[(t - start) // (chip_length * n)]
            ang = 2 * np.pi * channel * t / n + phase
            re[a - lo : b - lo] += (env * np.cos(ang)).astype(np.float32)
            im[a - lo : b - lo] += (env * np.sin(ang)).astype(np.float32)
        out[2 * lo : 2 * hi : 2] = np.clip(np.rint(re), 0, 255)
        out[2 * lo + 1 : 2 * hi : 2] = np.clip(np.rint(im), 0, 255)

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(render, range(-(-total_wide // step))))
    return out


def build_wideband_capture(cfg, n: int, total: int):
    """bench_wideband.py's capture recipe: SCM, IDM and R900 bursts in turn
    every PacketLength + 5 blocks, round-robin over the channels, amplitude
    90, noise 2, seed 7. Returns the u8 wideband IQ and the planted set of
    (channel, message type, meter id)."""
    gap = cfg.packet_length + 5 * cfg.block_size
    bursts, planted = [], set()
    offset, i = cfg.block_size, 0
    while offset + cfg.packet_length < total - cfg.packet_length:
        c = i % n
        if i % 3 == 0:
            bits = synth.make_scm_bits(meter_id=1_000_000 + i, consumption=i)
            bursts.append((c, synth.bits_to_burst(bits, offset)))
            planted.add((c, "SCM", 1_000_000 + i))
        elif i % 3 == 1:
            bursts.append((c, synth.bits_to_burst(synth.make_idm_bits(serial=2_000_000 + i), offset)))
            planted.add((c, "IDM", 2_000_000 + i))
        else:
            digits = synth.make_r900_symbols(meter_id=3_000_000 + i)
            bursts.append((c, synth.r900_burst(digits, offset)))
            planted.add((c, "R900", 3_000_000 + i))
        offset += gap
        i += 1
    wb = render_wideband_sliced(total, bursts, n, cfg.chip_length,
                                amplitude=90.0, noise=2.0, seed=7)
    return wb, planted


def phase_wideband(card: str, window_blocks: int = 1024):
    n = WIDE_CHANNELS

    def fresh():
        return WidebandDecoder([new_parser(x, 72) for x in ALL], n_channels=n,
                               window_blocks=window_blocks, max_hits=256)

    dec = fresh()
    w = dec.spec.window
    t0 = time.perf_counter()
    wb, planted = build_wideband_capture(dec.cfg, n, 2 * w + w // 4)
    render_s = time.perf_counter() - t0
    chunk = max(n * dec.cfg.block_size2, 1 << 18)  # the CLI's chunk size

    def feed_all(d, data):
        msgs = []
        for pos in range(0, data.size, chunk):
            msgs.extend(d.feed(data[pos : pos + chunk]))
        msgs.extend(d.flush())
        return msgs

    feed_all(fresh(), wb[: dec.window_bytes])  # warm-up: allocator, pinned pools
    torch.cuda.synchronize()

    # Where the host time of a super-step goes. The timed calls nest:
    # _process_chunk > {_wideband_step > decode_windows_scan, enqueue_fetch,
    # _complete > {fetch, each channel's complete > _parse_window}}; flush's
    # drain calls _complete outside _process_chunk.
    clock = HostClock()
    for name in ("_process_chunk", "_complete", "drain"):
        clock.wrap(dec, name)
    for name in ("_wideband_step", "decode_windows_scan", "enqueue_fetch", "fetch"):
        clock.wrap(wideband_mod, name)
    for c in dec._chan:
        clock.wrap(c, "complete")
        clock.wrap(c, "_parse_window")
    decode_stencil.launches = 0
    channelize_requantize_fused.launches = 0
    t0 = time.perf_counter()
    try:
        msgs = feed_all(dec, wb)
    finally:
        clock.restore()
    elapsed = time.perf_counter() - t0
    k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
    s = clock.s
    steps = dec._window_index
    snap = dec.metrics_snapshot()
    got = {(c, m.msg_type(), m.meter_id()) for c, _, m in msgs}
    check(got == planted, f"wideband: missing {sorted(planted - got)[:8]}, "
          f"extra {sorted(got - planted)[:8]}")
    check(len(msgs) == len(planted), f"wideband: {len(msgs)} messages for "
          f"{len(planted)} planted packets")
    check(steps >= 3 and k2 == steps, f"wideband: {k2} channelizer launches, {steps} super-steps")
    check(k1 == snap["windows_decoded"] + snap["hit_overflows"] and k1 >= n * steps,
          f"wideband: {k1} stencil launches for {snap['windows_decoded']} windows")
    complete_in_steps = s["_complete"] - s["drain"]
    host_ms = {k: v * 1e3 / steps for k, v in {
        "h2d": (s["_process_chunk"] - s["_wideband_step"] - s["enqueue_fetch"]
                - complete_in_steps),
        "stage_and_enqueue_k2": s["_wideband_step"] - s["decode_windows_scan"],
        "enqueue_window_programs": s["decode_windows_scan"],
        "enqueue_d2h": s["enqueue_fetch"],
        "wait_for_card": s["fetch"],
        "parse": s["_parse_window"],
        "unpack": s["complete"] - s["_parse_window"],
        "ghost_dedup": s["_complete"] - s["fetch"] - s["complete"],
        "feed_other": elapsed - s["_process_chunk"] - s["drain"],
    }.items()}

    # Device time of one super-step on a planted chunk (not the first).
    dev = dec.device
    wbytes = dec.window_bytes
    u16 = torch.from_numpy(wb[wbytes : 2 * wbytes].view(np.uint16)).to(dev)
    hist = torch.from_numpy(wb[wbytes - 2 * n * 8 : wbytes].view(np.uint16)).to(dev)
    tail = torch.zeros((n, dec.spec.halo_staged), dtype=torch.uint16, device=dev)

    def step():
        return wideband_mod._wideband_step(dec.chspec, dec.spec, hist, u16, tail, False)

    step_ms = event_ms(step, reps=3, warm=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        step()
    enqueue_ms = (time.perf_counter() - t) / 3 * 1e3
    torch.cuda.synchronize()
    kernels, busy_ms, top = profile_window(step)
    samples = wb.size // 2
    emit("wideband", card=card, channels=n, window_blocks=window_blocks,
         super_steps=steps, windows_decoded=snap["windows_decoded"],
         messages=len(msgs), planted=len(planted), launches_k1=k1, launches_k2=k2,
         wideband_samples=samples, seconds=elapsed,
         wideband_samples_per_s=samples / elapsed, render_seconds=render_s,
         hit_overflows=snap["hit_overflows"], host_ms_per_super_step=host_ms,
         super_step_ms=step_ms, super_step_host_enqueue_ms=enqueue_ms,
         super_step_kernels=kernels, super_step_kernel_ms=busy_ms,
         super_step_top_kernels=top)
    return k1, k2, (wb, planted, msgs)


def oracle_segment(task):
    """(block, str(message)) of the port's NumPy oracle,
    ``ReferenceDecoder(arithmetic="int")``, over blocks [lo, hi) of a capture.
    ``seg`` holds the capture from ``warm`` blocks before ``lo``: the
    oracle's state (its signal, bit and R900 buffers, BufferLength samples
    each, and the previous block's digests) is then that of a run from the
    stream head, so the segments together give the one sequential run."""
    seg, lo, warm, names, chip_length = task
    dec = ReferenceDecoder([new_parser(n, chip_length) for n in names], arithmetic="int")
    return [(lo - warm + b, str(m)) for b, m in dec.decode_capture(seg) if b >= warm]


def start_oracle(pool, iq: np.ndarray, names, chip_length: int, parts: int):
    """Futures of :func:`oracle_segment` over ``parts`` block ranges of
    ``iq``, on the worker processes of ``pool``."""
    cfg = build_decoder_config([new_parser(n, chip_length) for n in names])
    bs2, n_blocks = cfg.block_size2, iq.size // cfg.block_size2
    warm = -(-cfg.buffer_length // cfg.block_size) + 2
    bounds = np.linspace(0, n_blocks, parts + 1).astype(int)
    futures = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        w = min(warm, int(lo))
        futures.append(pool.submit(oracle_segment, (
            iq[(lo - w) * bs2 : hi * bs2], int(lo), w, tuple(names), chip_length)))
    return futures


class SigintOnRead:
    """Wraps ``read`` of the CLI's file sources (the Python and the native
    transport's): raises SIGINT in the process on the ``n``-th read (which
    still returns its bytes), as a user's Ctrl-C during a decode; checks
    that the CLI took SIGINT over (only a flag, read between feeds) before
    it does."""

    CLASSES = (capture_mod.FileSource, native.NativeFileSource)

    def __init__(self, n: int):
        self.n, self.calls = n, 0
        self.origs = [cls.__dict__["read"] for cls in self.CLASSES]

    def __enter__(self):
        wrapper = self

        def wrap(orig):
            def read(source, n_bytes):
                wrapper.calls += 1
                if wrapper.calls == wrapper.n:
                    check(signal.getsignal(signal.SIGINT) is not signal.default_int_handler,
                          "resume cli: -checkpoint did not take SIGINT over")
                    signal.raise_signal(signal.SIGINT)
                return orig(source, n_bytes)
            return read

        for cls, orig in zip(self.CLASSES, self.origs):
            cls.read = wrap(orig)
        return self

    def __exit__(self, *exc):
        for cls, orig in zip(self.CLASSES, self.origs):
            cls.read = orig


def run_cli(argv, device=None):
    """The in-process CLI (``device`` as ``main`` takes it): (exit code,
    JSON records without their Time, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv, device=device)
    recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    for r in recs:
        r.pop("Time")
    return rc, recs, err.getvalue()


def cli_resume(label: str, path: str, argv, interrupt_read: int, device=None) -> dict:
    """-checkpoint through the CLI on the capture at ``path``: a straight
    run (which must leave no checkpoint), a run interrupted by SIGINT during
    read ``interrupt_read``, then the resumed run; the two runs' records
    must equal the straight run's, which the result holds as ``records``."""
    ck = path + ".ck"
    argv = argv + ["-format=json", f"-fromfile={path}", f"-checkpoint={ck}"]
    rc, want, _ = run_cli(argv, device)
    check(rc == 0 and want, f"resume cli {label}: straight run rc {rc}, {len(want)} messages")
    check(not os.path.exists(ck + ".meta.json"), f"resume cli {label}: a run to EOF saved")
    with SigintOnRead(interrupt_read) as sig:
        rc, head, err = run_cli(argv, device)
    check(rc == 0 and "interrupted" in err and sig.calls == interrupt_read,
          f"resume cli {label}: interrupted run rc {rc}, {sig.calls} reads: {err[-300:]}")
    saved = re.search(r"checkpoint saved at byte (\d+)", err)
    check(saved is not None, f"resume cli {label}: no checkpoint saved")
    rc, tail, err = run_cli(argv, device)
    skip = re.search(r"resumed from checkpoint at byte (\d+) \(read past in ([\d.]+) ms\)", err)
    check(rc == 0 and skip is not None and skip.group(1) == saved.group(1),
          f"resume cli {label}: resumed run rc {rc}: {err[-300:]}")
    check(head + tail == want, f"resume cli {label}: {len(head)} + {len(tail)} records, "
          f"straight {len(want)}, or they differ")
    check(not os.path.exists(ck + ".meta.json"), f"resume cli {label}: checkpoint left at EOF")
    return {"messages": len(want), "before_interrupt": len(head),
            "boundary": int(saved.group(1)), "skip_read_ms": float(skip.group(2)),
            "records": want}


def phase_resume(card: str, iq: np.ndarray, nb_msgs, wide) -> tuple:
    """Checkpoint and resume on the card at full width: the narrowband
    throughput capture cut at byte 0, inside window 2 and inside the
    flush's partial window, the 12-channel capture cut inside its second
    super-step, each saved, loaded into a fresh decoder, restored and run
    to the end; then the CLI's -checkpoint, narrowband and 12-channel, with
    SIGINT during a read. Every stream equals its straight run."""
    wb, wb_planted, wb_msgs = wide

    def nb_fresh():
        return WindowDecoder([new_parser(n, 72) for n in ALL], window_blocks=1024, max_hits=256)

    def wb_fresh():
        return WidebandDecoder([new_parser(x, 72) for x in ALL], n_channels=WIDE_CHANNELS,
                               window_blocks=1024, max_hits=256)

    def feed_all(dec, data, flush):
        chunk = 1 << 18  # the CLI's read at these widths
        out = []
        for pos in range(0, data.size, chunk):
            out.extend(dec.feed(data[pos : pos + chunk]))
        out.extend(dec.flush() if flush else dec.drain())
        return out

    def as_rows(msgs):
        return [(*t[:-1], str(t[-1])) for t in msgs]

    t_phase = time.perf_counter()
    decode_stencil.launches = 0
    channelize_requantize_fused.launches = 0
    save_ms, load_restore_ms, cuts = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        nb_bytes = nb_fresh().window_bytes
        wide_bytes = wb_fresh().window_bytes
        plan = [
            ("byte0", nb_fresh, iq, 0, nb_msgs),
            ("inside_window2", nb_fresh, iq, 2 * nb_bytes + nb_bytes // 3 + 1, nb_msgs),
            ("inside_final_partial", nb_fresh, iq,
             4 * nb_bytes + (iq.size - 4 * nb_bytes) // 2 + 1, nb_msgs),
            ("wideband_step2", wb_fresh, wb, wide_bytes + wide_bytes // 3 + 1, wb_msgs),
        ]
        for label, fresh, data, cut, straight in plan:
            a = fresh()
            got = as_rows(feed_all(a, data[:cut], flush=False))
            boundary = cut - a.discard_pending()
            path = os.path.join(tmp, label)
            t0 = time.perf_counter()
            capture_checkpoint(a, boundary).save(path)
            save_ms[label] = (time.perf_counter() - t0) * 1e3
            del a
            b = fresh()
            t0 = time.perf_counter()
            restore_checkpoint(b, load_checkpoint(path))
            torch.cuda.synchronize()
            load_restore_ms[label] = (time.perf_counter() - t0) * 1e3
            k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
            got += as_rows(feed_all(b, data[boundary:], flush=True))
            want = as_rows(straight)
            check(got == want, f"resume {label}: {len(got)} messages, straight {len(want)}, "
                  "or they differ")
            check(decode_stencil.launches > k1, f"resume {label}: K1 not launched after restore")
            if fresh is wb_fresh:
                check(channelize_requantize_fused.launches > k2,
                      f"resume {label}: K2 not launched after restore")
                found = {(c, m.msg_type(), m.meter_id()) for c, _, m in straight}
                check(found == wb_planted, f"resume {label}: planted packets missing")
            cuts[label] = {"cut": cut, "boundary": boundary, "messages": len(got)}
        nb_path = os.path.join(tmp, "narrowband.bin")
        iq.tofile(nb_path)
        wb_path = os.path.join(tmp, "wideband.bin")
        wb[: wide_bytes + wide_bytes // 2].tofile(wb_path)  # 1.5 super-steps
        chunk = 1 << 18
        cli = {
            "channels_1": cli_resume(
                "channels=1", nb_path, ["-msgtype=all", "-symbollength=72", "-windowblocks=1024"],
                (2 * nb_bytes + nb_bytes // 2) // chunk),
            "channels_12": cli_resume(
                "channels=12", wb_path, ["-msgtype=all", "-symbollength=72", "-windowblocks=1024",
                                         f"-channels={WIDE_CHANNELS}"],
                (wide_bytes + wide_bytes // 4) // chunk),
        }
    k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
    check(k1 > 0 and k2 > 0, f"resume: launches k1 {k1}, k2 {k2}")
    emit("resume", card=card, cuts=cuts, save_ms=save_ms, load_restore_ms=load_restore_ms,
         cli={k: {x: y for x, y in v.items() if x != "records"} for k, v in cli.items()},
         cli_skip_read_ms={k: v["skip_read_ms"] for k, v in cli.items()},
         launches_k1=k1, launches_k2=k2, seconds=time.perf_counter() - t_phase)
    return k1, k2


class RtlTcpServer(threading.Thread):
    """An in-process rtl_tcp server on localhost: the 12-byte greeting, then
    ``payload`` in 1 MiB sends, reading (and counting) the client's 5-byte
    commands between them; then it half-closes, so the client reads to EOF,
    and waits up to 60 s for the client to close."""

    def __init__(self, payload: bytes):
        super().__init__(daemon=True)
        self.payload = payload
        self.commands = 0
        self.error = None
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.sock.settimeout(60)
        self.port = self.sock.getsockname()[1]

    def _count(self, data: bytes) -> bool:
        self.commands += len(data) // 5
        return bool(data)

    def run(self):
        try:
            conn, _ = self.sock.accept()
            with conn:
                conn.settimeout(60)
                conn.sendall(b"RTL0" + struct.pack(">II", 5, 29))
                view = memoryview(self.payload)
                for pos in range(0, len(view), 1 << 20):
                    conn.sendall(view[pos : pos + (1 << 20)])
                    conn.setblocking(False)
                    try:
                        self._count(conn.recv(1 << 16))
                    except BlockingIOError:
                        pass
                    conn.settimeout(60)
                conn.shutdown(socket.SHUT_WR)
                while self._count(conn.recv(1 << 16)):
                    pass
        except OSError as e:  # socket.timeout included
            self.error = e
        finally:
            self.sock.close()


def phase_native(card: str, iq: np.ndarray, planted: set, feed_msgs, feed_host_ms) -> int:
    """The C++ transport: the reader loop (read_staged into pinned ring
    buffers, process_host_staged) against the feed path; the CLI's
    -ingest=native against -ingest=python; a live run through an rtl_tcp
    server on localhost against the file run. Returns K1's launches in the
    native transport's runs (the -ingest=python runs come before the count
    is set to 0)."""
    check(native.available(), f"native: the library did not build: {native.load_error()}")
    t_phase = time.perf_counter()
    want = [(b, str(m)) for b, m in feed_msgs]
    dec = WindowDecoder([new_parser(n, 72) for n in ALL], window_blocks=1024, max_hits=256)
    w = dec.spec.window
    ring = StagingRing(dec)
    check(all(b.is_pinned() for b in ring.buffers), "native: the ring's buffers are not pinned")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "throughput.bin")
        iq.tofile(path)
        cli_cases = (
            ("golden", ["-msgtype=scm", "-symbollength=78", "-windowblocks=16",
                        f"-fromfile={SAMPLE_BIN}"], len(SAMPLE_BIN_GOLDEN)),
            ("throughput", ["-msgtype=all", "-symbollength=72", "-windowblocks=1024",
                            f"-fromfile={path}"], len(planted)),
        )

        def cli_run(label, argv, mode):
            rc, recs, err = run_cli(argv + ["-format=json", f"-ingest={mode}"])
            check(rc == 0 and f"ingest: {mode}" in err,
                  f"native cli {label} -ingest={mode}: rc {rc}: {err[-300:]}")
            return recs

        # The Python transport's runs, which the native ones must equal, come
        # before the count is set to 0: it counts the native transport's runs.
        python_recs = {label: cli_run(label, argv, "python") for label, argv, _ in cli_cases}
        decode_stencil.launches = 0

        def reader_loop():
            dec.reset()
            carry = np.zeros(dec.spec.halo_staged, np.uint16)
            src = native.NativeFileSource(path)
            msgs = []
            try:
                while True:
                    buf = ring.acquire()
                    got = src.read_staged(buf, carry, w)
                    msgs += ring.submit(got)
                    if got < w:
                        break
            finally:
                src.close()
            return msgs + dec.drain()

        reader_loop()  # warm-up: allocator, page cache
        torch.cuda.synchronize()
        # The timed calls nest as in phase decode: process_host_staged >
        # {h2d, the window program's enqueue, _dispatch > _complete_inflight >
        # {fetch, _parse_window}, enqueue_fetch}; the last drain calls
        # _complete_inflight outside _dispatch.
        clock = HostClock()
        clock.wrap(native.NativeFileSource, "read_staged")
        clock.wrap(ring, "acquire")
        for name in ("process_host_staged", "_dispatch", "_complete_inflight", "_parse_window"):
            clock.wrap(dec, name)
        for name in ("decode_window_staged_packed", "fetch", "enqueue_fetch"):
            clock.wrap(pipeline_mod, name)
        k0, w0 = decode_stencil.launches, dec.metrics.windows_decoded
        t0 = time.perf_counter()
        try:
            msgs = reader_loop()
        finally:
            clock.restore()
        elapsed = time.perf_counter() - t0
        loop_launches = decode_stencil.launches - k0
        s = clock.s
        n_win = dec.metrics.windows_decoded - w0
        host_ms = {k: v * 1e3 / n_win for k, v in {
            "read_staged": s["read_staged"],
            "wait_for_buffer": s["acquire"],
            "h2d": (s["process_host_staged"] - s["decode_window_staged_packed"]
                    - s["_dispatch"] - s["enqueue_fetch"]),
            "enqueue_window_program": s["decode_window_staged_packed"],
            "enqueue_d2h": s["enqueue_fetch"],
            "wait_for_card": s["fetch"],
            "parse": s["_parse_window"],
            "unpack": s["_complete_inflight"] - s["fetch"] - s["_parse_window"],
            "other": elapsed - s["read_staged"] - s["acquire"] - s["process_host_staged"]
            - (s["_complete_inflight"] - s["_dispatch"]),
        }.items()}
        got = [(b, str(m)) for b, m in msgs]
        check(got == want, f"native: the reader loop gives {len(got)} messages, the feed "
              f"path {len(want)}, or they differ")
        check({(m.msg_type(), m.meter_id()) for _, m in msgs} == planted,
              "native: the reader loop's messages are not the planted set")
        check(loop_launches == n_win, f"native: {loop_launches} K1 launches for {n_win} windows")

        # The CLI: -ingest=native equals -ingest=python.
        cli_runs = {}
        for label, argv, n_want in cli_cases:
            recs = cli_run(label, argv, "native")
            check(len(recs) == n_want and recs == python_recs[label],
                  f"native cli {label}: {len(recs)} native records, "
                  f"{len(python_recs[label])} python, {n_want} expected, or they differ")
            cli_runs[label] = len(recs)

        # Live: the capture, zero-padded to whole CLI reads (a short last
        # read is dropped at EOF, as the reference drops its partial block),
        # streamed by a server on localhost into a NativeRtlTcpClient run.
        chunk = 1 << 18  # the CLI's read at this configuration
        padded = np.zeros(-(-iq.size // chunk) * chunk, np.uint8)
        padded[: iq.size] = iq
        padded_path = os.path.join(tmp, "padded.bin")
        padded.tofile(padded_path)
        argv = ["-msgtype=all", "-symbollength=72", "-windowblocks=1024", "-format=json",
                "-ingest=native"]
        rc, file_recs, _ = run_cli(argv + [f"-fromfile={padded_path}"])
        check(rc == 0 and len(file_recs) == len(planted),
              f"native live: the file run gave rc {rc}, {len(file_recs)} records")
        server = RtlTcpServer(padded.tobytes())
        server.start()
        t_live = time.perf_counter()
        try:
            rc, live_recs, err = run_cli(argv + [f"-server=127.0.0.1:{server.port}", "-metrics"])
        finally:
            server.join(timeout=120)
        live_s = time.perf_counter() - t_live
        check(not server.is_alive() and server.error is None,
              f"native live: the server did not end cleanly: {server.error}")
        dropped = re.search(r"'bytes_dropped': (\d+)", err)
        check(rc == 0 and live_recs == file_recs,
              f"native live: rc {rc}, {len(live_recs)} records, the file run "
              f"{len(file_recs)}, or they differ: {err[-300:]}")
        check(dropped is not None and int(dropped.group(1)) == 0
              and "ingest ring overflow" not in err,
              f"native live: bytes were dropped: {err[-300:]}")
    launches = decode_stencil.launches
    check(launches > 0, "native: the decode stencil kernel was not launched")
    copies = host_ms["read_staged"] + host_ms["wait_for_buffer"] + host_ms["h2d"]
    feed_copies = feed_host_ms["feed_other"] + feed_host_ms["stage"] + feed_host_ms["h2d"]
    emit("native", card=card, windows=n_win, messages=len(msgs), equal_to_feed=True,
         samples_per_s=(iq.size // 2) / elapsed, seconds=elapsed,
         host_ms_per_window=host_ms, feed_host_ms_per_window=feed_host_ms,
         host_copy_ms_per_window=copies, feed_host_copy_ms_per_window=feed_copies,
         cli_native_equals_python=cli_runs, live_records=len(live_recs),
         live_bytes=padded.size, live_seconds=live_s, live_dropped=0,
         live_commands=server.commands, launches=launches,
         launches_reader_loop=loop_launches, phase_seconds=time.perf_counter() - t_phase)
    return launches


def phase_mesh(card: str, iq: np.ndarray, feed_msgs) -> tuple:
    """The time-sharded MeshDecoder: 1, 2 and 4 shards on one card, and a
    shard a card when there are several, equal the WindowDecoder's stream;
    dryrun at 2 and 4 shards; the CLI's -mesh (every card, and two shards
    on one) and -mesh -checkpoint (one shard). Returns K1's launches in the
    mesh's runs (the plain CLI run comes before the count is set to 0) and
    each shard count's stream."""
    t_phase = time.perf_counter()
    want = [(b, str(m)) for b, m in feed_msgs]
    dev = torch.device("cuda", torch.cuda.current_device())
    cards = torch.cuda.device_count()
    layouts = {str(n): [dev] * n for n in (1, 2, 4)}
    if cards > 1:
        layouts["every_card"] = [torch.device("cuda", i) for i in range(cards)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "throughput.bin")
        iq.tofile(path)
        args = ["-msgtype=all", "-symbollength=72", "-windowblocks=1024"]
        argv = args + ["-format=json", f"-fromfile={path}"]
        # The plain CLI run, which the -mesh runs must equal, comes before
        # the count is set to 0: it counts the mesh's runs.
        rc, plain, _ = run_cli(argv)
        check(rc == 0 and len(plain) == len(want), f"mesh cli: plain run rc {rc}, {len(plain)}")
        decode_stencil.launches = 0
        shards, streams, window = {}, {}, None
        for n, devices in layouts.items():
            dec = MeshDecoder([new_parser(x, 72) for x in ALL], devices=devices,
                              window_blocks=1024, max_hits=256)
            k0 = decode_stencil.launches
            t0 = time.perf_counter()
            got = [(b, str(m)) for b, m in dec.decode_capture(iq)]
            secs = time.perf_counter() - t0
            check(got == want, f"mesh n={n}: {len(got)} messages, the WindowDecoder "
                  f"{len(want)}, or they differ")
            streams[n] = got
            shards[n] = {"messages": len(got), "windows": dec.metrics.windows_decoded,
                         "launches": decode_stencil.launches - k0, "seconds": secs}
            # K1 runs on every window of a super-batch, valid or not.
            dispatched = dec.export_state()["window_index"]
            check(shards[n]["launches"] == dispatched,
                  f"mesh n={n}: {shards[n]['launches']} launches for {dispatched} windows")
            window = dec.spec.window
            del dec
        dry = {n: dryrun(n, device=dev) for n in (2, 4)}
        check(dry == {2: 5, 4: 5}, f"mesh dryrun: {dry}")
        cli_runs = {}
        for label, device, n in (("every_card", None, cards), ("two_shards", [dev] * 2, 2)):
            rc, recs, err = run_cli(argv + ["-mesh"], device=device)
            check(rc == 0 and f"mesh: {n} devices" in err and recs == plain,
                  f"mesh cli {label}: rc {rc}, {len(recs)} records, plain {len(plain)}: "
                  f"{err[-300:]}")
            cli_runs[label] = len(recs)
        # One shard: SIGINT during the read that takes the stream half a
        # window past the first super-batch (2 windows), so a checkpoint is
        # saved at its end.
        ckpt = cli_resume("mesh", path, args + ["-mesh"], (2 * 2 * window + window) // (1 << 18),
                          device=[dev])
        check(ckpt.pop("records") == plain, "mesh cli: the -checkpoint straight run differs")
    launches = decode_stencil.launches
    check(launches > 0, "mesh: the decode stencil kernel was not launched")
    emit("mesh", card=card, shards=shards, dryrun=dry, cli=cli_runs, cli_checkpoint=ckpt,
         launches=launches, seconds=time.perf_counter() - t_phase)
    return launches, streams


def phase_mesh_staged(card: str, iq: np.ndarray, planted: set, streaming: dict) -> int:
    """The device-resident mesh super-batch at full width: the throughput
    capture staged with stage_superbatch, resident on the card, decoded by
    MeshDecoder.decode_superbatch_staged with 2 and 4 shards on the card, K
    = 2 (the halo ring's copies stay on the card). Its stream equals the
    streaming mesh's at the same shard count (``streaming``, from phase
    mesh) and holds the planted set; K1 runs once a window of every
    super-batch plus once an escalation, exactly; a second decode of the
    same batch gives the same stream. Prints the device-resident rate by
    CUDA events (no claim). Returns K1's launches in the staged runs."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    shards, total_launches = {}, 0
    for n in (2, 4):
        dec = MeshDecoder([new_parser(x, 72) for x in ALL], devices=[dev] * n,
                          window_blocks=1024, max_hits=256)
        k, size = dec.scan_windows, dec.window_bytes
        batches = []
        for pos in range(0, iq.size, size):
            chunk = np.zeros(size, np.uint8)
            chunk[: iq[pos : pos + size].size] = iq[pos : pos + size]
            valid = None if pos + size <= iq.size else (iq.size - pos) // dec.cfg.block_size2
            sb = stage_superbatch(dec.spec, chunk, n, k)
            batches.append(([torch.from_numpy(sb[s]).to(dev) for s in range(n)], valid))
        torch.cuda.synchronize()
        runs = []
        for _ in range(2):
            dec.reset()
            overflows = dec.metrics.hit_overflows
            decode_stencil.launches = 0
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            msgs = []
            for batch, valid in batches:
                msgs += dec.decode_superbatch_staged(batch, valid, drain=False)
            msgs += dec.drain()
            end.record()
            torch.cuda.synchronize()
            launches = decode_stencil.launches
            escalations = dec.metrics.hit_overflows - overflows
            check(launches == len(batches) * n * k + escalations,
                  f"mesh_staged n={n}: {launches} K1 launches for {len(batches)} super-batches "
                  f"of {n * k} windows and {escalations} escalations")
            runs.append(([(b, str(m)) for b, m in msgs], start.elapsed_time(end), launches,
                         {(m.msg_type(), m.meter_id()) for _, m in msgs}))
        (first, ms, launches, ids), (again, ms2, _, _) = runs
        check(first == streaming[str(n)], f"mesh_staged n={n}: {len(first)} messages, the "
              f"streaming mesh {len(streaming[str(n)])}, or they differ")
        check(ids == planted, f"mesh_staged n={n}: missing {sorted(planted - ids)[:8]}, "
              f"extra {sorted(ids - planted)[:8]}")
        check(again == first, f"mesh_staged n={n}: the second decode of the batch differs")
        samples = iq.size // 2
        shards[str(n)] = {"super_batches": len(batches), "messages": len(first),
                          "launches": launches, "ms": [ms, ms2],
                          "samples_per_s": [samples / (t / 1e3) for t in (ms, ms2)]}
        total_launches += 2 * launches
        del dec, batches
    check(total_launches > 0, "mesh_staged: the decode stencil kernel was not launched")
    emit("mesh_staged", card=card, scan_windows=2, samples=iq.size // 2, shards=shards,
         launches=total_launches, seconds=time.perf_counter() - t_phase)
    return total_launches


def phase_wide_mesh(card: str, wide, window_blocks: int = 1024) -> tuple:
    """The channel x time WidebandMeshDecoder at full width: the wideband
    phase's capture through mesh (2, 2), one window a time shard, its four
    shards on the one card (so a super-batch is 2 windows of every channel:
    one full super-batch and a flushed partial one of 256 blocks; the
    filter history and the decode halo cross a time-shard seam and a
    super-batch seam), equal to the WidebandDecoder's stream; then the CLI's
    -channels=12 -mesh on every local card and, with -checkpoint, on two
    devices of the card ((2, 1): SIGINT during a read, then the resumed
    run), each equal to the plain -channels=12 run. Returns K1's and K2's
    launches in the mesh's runs (the plain CLI run comes first)."""
    wb, planted, wb_msgs = wide
    t_phase = time.perf_counter()
    n = WIDE_CHANNELS
    dev = torch.device("cuda", torch.cuda.current_device())

    def fresh():
        return WidebandMeshDecoder([new_parser(x, 72) for x in ALL], n_channels=n,
                                   mesh_shape=WIDE_MESH, devices=[dev] * 4,
                                   window_blocks=window_blocks, max_hits=256,
                                   scan_windows=WIDE_MESH_SCAN)

    dec = fresh()
    w = dec.spec.window
    chunk = max(n * dec.cfg.block_size2, 1 << 18)  # the CLI's chunk size

    def feed_all(d, data):
        msgs = []
        for pos in range(0, data.size, chunk):
            msgs.extend(d.feed(data[pos : pos + chunk]))
        msgs.extend(d.flush())
        return msgs

    feed_all(fresh(), wb[: dec.window_bytes])  # warm-up: allocator, pinned pools
    torch.cuda.synchronize()
    # Where the host time of a super-batch goes. The timed calls nest:
    # _process_chunk > {K2's enqueue, the window programs' enqueue, _complete >
    # {fetch, each channel's complete > _parse_window}}; flush's drain calls
    # _complete outside _process_chunk.
    clock = HostClock()
    for name in ("_process_chunk", "_complete", "drain"):
        clock.wrap(dec, name)
    for name in ("channelize_requantize_fused", "decode_windows_scan", "fetch"):
        clock.wrap(wideband_mesh_mod, name)
    for c in dec._chan:
        clock.wrap(c, "complete")
        clock.wrap(c, "_parse_window")
    decode_stencil.launches = 0
    channelize_requantize_fused.launches = 0
    t0 = time.perf_counter()
    try:
        msgs = feed_all(dec, wb)
    finally:
        clock.restore()
    elapsed = time.perf_counter() - t0
    k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
    s = clock.s
    batches = dec._window_index // (dec.tdev * dec.scan_windows)
    snap = dec.metrics_snapshot()
    got = [(c, b, str(m)) for c, b, m in msgs]
    check(got == [(c, b, str(m)) for c, b, m in wb_msgs],
          f"wide_mesh: {len(got)} messages, the WidebandDecoder {len(wb_msgs)}, or they differ")
    check({(c, m.msg_type(), m.meter_id()) for c, _, m in msgs} == planted,
          "wide_mesh: the messages are not the planted set")
    check(batches == 2 and k2 == batches * WIDE_MESH[0] * WIDE_MESH[1],
          f"wide_mesh: {k2} K2 launches for {batches} super-batches")
    check(k1 == dec._window_index * n + snap["hit_overflows"],
          f"wide_mesh: {k1} K1 launches for {dec._window_index * n} dispatched windows")
    complete_in_steps = s["_complete"] - s["drain"]
    host_ms = {k: v * 1e3 / batches for k, v in {
        "stage_h2d_and_copies": (s["_process_chunk"] - s["channelize_requantize_fused"]
                                 - s["decode_windows_scan"] - complete_in_steps),
        "enqueue_k2": s["channelize_requantize_fused"],
        "enqueue_window_programs": s["decode_windows_scan"],
        "wait_for_card": s["fetch"],
        "parse": s["_parse_window"],
        "unpack": s["complete"] - s["_parse_window"],
        "order_and_ghost_dedup": s["_complete"] - s["fetch"] - s["complete"],
        "feed_other": elapsed - s["_process_chunk"] - s["drain"],
    }.items()}
    samples = wb.size // 2
    emit("wide_mesh", card=card, mesh=list(WIDE_MESH), scan_windows=WIDE_MESH_SCAN,
         devices=[str(dev)] * 4, super_batches=batches, messages=len(msgs), planted=len(planted),
         equal_to_wideband=True, launches_k1=k1, launches_k2=k2,
         hit_overflows=snap["hit_overflows"], wideband_samples=samples, seconds=elapsed,
         wideband_samples_per_s=samples / elapsed, host_ms_per_super_batch=host_ms,
         note="four shards on one card: the layout's cost on one card, not a multi-card speed")
    del dec

    # The CLI: -channels=12 -mesh on every local card and on two devices.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wideband.bin")
        wb.tofile(path)
        args = ["-msgtype=all", "-symbollength=72", f"-windowblocks={window_blocks}",
                f"-channels={n}"]
        argv = args + ["-format=json", f"-fromfile={path}"]
        # The plain run, which the -mesh runs must equal, is not counted.
        saved_counts = decode_stencil.launches, channelize_requantize_fused.launches
        rc, plain, _ = run_cli(argv)
        decode_stencil.launches, channelize_requantize_fused.launches = saved_counts
        check(rc == 0 and len(plain) == len(planted), f"wide_mesh cli: plain rc {rc}, {len(plain)}")
        cards = torch.cuda.device_count()
        rc, recs, err = run_cli(argv + ["-mesh"])
        check(rc == 0 and recs == plain and f"over {cards} devices" in err,
              f"wide_mesh cli every_card: rc {rc}, {len(recs)} records, plain {len(plain)}: "
              f"{err[-300:]}")
        # SIGINT during the read a super-batch and an eighth in; the stream
        # stops at that feed's end and saves at the super-batch boundary.
        sb_bytes = 2 * n * w * 2  # (2, 1) x 2 windows a time shard
        ckpt = cli_resume("wide_mesh", path, args + ["-mesh"],
                          (sb_bytes + sb_bytes // 8) // (1 << 18),
                          device=[dev] * WIDE_MESH_CLI_DEVICES)
        check(ckpt.pop("records") == plain and ckpt["boundary"] == sb_bytes,
              f"wide_mesh cli: the -checkpoint run differs or saved at {ckpt['boundary']}")
    k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
    emit("wide_mesh_cli", card=card, every_card=len(recs), devices=WIDE_MESH_CLI_DEVICES,
         cli_checkpoint=ckpt, launches_k1=k1, launches_k2=k2,
         seconds=time.perf_counter() - t_phase)
    return k1, k2


#: a process of the multihost phase: the CLI, then K1's launches in it as
#: one JSON line on stderr; with a first argument "--sigint-at=K", process 0
#: raises SIGINT during its K-th super-batch, as a user's Ctrl-C
MULTIHOST_CHILD = """
import json, signal, sys
from rtlamr_tpu_torch.cli.main import main
from rtlamr_tpu_torch.ops.stencil import decode_stencil
from rtlamr_tpu_torch.parallel.distributed import MultiHostDecoder
argv = sys.argv[1:]
if argv[0].startswith("--sigint-at="):
    at = int(argv.pop(0).split("=")[1])
    orig, calls = MultiHostDecoder.decode_superbatch_local, []
    def step(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == at and self.process_id == 0:
            signal.raise_signal(signal.SIGINT)
        return orig(self, *args, **kwargs)
    MultiHostDecoder.decode_superbatch_local = step
decode_stencil.launches = 0
rc = main(argv)
print(json.dumps({"launches_k1": decode_stencil.launches}), file=sys.stderr)
sys.exit(rc)
"""


def multihost_run(argv, n_procs: int = 2, sigint_at: int = 0, timeout: int = 300):
    """``n_procs`` processes of the multi-host CLI on the first visible
    card, joined at a localhost port: each one's (records without Time,
    stderr, K1 launches, -metrics dict). Kills them all on a failure."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0], PYTHONPATH=ROOT)
    head = [sys.executable, "-c", MULTIHOST_CHILD] + ([f"--sigint-at={sigint_at}"]
                                                      if sigint_at else [])
    procs = [subprocess.Popen(head + argv + [f"-coordinator=127.0.0.1:{port}",
                                             f"-numprocs={n_procs}", f"-procid={p}", "-metrics"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p in range(n_procs)]
    out = []
    try:
        for p, proc in enumerate(procs):
            o, e = proc.communicate(timeout=timeout)
            check(proc.returncode == 0, f"multihost: process {p} rc {proc.returncode}: {e[-1500:]}")
            recs = [json.loads(ln) for ln in o.splitlines() if ln.startswith('{"Time"')]
            for r in recs:
                r.pop("Time")
            launches = json.loads(e.strip().splitlines()[-1])["launches_k1"]
            metrics = re.search(r"^metrics: (\{.*\})$", e, re.M)
            check(metrics is not None, f"multihost: process {p} printed no metrics: {e[-500:]}")
            out.append((recs, e, launches, ast.literal_eval(metrics.group(1))))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_multihost(card: str, iq: np.ndarray, feed_msgs, window_blocks: int = 1024) -> list:
    """The multi-host decoder: the throughput capture (4 windows and a
    13-block partial one) through ``python -m rtlamr_tpu_torch
    -coordinator -checkpoint`` in two processes on the card, one local
    device and two windows a shard each (one full super-batch and a partial
    one, so the halo ring crosses the process seam and its wrap hop the
    super-batch seam), with SIGINT on process 0 during its first
    super-batch, and then the resumed run: the two runs' records partition the plain CLI's,
    each message at Offset = its block x block bytes, each in its own
    process's windows and in window order; each process launches K1 once a
    window it dispatched and once an escalation. Returns K1's launches per
    process, over both runs."""
    t_phase = time.perf_counter()
    cfg = build_decoder_config([new_parser(n, 72) for n in ALL])
    spec = make_frontend_spec(cfg, window_blocks)
    bs2, w = cfg.block_size2, spec.window
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "throughput.bin")
        iq.tofile(path)
        args = ["-msgtype=all", "-symbollength=72", f"-windowblocks={window_blocks}",
                "-format=json", f"-fromfile={path}"]
        rc, plain, _ = run_cli(args)
        check(rc == 0 and len(plain) == len(feed_msgs), f"multihost: plain rc {rc}, {len(plain)}")
        want = sorted((b * bs2, json.dumps(r["Message"], sort_keys=True))
                      for (b, _), r in zip(feed_msgs, plain))
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        head = multihost_run(args + [f"-checkpoint={ck}"], sigint_at=1)
        t1 = time.perf_counter()
        check(all("interrupted" in e and "checkpoint saved at byte" in e for _, e, _, _ in head),
              "multihost: the interrupted run saved no checkpoint")
        tail = multihost_run(args + [f"-checkpoint={ck}"])
        t2 = time.perf_counter()
        check(not os.path.exists(ck + ".p0.meta.json"), "multihost: checkpoint left at EOF")
    runs = list(zip(head, tail))
    got = [[(r["Offset"], json.dumps(r["Message"], sort_keys=True)) for r in h[0] + t[0]]
           for h, t in runs]
    check(sorted(got[0] + got[1]) == want,
          f"multihost: {len(got[0])} + {len(got[1])} records over the interrupted and resumed "
          f"runs, the plain CLI {len(want)}, or they differ")
    for p, recs in enumerate(got):
        offsets = [off for off, _ in recs]
        check(offsets == sorted(offsets)
              and all((off // bs2 // (w // spec.block_size)) // 2 % 2 == p for off in offsets),
              f"multihost: process {p} emitted out of window order or a message of another "
              "process's windows")
    launches, windows, overflows, batches, ring_ms, seam_ms = [], [], [], [], [], []
    for p, (h, t) in enumerate(runs):
        k = h[2] + t[2]
        b = h[3]["superbatches"] + t[3]["superbatches"]
        o = h[3]["hit_overflows"] + t[3]["hit_overflows"]
        # every window of a super-batch is dispatched, valid or not
        check(k == b * 2 + o, f"multihost: process {p} launched K1 {k} times, want "
              f"{b} super-batches x 2 windows + {o} escalations")
        launches.append(k)
        batches.append(b)
        overflows.append(o)
        windows.append(h[3]["windows_decoded"] + t[3]["windows_decoded"])
        ring_ms.append((h[3]["ring_exchange_ms"] + t[3]["ring_exchange_ms"]) / b)
        seam_ms.append((h[3]["seam_dedup_ms"] + t[3]["seam_dedup_ms"]) / b)
    emit("multihost", card=card, processes=2, devices_per_process=1, scan_windows=2,
         super_batches=batches, records=[len(g) for g in got], plain=len(want),
         partition_of_plain=True, launches_k1_per_process=launches,
         windows_per_process=windows, hit_overflows=overflows,
         ring_exchange_ms_per_super_batch=ring_ms, seam_dedup_ms_per_super_batch=seam_ms,
         interrupted_records=[len(r) for r, _, _, _ in head],
         resumed_records=[len(r) for r, _, _, _ in tail],
         interrupted_run_seconds=t1 - t0, resumed_run_seconds=t2 - t1,
         seconds=time.perf_counter() - t_phase)
    return launches


def phase_wideband_cli():
    """tests/test_wideband.py's six-packet four-channel capture through the
    CLI with -crosschanneldedup: exactly the planted packets. (In
    tests/test_cli.py's four-packet version of it the R900 burst's copy on
    channel 0 also decodes and, as the lowest channel, wins the dedup, in
    the JAX CLI as in the port.)"""
    cfg = build_decoder_config([new_parser(x, 8) for x in ALL])
    window = 24 * cfg.block_size
    planted = [
        (0, 111001, synth.bits_to_burst(synth.make_scm_bits(meter_id=111001, consumption=1), 3000)),
        (1, 222002, synth.bits_to_burst(synth.make_scm_bits(meter_id=222002, consumption=2),
                                        window - 700)),
        (2, 333003, synth.r900_burst(synth.make_r900_symbols(meter_id=333003), 5000)),
        (3, 444004, synth.bits_to_burst(synth.make_idm_bits(serial=444004), 300)),
        (0, 555005, synth.bits_to_burst(synth.make_scm_bits(meter_id=555005, consumption=5),
                                        20000)),
        (2, 666006, synth.bits_to_burst(synth.make_scm_bits(meter_id=666006, consumption=6),
                                        2 * window - 2000)),
    ]
    wb = synth.render_wideband(3 * window, [(c, b) for c, _, b in planted], 4, 8,
                               amplitude=90.0, noise=2.0, seed=21)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wideband.bin")
        wb.tofile(path)
        argv = ["-channels=4", "-msgtype=all", "-symbollength=8", "-windowblocks=24",
                "-format=json", "-crosschanneldedup=true", f"-fromfile={path}"]
        decode_stencil.launches = 0
        channelize_requantize_fused.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
        k1, k2 = decode_stencil.launches, channelize_requantize_fused.launches
    check(rc == 0, f"wideband_cli: exit code {rc}")
    recs = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    got = [(r["Channel"], r["Message"].get("ID", r["Message"].get("ERTSerialNumber")))
           for r in recs]
    want = sorted((c, mid) for c, mid, _ in planted)
    check(sorted(got) == want, f"wideband_cli: {sorted(got)}, planted {want}")
    check(k2 > 0 and k1 > 0, f"wideband_cli: launches k1 {k1}, k2 {k2}")
    emit("wideband_cli", messages=len(recs), planted=len(planted), exact=True,
         launches_k1=k1, launches_k2=k2)
    return k1, k2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_device()
    n_windows = 4
    cfg = build_decoder_config([new_parser(n, 72) for n in ALL])
    spec = make_frontend_spec(cfg, 1024)
    iq, planted = build_capture(cfg, n_windows, spec.window, spec.halo)
    phase_build()
    # The paths run first: after the kernel phases' torch.profiler sessions
    # the process launched the window program's kernels more slowly, which
    # showed in the paths' host and span times.
    cli_launches = phase_cli()
    msgs, (launches, la_feed_launches, search_feed_launches), feed_host_ms = phase_decode(
        card, iq, planted)
    batch_launches, run_window_launches = phase_batch(iq, msgs)
    lookahead_launches = phase_lookahead(card, iq, planted)
    wide_k1, wide_k2, wide = phase_wideband(card)
    # The port's oracle over the throughput capture in worker processes
    # while the untimed wideband_cli and resume phases run, and waited for
    # before the kernel phases time anything.
    pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        t_oracle = time.perf_counter()
        oracle = start_oracle(pool, iq, ALL, 72, ORACLE_WORKERS)
        wcli_k1, wcli_k2 = phase_wideband_cli()
        resume_k1, resume_k2 = phase_resume(card, iq, msgs, wide)
        t_wait = time.perf_counter()
        rows = [r for f in oracle for r in f.result()]
    finally:
        pool.shutdown(cancel_futures=True)
    want = [(b, str(m)) for b, m in msgs]
    check(rows == want, f"resume_oracle: the oracle gives {len(rows)} messages, the "
          f"straight stream (and so every resumed one) {len(want)}, or they differ")
    emit("resume_oracle", messages=len(rows), equal=True, workers=ORACLE_WORKERS,
         seconds=time.perf_counter() - t_oracle, waited_s=time.perf_counter() - t_wait)
    # The native phase times host work, so it runs once the workers are done.
    native_k1 = phase_native(card, iq, planted, msgs, feed_host_ms)
    mesh_k1, mesh_streams = phase_mesh(card, iq, msgs)
    mesh_staged_k1 = phase_mesh_staged(card, iq, planted, mesh_streams)
    wmesh_k1, wmesh_k2 = phase_wide_mesh(card, wide)
    del wide
    multihost_k1 = phase_multihost(card, iq, msgs)
    del msgs
    k1 = phase_k1(card, iq)
    k2 = phase_k2(card)
    # After k2: run between k1 and k2, it was followed by a k2 profiler
    # record that held 17 of 20 launches (H100, torch 2.11).
    la = phase_lookahead_time(card, iq)
    search = phase_search(card, iq)
    del iq
    print(json.dumps({"kernels": [{
        "name": "decode_stencil",
        "route": "cuda",
        "source": "rtlamr_tpu_torch/csrc/decode_stencil.cu",
        "replaces": "rtlamr_tpu/ops/pallas_frontend.py:73",
        "launches": launches,
        "launches_cli": cli_launches,
        "launches_batch": batch_launches,
        "launches_run_window": run_window_launches,
        "launches_wideband": wide_k1,
        "launches_wideband_cli": wcli_k1,
        "launches_resume": resume_k1,
        "launches_native": native_k1,
        "launches_mesh": mesh_k1,
        "launches_mesh_staged": mesh_staged_k1,
        "launches_wide_mesh": wmesh_k1,
        "launches_multihost_per_process": multihost_k1,
        "parity": "exact",
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "kernel_ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
        "card": card,
    }, {
        "name": "lookahead_mask",
        "route": "cuda",
        "source": "rtlamr_tpu_torch/csrc/decode_stencil.cu",
        "replaces": None,
        "launches": la_feed_launches,
        "launches_lookahead_cli": lookahead_launches,
        "parity": "exact",
        "ms": la["ms"],
        "kernel_ms": la["kernel_ms"],
        "plain_ms": la["plain_ms"],
        "bound_ms": la["bound_ms"],
        "bound_by": la["bound_by"],
        "library_ms": None,
        "card": card,
    }, {
        "name": "search",
        "route": "cuda",
        "source": "rtlamr_tpu_torch/csrc/search.cu",
        "replaces": None,
        "launches": search_feed_launches,
        "parity": "exact",
        "ms": search["ms"],
        "kernel_ms": search["kernel_ms"],
        "plain_ms": search["plain_ms"],
        "bound_ms": search["bound_ms"],
        "bound_by": search["bound_by"],
        "launch_floor_ms": search["launch_floor_ms"],
        "kept": search["kept"],
        "library_ms": None,
        "card": card,
    }, {
        "name": "channelizer",
        "route": "cuda",
        "source": "rtlamr_tpu_torch/csrc/channelizer.cu",
        "replaces": "rtlamr_tpu/ops/pallas_channelizer.py:58",
        "launches": wide_k2,
        "launches_wideband_cli": wcli_k2,
        "launches_resume": resume_k2,
        "launches_wide_mesh": wmesh_k2,
        "blocks": [f"[{c0}, {c0 + rows}) of {n}" for n, c0, rows in K2_BLOCKS],
        "parity": "exact",
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "kernel_ms": k2["kernel_ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": None,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"phase": "done", "seconds": time.perf_counter() - t_start}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
