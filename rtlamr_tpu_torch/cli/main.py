"""rtlamr CLI — receiver lifecycle and the streaming loop.

Port of the JAX package's ``cli/main.py``, mirroring the reference's
orchestration (main.go:59-368): flag handling and env override,
receiver construction, tuner configuration over rtl_tcp, filter-chain
assembly, the steady-state decode loop with cross-block dedup, -single
one-shot behavior, -duration time limit, and -samplefile dumping. The
three-goroutine pipeline becomes: read a chunk -> feed the decoder -> encode
filtered, deduped messages. The decoder is the narrowband
:class:`~rtlamr_tpu_torch.decoder.WindowDecoder` (CUDA stencil kernel +
search on the card) or, with ``-channels`` > 1, the
:class:`~rtlamr_tpu_torch.parallel.WidebandDecoder` (CUDA channelizer
kernel, then the same window program for every channel), with
``-crosschanneldedup``; with ``-mesh``, the
:class:`~rtlamr_tpu_torch.parallel.MeshDecoder` (one channel: the same
windows time-sharded over every local card) or the
:class:`~rtlamr_tpu_torch.parallel.WidebandMeshDecoder` (``-channels``
> 1: channel x time shards over every local card). ``-coordinator`` runs
:func:`run_multihost`, the multi-host decoder of a -fromfile capture over
processes joined by ``torch.distributed`` (gloo).

``-ingest`` picks the sample transport: ``native`` the C++ transport
(``native/``: mmapped capture files, an rtl_tcp reader thread and ring),
``python`` the ``io/`` module, ``auto`` native when its library builds.
Standard input is always read by Python. ``-checkpoint`` resumes and saves
the stream position of every decoder here (``decoder/checkpoint.py``).
"""

from __future__ import annotations

import datetime
import itertools
import os
import signal
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import __version__, native
from ..decoder.checkpoint import (
    MultiHostCheckpoint,
    capture_checkpoint,
    checkpoint_exists,
    load_checkpoint,
    remove_checkpoint,
    restore_checkpoint,
)
from ..decoder.pipeline import WindowDecoder
from ..device import DeviceLike
from ..io.capture import (
    FileSource,
    IQSource,
    RtlTcpSource,
    SampleDumper,
    SampleRing,
    StdinSource,
)
from ..io.rtltcp import RtlTcpClient
from ..ops.channelizer_fused import channelize_requantize_fused
from ..parallel.distributed import MultiHostDecoder, initialize
from ..parallel.mesh import MeshDecoder, resolve_devices
from ..parallel.wideband import WidebandDecoder
from ..parallel.wideband_mesh import WidebandMeshDecoder
from ..protocols import new_parser
from ..utils import observability
from ..utils.observability import TRACER, RateWatchdog, profile_trace, span
from .encoders import LogMessage, make_encoder
from .filters import FilterChain, MeterIDFilter, MeterTypeFilter, UniqueFilter
from .flags import VALID_SYMBOL_LENGTHS, FlagSet, build_flagset


def _log(*args) -> None:
    print(*args, file=sys.stderr)


def expand_msgtypes(msgtypes: set) -> List[str]:
    """"all" alone expands to scm, scm+, idm, r900 (main.go:67-73)."""
    if msgtypes == {"all"}:
        return ["scm", "scm+", "idm", "r900"]
    return sorted(msgtypes)


def build_filter_chain(fs: FlagSet) -> FilterChain:
    """Filter chain in the reference's flag.Visit order (main.go:97-114:
    lexicographic — filterid, filtertype, unique)."""
    fc = FilterChain()
    if fs["filterid"].set_explicitly:
        fc.append(MeterIDFilter(fs.value("filterid")))
    if fs["filtertype"].set_explicitly:
        fc.append(MeterTypeFilter(fs.value("filtertype")))
    if fs.value("unique"):
        fc.append(UniqueFilter())
    return fc


#: the -device argument of run(): one device, or for -mesh one device a shard
Devices = Union[DeviceLike, Sequence[DeviceLike]]


def _wideband_mesh_shape(channels: int, n_devices: int) -> Tuple[int, int]:
    """(cdev, tdev) for -channels -mesh: the largest channel-axis shard
    count that divides both the channel count and the device count (channel
    sharding needs no halo, so it is preferred), time shards on the rest
    (rtlamr_tpu/cli/main.py:64-74)."""
    for cdev in range(min(channels, n_devices), 0, -1):
        if channels % cdev == 0 and n_devices % cdev == 0:
            return cdev, n_devices // cdev
    return 1, n_devices


def _mesh_devices(device: Devices) -> List[torch.device]:
    """-mesh's devices: the caller's list, one device as a list of one, or
    None, every local card (raises without one)."""
    if device is not None and not isinstance(device, (list, tuple)):
        device = [device]
    return resolve_devices(device, "-mesh")


class Receiver:
    """Receiver lifecycle (main.go:49-133) for live and offline sources."""

    def __init__(self, fs: FlagSet, device: Devices = None):
        self.fs = fs
        channels = fs.value("channels")
        if channels < 1:
            _log(f"invalid -channels value {channels} (want >= 1)")
            raise SystemExit(1)
        ingest = fs.value("ingest")
        if ingest not in ("auto", "native", "python"):
            _log(f"invalid -ingest value {ingest!r} (want auto|native|python)")
            raise SystemExit(1)
        chip_length = fs.value("symbollength")
        self.latency = fs.value("latency")
        if self.latency and not fs["windowblocks"].set_explicitly:
            # Latency preset: a 4-block window keeps the device program's
            # span ~7 ms of airtime at the default rate (vs ~110 ms at the
            # throughput default of 64); -windowblocks still wins when set.
            fs["windowblocks"].value = 4
        if fs["backend"].set_explicitly:
            _log(f"-backend={fs.value('backend')} has no effect: "
                 "rtlamr_tpu_torch always runs its CUDA stencil kernel")

        names = expand_msgtypes(fs.value("msgtype"))
        self.parsers = []
        for name in names:
            try:
                self.parsers.append(new_parser(name, chip_length))
            except ValueError as e:
                _log("message type error:", e)
                raise SystemExit(1)

        self.fc = build_filter_chain(fs)
        self.wideband = channels > 1
        mesh = fs.value("mesh")
        if isinstance(device, (list, tuple)) and not mesh:
            raise ValueError("a list of devices needs -mesh")
        if self.wideband and mesh:
            # The channel x time mesh over every local card, or over the
            # caller's devices (parallel/wideband_mesh.py).
            devices = _mesh_devices(device)
            cdev, tdev = _wideband_mesh_shape(channels, len(devices))
            _log(f"wideband mesh: {cdev} channel-shards x {tdev} time-shards over "
                 f"{cdev * tdev} devices")
            self.decoder = WidebandMeshDecoder(
                self.parsers,
                n_channels=channels,
                mesh_shape=(cdev, tdev),
                devices=devices,
                window_blocks=fs.value("windowblocks"),
                max_hits=fs.value("maxhits"),
                filter_fn=self.fc.match,
                cross_channel_dedup=fs.value("crosschanneldedup"),
            )
        elif self.wideband:
            # One stream at channels*samplerate, channelized on the card
            # and decoded per channel (parallel/wideband.py).
            self.decoder = WidebandDecoder(
                self.parsers,
                n_channels=channels,
                window_blocks=fs.value("windowblocks"),
                max_hits=fs.value("maxhits"),
                filter_fn=self.fc.match,
                cross_channel_dedup=fs.value("crosschanneldedup"),
                device=device,
            )
        elif mesh:
            # Time-sharded over every local card (one shard each), or over
            # the caller's devices.
            self.decoder = MeshDecoder(
                self.parsers,
                devices=_mesh_devices(device),
                window_blocks=fs.value("windowblocks"),
                max_hits=fs.value("maxhits"),
                filter_fn=self.fc.match,
            )
            _log(f"mesh: {self.decoder.n_devices} devices")
        else:
            self.decoder = WindowDecoder(
                self.parsers,
                window_blocks=fs.value("windowblocks"),
                max_hits=fs.value("maxhits"),
                filter_fn=self.fc.match,
                device=device,
            )
        self.cfg = self.decoder.cfg
        #: the rtl_tcp client (either transport) of a live run
        self.client = None

    def center_freq(self) -> int:
        """The capture's RF center (an explicit -centerfreq wins)."""
        if self.fs["centerfreq"].set_explicitly:
            return self.fs.value("centerfreq")
        return self.cfg.center_freq

    @property
    def native_rate(self) -> int:
        """The input sample rate the decoder expects: channels x the
        decoder's rate in wideband mode."""
        return self.decoder.wideband_sample_rate if self.wideband else self.cfg.sample_rate

    def log_channel_plan(self) -> None:
        """Startup per-channel center-frequency dump (wideband mode)."""
        freqs = self.decoder.channel_center_freqs(self.center_freq())
        _log(f"wideband: {self.decoder.n_channels} channels at "
             f"{self.native_rate} S/s total")
        for c, f in enumerate(freqs):
            _log(f"  channel {c}: {f / 1e6:.6f} MHz")

    def _use_native(self) -> bool:
        """Resolve -ingest (rtlamr_tpu/cli/main.py:175-190): ``python`` the
        Python transport, ``native`` the C++ one (exit 1 when its library
        does not build), ``auto`` native when it builds. Logs the choice."""
        mode = self.fs.value("ingest")
        use = mode != "python" and native.available()
        if mode == "native" and not use:
            _log(f"native ingest unavailable: {native.load_error()}")
            raise SystemExit(1)
        _log(f"ingest: {'native' if use else 'python'} (-ingest={mode})")
        return use

    def open_source(self) -> IQSource:
        fs = self.fs
        fromfile = fs.value("fromfile")
        if fromfile:
            if fromfile == "-":
                return StdinSource()
            if self._use_native():
                return native.NativeFileSource(fromfile)
            return FileSource(fromfile)

        if self._use_native():
            client = native.NativeRtlTcpClient(fs.value("server"))
        else:
            client = RtlTcpClient(fs.value("server"))
        info = client.connect()
        self.client = client

        sample_rate = (
            fs.value("samplerate")
            if fs["samplerate"].set_explicitly
            else self.native_rate
        )
        client.set_center_freq(self.center_freq())
        client.set_sample_rate(sample_rate)

        gain_flags = ("gainbyindex", "tunergainmode", "tunergain", "agcmode")
        gain_set = any(self.fs[g].set_explicitly for g in gain_flags)
        if not gain_set:
            client.set_gain_mode(manual=False)  # auto gain (main.go:119-121)
        else:
            if fs["tunergainmode"].set_explicitly:
                client.set_gain_mode(manual=fs.value("tunergainmode"))
            if fs["tunergain"].set_explicitly:
                client.set_tuner_gain(fs.value("tunergain") * 10)
            if fs["gainbyindex"].set_explicitly:
                client.set_gain_by_index(fs.value("gainbyindex"))
            if fs["agcmode"].set_explicitly:
                client.set_agc_mode(fs.value("agcmode"))
        if fs["freqcorrection"].set_explicitly:
            client.set_freq_correction(fs.value("freqcorrection"))
        if fs["directsampling"].set_explicitly:
            client.set_direct_sampling(fs.value("directsampling"))
        if fs["offsettuning"].set_explicitly:
            client.set_offset_tuning(fs.value("offsettuning"))
        if fs["biastee"].set_explicitly:
            client.set_bias_tee(fs.value("biastee"))

        _log(f"rtl_tcp GainCount: {info.gain_count}")
        return RtlTcpSource(client)


def _read_past(source: IQSource, n_bytes: int, keep: int):
    """Read and drop the first ``n_bytes`` of ``source``: (bytes read, the
    last ``keep`` of them)."""
    done, tail = 0, np.zeros(0, np.uint8)
    while done < n_bytes:
        part = source.read(min(1 << 20, n_bytes - done))
        if part.size == 0:
            break
        done += part.size
        if keep:
            tail = np.concatenate([tail, part])[-keep:]
    return done, tail


class _SigintFlag:
    """While active (in the main thread only), SIGINT sets ``raised``
    instead of interrupting: the decode loop reads it between two steps,
    where the decoder state and the bytes consumed agree."""

    def __init__(self, active: bool):
        self.raised = False
        self._prev, self._set = None, False
        if active and threading.current_thread() is threading.main_thread():
            self._prev = signal.signal(signal.SIGINT, self._on_sigint)
            self._set = True

    def _on_sigint(self, *_):
        self.raised = True

    def close(self) -> None:
        if self._set:
            signal.signal(signal.SIGINT, self._prev)
            self._set = False


def run_multihost(fs: FlagSet, out=None, device: Devices = None) -> int:
    """Multi-host capture decode (-coordinator/-numprocs/-procid), port of
    rtlamr_tpu/cli/main.py:282-463.

    Every process runs the SAME command: it joins the gloo process group at
    -coordinator and decodes its contiguous share of every super-batch of
    the -fromfile capture through
    :class:`~rtlamr_tpu_torch.parallel.distributed.MultiHostDecoder` on its
    local devices (every visible card; ``-cpudevices=N`` N CPU devices, or
    ``device`` when the caller gives one or a list), with the halo ring and
    the seam digest dedup over gloo, so a packet on a process seam decodes
    once globally. Each process emits ITS windows' messages on its own
    stdout, with Offset = global block index x block bytes and Length = one
    block: the message's block in the -fromfile capture.

    After every super-batch the processes agree on whether to stop with one
    gloo ``all_reduce``: a -duration deadline, the -single condition over
    every process's messages, or SIGINT (taken only between super-batches)
    on any process. ``-checkpoint=PATH`` resumes from and saves one file set
    a process (``PATH.pN``) at the exact byte boundary consumed: a stop
    after the last, partial super-batch saves the capture's end, and its
    resume decodes nothing again. A run to the end of the capture deletes
    the set."""
    out = sys.stdout if out is None else out
    fromfile = fs.value("fromfile")
    if not fromfile or fromfile == "-":
        _log("-coordinator requires -fromfile (seekable capture)")
        return 1
    # Flags the multi-host batch path does not implement: say so rather than
    # dropping them silently.
    for name in ("samplefile", "channels", "latency", "mesh"):
        if fs[name].set_explicitly:
            _log(f"-{name} is not supported in multi-host mode; ignoring")
    chip_length = fs.value("symbollength")
    try:
        parsers = [new_parser(name, chip_length) for name in expand_msgtypes(fs.value("msgtype"))]
    except ValueError as e:
        _log("message type error:", e)
        return 1
    num_procs, proc_id = fs.value("numprocs"), fs.value("procid")
    cpudev = fs.value("cpudevices")
    created = not dist.is_initialized()
    local = initialize(fs.value("coordinator"), num_procs, proc_id,
                       cpu_devices_per_process=cpudev if cpudev > 0 else None)
    if local is None and device is not None:
        local = _mesh_devices(device)
    try:
        return _run_multihost(fs, out, parsers, local)
    finally:
        if created:
            dist.destroy_process_group()


def _run_multihost(fs: FlagSet, out, parsers, devices) -> int:
    fc = build_filter_chain(fs)
    dec = MultiHostDecoder(parsers, window_blocks=fs.value("windowblocks"),
                           max_hits=fs.value("maxhits"), filter_fn=fc.match, devices=devices)
    p, n = dec.process_id, dec.num_processes
    _log(dec.cfg.describe())
    _log(f"multi-host: process {p} of {n}, {dec.n_local} local devices, "
         f"{dec.n_global} in all")
    encoder = make_encoder(fs.value("format"), out)
    fromfile = fs.value("fromfile")
    lwb = dec.local_window_bytes
    batch_bytes = n * lwb
    bs2 = dec.cfg.block_size2
    total_blocks = os.path.getsize(fromfile) // bs2
    batch_blocks = batch_bytes // bs2
    n_batches = -(-total_blocks // batch_blocks)

    single = fs.value("single")
    filter_ids = sorted(fs.value("filterid")) if fs["filterid"].set_explicitly else []
    waiting_ids = set(filter_ids) if single else set()
    duration = fs.value("duration")
    deadline = time.monotonic() + duration if duration > 0 else None
    ckpt_path = fs.value("checkpoint")

    # Resume: every process holds its own file set, and all must agree.
    j0, status = 0, ("none", 0)
    if ckpt_path and os.path.exists(f"{ckpt_path}.p{p}.meta.json"):
        try:
            ckpt = MultiHostCheckpoint.load(ckpt_path, p)
            restore_checkpoint(dec, ckpt)
            if ckpt.byte_offset > total_blocks * bs2:
                raise ValueError(f"the capture's whole blocks end at byte {total_blocks * bs2}, "
                                 f"before the checkpoint's {ckpt.byte_offset}")
            status = ("resume", ckpt.byte_offset)
        except (OSError, ValueError) as e:  # every process learns of it below
            _log(f"-checkpoint: {e}")
            status = ("error", 0)
    statuses = [None] * n
    dist.all_gather_object(statuses, status)
    if any(s[0] == "error" for s in statuses) or len(set(statuses)) != 1:
        if len(set(statuses)) != 1:
            _log(f"-checkpoint: the processes' file sets disagree: {statuses}")
        return 1
    if status[0] == "resume":
        # The exact boundary consumed: a stop after the last, partial
        # super-batch saved the capture's end, which resumes past it.
        j0 = -(-status[1] // batch_bytes)
        _log(f"resumed from checkpoint at byte {status[1]}")

    got_any = False  # -single without -filterid: any message stops the run

    def emit(msgs) -> None:
        nonlocal got_any
        for b, msg in msgs:
            got_any = True
            if waiting_ids:
                waiting_ids.discard(msg.meter_id())
            encoder.encode(LogMessage(time=datetime.datetime.now(), offset=b * bs2,
                                      length=bs2, msg=msg))

    def agree_stop(sigint: bool) -> Tuple[bool, bool, bool]:
        """One all_reduce (MAX) of this process's votes, so every process
        reaches the same verdict: (stop, deadline hit, SIGINT) anywhere. With
        -single -filterid the meters still awaited are those no process has
        seen."""
        late = deadline is not None and time.monotonic() >= deadline
        done = single and (not waiting_ids if filter_ids else got_any)
        seen = [0 if i in waiting_ids else 1 for i in filter_ids] if single else []
        votes = torch.tensor([int(done), int(late), int(sigint)] + seen, dtype=torch.int64)
        dist.all_reduce(votes, op=dist.ReduceOp.MAX)
        v = votes.tolist()
        if single and filter_ids:
            waiting_ids.intersection_update(i for i, s in zip(filter_ids, v[3:]) if not s)
            v[0] = int(not waiting_ids)
        return bool(max(v[:3])), bool(v[1]), bool(v[2])

    sigint = _SigintFlag(True)
    stopped = interrupted = single_stop = False
    j = j0
    try:
        with open(fromfile, "rb") as f:
            while j < n_batches:
                f.seek(j * batch_bytes + p * lwb)
                seg = np.frombuffer(f.read(lwb), np.uint8)
                if seg.size < lwb:
                    seg = np.concatenate([seg, np.zeros(lwb - seg.size, np.uint8)])
                vb = min(total_blocks - j * batch_blocks, batch_blocks)
                emit(dec.decode_superbatch_local(seg, None if vb == batch_blocks else vb))
                j += 1
                stopped, late, interrupted = agree_stop(sigint.raised)
                if stopped:
                    if late:
                        _log("time limit reached")
                    if interrupted:
                        _log("interrupted")
                    single_stop = not (late or interrupted)
                    break
        # Complete the dispatch-ahead tail. After a -single stop the
        # reference's receiver is already cancelled (main.go:270-276), so
        # in-flight messages are not emitted, unless a checkpoint follows
        # (its resume starts after them).
        tail = dec.drain()
        if not single_stop or ckpt_path:
            emit(tail)
        if ckpt_path:
            if stopped or j < n_batches:
                boundary = min(j * batch_bytes, total_blocks * bs2)
                capture_checkpoint(dec, boundary).save(ckpt_path)
                _log(f"checkpoint saved at byte {boundary}")
            else:  # a run to the end of the capture needs none
                remove_checkpoint(ckpt_path, p)
    finally:
        sigint.close()
        if fs.value("metrics"):
            _log("metrics:", dec.metrics.snapshot())
    return 0


def run(fs: FlagSet, out=None, device: Devices = None) -> int:
    """Decode loop; messages go to ``out`` (``sys.stdout`` as it is at call
    time when None, so a caller's stdout redirection applies).

    With ``-checkpoint=PATH`` a run resumes from PATH's checkpoint when one
    is there, and a run that stops before the end of its stream (-single,
    -duration, SIGINT) saves one; a run to the end of its stream leaves
    none. SIGINT is then taken only between two feeds, so the saved
    position always matches the decoder's state."""
    if fs.value("coordinator"):
        return run_multihost(fs, out, device)
    out = sys.stdout if out is None else out
    traced_before = TRACER.on
    if fs.value("metrics"):
        observability.enable()
    since = TRACER.snapshot()
    try:
        return _run(fs, out, device, since)
    finally:
        TRACER.end_windows()
        if not traced_before:
            observability.disable()


def _run(fs: FlagSet, out, device: Devices, since) -> int:
    """:func:`run`'s single-process loop; ``since`` is the tracer as it was
    when the run began."""
    receiver = Receiver(fs, device)
    # Startup config dump, unconditional — the reference logs the decoder
    # config at receiver construction (main.go:124, decode.go:73-90), for
    # both live and -fromfile runs.
    _log(receiver.cfg.describe())
    if receiver.wideband:
        receiver.log_channel_plan()
    dec = receiver.decoder
    ckpt_path = fs.value("checkpoint")
    resume = None
    if ckpt_path and checkpoint_exists(ckpt_path):
        try:
            resume = load_checkpoint(ckpt_path)
            restore_checkpoint(dec, resume)
        except ValueError as e:
            _log(f"-checkpoint: {e}")
            return 1

    dumper = SampleDumper(fs.value("samplefile"))
    encoder = make_encoder(fs.value("format"), out, fs.value("samplefile"))

    # -single bookkeeping (main.go:270-276): with -filterid, wait for one
    # message from each listed meter.
    single = fs.value("single")
    waiting_ids = set(fs.value("filterid")) if single else set()

    duration = fs.value("duration")
    deadline = time.monotonic() + duration if duration > 0 else None

    source = receiver.open_source()
    wideband = receiver.wideband
    nch = dec.n_channels if wideband else 1
    live = not fs.value("fromfile")
    watchdog = RateWatchdog(receiver.native_rate, warn=_log) if live else None

    # In wideband mode the ring (and -samplefile dumps) hold WIDEBAND bytes:
    # channel-block b of every channel comes from the same wideband byte
    # range, so one ring block = nch * block_size2 bytes.
    block_bytes = nch * dec.cfg.block_size2
    # Latency preset reads one reference block per iteration (the Go
    # receiver's own granularity, main.go:156-205) instead of the large
    # throughput-oriented chunks, so data never waits in the read buffer.
    chunk_bytes = (
        block_bytes if receiver.latency else max(block_bytes, 1 << 18)
    )
    # Rolling sample buffer simulation for Offset/Length and -samplefile
    # dumps (main.go:225-230,279-284). Blocks are retained up to the
    # dispatch-ahead decode latency (two windows) plus the ring capacity.
    ring_cap_blocks = -(-dec.cfg.buffer_length * 2 // dec.cfg.block_size2)
    ring_bytes = nch * dec.cfg.buffer_length * 2
    ring = SampleRing(
        dumper,
        block_bytes,
        ring_bytes,
        max_lag_blocks=2 * (dec.window_bytes // block_bytes)
        + ring_cap_blocks
        + 4,
    )

    consumed = 0
    if resume is not None:
        consumed = resume.byte_offset
        history, note = None, ""
        if not live:
            # Read past the capture bytes already decoded.
            t0 = time.perf_counter()
            keep = (ring_bytes // block_bytes + 1) * block_bytes if dumper.active else 0
            done, history = _read_past(source, consumed, keep)
            if done < consumed:
                _log(f"-checkpoint: the capture ends at byte {done}, before the "
                     f"checkpoint's {consumed}")
                source.close()
                dumper.close()
                return 1
            note = f" (read past in {(time.perf_counter() - t0) * 1e3:.3f} ms)"
        ring.resume_at(consumed // block_bytes, history)
        _log(f"resumed from checkpoint at byte {consumed}{note}")

    def by_block(msgs):
        """Decode results as block-major (block, channel, msg):
        WindowDecoder yields (block, msg); WidebandDecoder yields (channel,
        block, msg) channel-major, re-sorted so the ring walk advances
        monotonically."""
        if wideband:
            return [(b, c, m) for c, b, m in sorted(msgs, key=lambda t: (t[1], t[0]))]
        return [(b, None, m) for b, m in msgs]

    def emit(msgs, last: bool = False) -> bool:
        """Encode ``msgs`` in the reference's per-block ring walk
        (main.go:225-230), so Offset/Length and the post-block buffer dump
        match main.go:242-284 exactly. True once -single has all it waits
        for; ``last`` (the drain before a checkpoint) encodes them all."""
        done = False
        for block, group in itertools.groupby(by_block(msgs), key=lambda t: t[0]):
            ring.advance_to(block)
            for _b, chan, msg in group:
                encoder.encode(
                    LogMessage(
                        time=datetime.datetime.now(),
                        offset=dumper.offset(),
                        length=ring.length,
                        msg=msg,
                        channel=chan,
                    )
                )
                if single and not last:
                    if not waiting_ids:
                        done = True
                        break
                    waiting_ids.discard(msg.meter_id())
            ring.dump()
            if single and not last and not waiting_ids:
                _log("single: received messages from all meters")
                done = True
            if done:
                break
        return done

    # With -checkpoint, SIGINT only sets a flag, read at the top of each
    # iteration: the stream then stops between two feeds, where the decoder
    # state and ``consumed`` agree.
    sigint = _SigintFlag(bool(ckpt_path))
    # Each window of the single-card decoders (a super-step of the wideband
    # one) has a root span (cli.window) while the tracer is on.
    windows = TRACER.on and type(dec) in (WindowDecoder, WidebandDecoder)
    k2_launches = channelize_requantize_fused.launches
    dropped_seen = 0
    stop = eof = False
    at_boundary = True  # no feed is under way
    try:
        try:
            with profile_trace(fs.value("profiledir") or None):
                while not stop:
                    if sigint.raised:
                        _log("interrupted")
                        break
                    if deadline is not None and time.monotonic() >= deadline:
                        _log("time limit reached")
                        break
                    try:
                        with span("cli.read"):
                            chunk = source.read(chunk_bytes)
                    except (EOFError, OSError) as e:
                        # A stalled or closed stream cancels the receiver, like
                        # the reference's read-deadline path (main.go:168-181).
                        _log(f"source read: {e}")
                        chunk = np.zeros(0, np.uint8)
                    if windows:
                        TRACER.read_returned()
                        decoded = dec.metrics.windows_decoded
                    if watchdog is not None:
                        watchdog.add_bytes(chunk.size)
                        dropped = source.dropped_bytes()
                        if dropped > dropped_seen:
                            _log(
                                "ingest ring overflow: "
                                f"{dropped} bytes dropped so far"
                            )
                        dropped_seen = dropped
                        dec.metrics.extra["bytes_dropped"] = dropped
                    at_boundary = False
                    if chunk.size == 0:
                        eof = True
                        msgs = dec.flush()
                    else:
                        ring.feed(chunk)
                        msgs = dec.feed(chunk)
                        consumed += chunk.size
                        if receiver.latency:
                            # Synchronous completion: skip the one-window
                            # dispatch-ahead so results emit as soon as the
                            # window computes (throughput preset keeps it).
                            msgs = list(msgs) + list(dec.drain())
                    done = dec.metrics.windows_decoded - decoded if windows else 0
                    if done:
                        # The windows completed since the read close once
                        # their messages are out.
                        with span("cli.emit", TRACER.last_completed(done)):
                            stop = emit(msgs)
                        TRACER.close_windows(done)
                    else:
                        stop = emit(msgs)
                    at_boundary = True
                    if eof:
                        break
        except KeyboardInterrupt:
            _log("interrupted")
        if ckpt_path:
            if eof:  # a flushed (complete) decode needs none
                remove_checkpoint(ckpt_path)
            elif not at_boundary:
                _log("-checkpoint: interrupted inside a feed; no checkpoint saved")
            else:
                # Emit what is still in the dispatch-ahead pipeline, then
                # checkpoint at the last window boundary (the bytes fed since
                # are read again on resume).
                emit(dec.drain(), last=True)
                boundary = consumed - dec.discard_pending()
                capture_checkpoint(dec, boundary).save(ckpt_path)
                _log(f"checkpoint saved at byte {boundary}")
    finally:
        sigint.close()
        if fs.value("metrics"):
            snap = dec.metrics_snapshot() if wideband else dec.metrics.snapshot()
            _log("metrics:", snap)
            if wideband:
                steps = dec.metrics.windows_decoded
                _log(f"super-steps: {steps} ({dec.metrics.windows_polled} completed by a "
                     f"poll), window programs a super-step: "
                     f"{snap['windows_decoded'] / max(steps, 1):.1f}, K2 launches: "
                     f"{channelize_requantize_fused.launches - k2_launches}")
            for line in TRACER.summary(since):
                _log(line)
        source.close()
        dumper.close()
    return 0


def main(
    argv: Optional[Sequence[str]] = None, device: Devices = None
) -> int:
    """The CLI. ``device=None`` runs on the card (``cuda``; with ``-mesh``
    every local card, a shard each); tests pass ``device="cpu"`` to run the
    plain PyTorch versions in-process, and for ``-mesh`` a list of devices
    (``["cpu"] * 4``), a shard each."""
    fs = build_flagset()
    fs.parse(list(sys.argv[1:] if argv is None else argv))
    fs.env_override(log=_log)

    if fs.value("version"):
        print(f"rtlamr_tpu_torch {__version__}")
        return 0

    sym = fs.value("symbollength")
    if sym not in VALID_SYMBOL_LENGTHS:
        # The whitelist exists for librtlsdr sample-rate bands
        # (misc/modes.go:14-31); offline decode has no such constraint.
        if not fs.value("fromfile"):
            _log("invalid symbollength")
            return 1
        _log(
            f"symbollength {sym} outside the rtl-sdr whitelist "
            f"{VALID_SYMBOL_LENGTHS}; allowed for -fromfile decode"
        )

    fmt = fs.value("format").lower()
    if fmt not in ("plain", "csv", "json", "xml"):
        _log(f"invalid format: {fmt}")
        return 1

    return run(fs, device=device)


if __name__ == "__main__":
    sys.exit(main())
