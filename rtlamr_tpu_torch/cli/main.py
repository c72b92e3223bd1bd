"""rtlamr CLI — receiver lifecycle and the streaming loop.

Port of the JAX package's ``cli/main.py`` for one card, mirroring the
reference's orchestration (main.go:59-368): flag handling and env override,
receiver construction, tuner configuration over rtl_tcp, filter-chain
assembly, the steady-state decode loop with cross-block dedup, -single
one-shot behavior, -duration time limit, and -samplefile dumping. The
three-goroutine pipeline becomes: read a chunk -> feed the decoder -> encode
filtered, deduped messages. The decoder is the narrowband
:class:`~rtlamr_tpu_torch.decoder.WindowDecoder` (CUDA stencil kernel +
search on the card) or, with ``-channels`` > 1, the
:class:`~rtlamr_tpu_torch.parallel.WidebandDecoder` (CUDA channelizer
kernel, then the same window program for every channel), with
``-crosschanneldedup``, or, with ``-mesh`` and one channel, the
:class:`~rtlamr_tpu_torch.parallel.MeshDecoder` (the same windows
time-sharded over every local card).

``-ingest`` picks the sample transport: ``native`` the C++ transport
(``native/``: mmapped capture files, an rtl_tcp reader thread and ring),
``python`` the ``io/`` module, ``auto`` native when its library builds.
Standard input is always read by Python. ``-checkpoint`` resumes and saves
the stream position of every decoder here (``decoder/checkpoint.py``). Not
ported yet, and refused with exit code 1 until their slice lands:
``-channels`` with ``-mesh`` (multi-GPU wideband) and ``-coordinator``
(multi-host).
"""

from __future__ import annotations

import datetime
import itertools
import signal
import sys
import threading
import time
from typing import List, Optional, Sequence, Union

import numpy as np

from .. import __version__, native
from ..decoder.checkpoint import (
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
from ..parallel.mesh import MeshDecoder
from ..parallel.wideband import WidebandDecoder
from ..protocols import new_parser
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


#: where the modes this port does not run yet arrive
UNPORTED_SLICE = "the multi-GPU wideband and multi-host slice"

#: the -device argument of run(): one device, or for -mesh one device a shard
Devices = Union[DeviceLike, Sequence[DeviceLike]]


def _refuse_unported(fs: FlagSet) -> None:
    """Exit 1, naming the slice that brings it, for a mode this port does
    not run yet."""
    channels = fs.value("channels")
    if channels < 1:
        _log(f"invalid -channels value {channels} (want >= 1)")
        raise SystemExit(1)
    mesh = "-channels with -mesh (channel x time mesh)"
    if fs.value("checkpoint"):
        mesh += " and its -checkpoint"
    unported = [
        (fs.value("mesh") and channels > 1, mesh),
        (bool(fs.value("coordinator")), "-coordinator (multi-host decode)"),
    ]
    for active, what in unported:
        if active:
            _log(f"{what} is not ported to rtlamr_tpu_torch yet; "
                 f"it arrives with {UNPORTED_SLICE}")
            raise SystemExit(1)


class Receiver:
    """Receiver lifecycle (main.go:49-133) for live and offline sources."""

    def __init__(self, fs: FlagSet, device: Devices = None):
        self.fs = fs
        _refuse_unported(fs)
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
        self.wideband = fs.value("channels") > 1
        mesh = fs.value("mesh") and not self.wideband
        if isinstance(device, (list, tuple)) and not mesh:
            raise ValueError("a list of devices needs -mesh")
        if self.wideband:
            # One stream at channels*samplerate, channelized on the card
            # and decoded per channel (parallel/wideband.py).
            self.decoder = WidebandDecoder(
                self.parsers,
                n_channels=fs.value("channels"),
                window_blocks=fs.value("windowblocks"),
                max_hits=fs.value("maxhits"),
                filter_fn=self.fc.match,
                cross_channel_dedup=fs.value("crosschanneldedup"),
                device=device,
            )
        elif mesh:
            # Time-sharded over every local card (one shard each), or over
            # the caller's devices.
            if device is not None and not isinstance(device, (list, tuple)):
                device = [device]
            self.decoder = MeshDecoder(
                self.parsers,
                devices=device,
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


def run(fs: FlagSet, out=None, device: Devices = None) -> int:
    """Decode loop; messages go to ``out`` (``sys.stdout`` as it is at call
    time when None, so a caller's stdout redirection applies).

    With ``-checkpoint=PATH`` a run resumes from PATH's checkpoint when one
    is there, and a run that stops before the end of its stream (-single,
    -duration, SIGINT) saves one; a run to the end of its stream leaves
    none. SIGINT is then taken only between two feeds, so the saved
    position always matches the decoder's state."""
    from ..utils.observability import RateWatchdog, profile_trace

    out = sys.stdout if out is None else out
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
    sigint = []
    prev_handler, handler_set = None, False
    if ckpt_path and threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGINT, lambda *_: sigint.append(True))
        handler_set = True
    dropped_seen = 0
    stop = eof = False
    at_boundary = True  # no feed is under way
    try:
        try:
            with profile_trace(fs.value("profiledir") or None):
                while not stop:
                    if sigint:
                        _log("interrupted")
                        break
                    if deadline is not None and time.monotonic() >= deadline:
                        _log("time limit reached")
                        break
                    try:
                        chunk = source.read(chunk_bytes)
                    except (EOFError, OSError) as e:
                        # A stalled or closed stream cancels the receiver, like
                        # the reference's read-deadline path (main.go:168-181).
                        _log(f"source read: {e}")
                        chunk = np.zeros(0, np.uint8)
                    if watchdog is not None:
                        watchdog.add_bytes(chunk.size)
                        dropped = source.dropped_bytes()
                        if dropped > dropped_seen:
                            _log(
                                "ingest ring overflow: "
                                f"{dropped} bytes dropped so far"
                            )
                        dropped_seen = dropped
                        if not wideband:
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
        if handler_set:
            signal.signal(signal.SIGINT, prev_handler)
        if fs.value("metrics"):
            snap = dec.metrics_snapshot() if wideband else dec.metrics.snapshot()
            _log("metrics:", snap)
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
