"""Wideband multi-channel decode — the frequency-parallel receiver.

Port of the JAX package's ``parallel/wideband.py``. It takes ONE wideband
IQ stream covering many ERT hop slabs, channelizes it on the card
(``ops/channelizer_fused.py``: the CUDA kernel K2) and decodes every channel
with the same window program (the CUDA decode stencil K1 plus the search).

One super-step (:func:`_wideband_step`) consumes ``2 * N * W`` wideband
bytes:

  u16 view of the bytes -> card -> K2 (branches, DFT mix, requantize)
  written straight into an (N, staged_samples) staged batch behind each
  channel's carried halo -> N window programs -> one (N, P) packed result
  buffer, fetched with one pinned device-to-host copy.

Dispatch-ahead: a super-step completes (its buffer waited for and parsed)
at the first :meth:`WidebandDecoder.feed` that finds its copy has landed on
the host (:meth:`WidebandDecoder.poll`, which never waits), at the latest
when the next super-step is dispatched; :meth:`WidebandDecoder.flush`
completes the last. On the CPU the copy has always landed, so a super-step
completes at the next feed.

While the tracer is on (``utils/observability.py``) a super-step is a
window of the CLI loop: its root ``cli.window`` has the children
``wideband.stage``, ``wideband.step``, ``wideband.fetch_wait`` and
``wideband.parse``, and ``wideband.poll`` when a poll completed it;
:attr:`WidebandDecoder.metrics` counts the super-steps completed in
``windows_decoded``, those a poll completed in ``windows_polled``.

Each channel is an independent sample stream with the reference's exact
single-receiver semantics: its own overlap-save carry, first-window zero
history, block numbering and adjacent-block digest dedup (main.go:252-292),
held as per-channel :class:`~rtlamr_tpu_torch.decoder.WindowDecoder` parse
states over one shared FrontendSpec. Messages are returned as
``(channel, block, message)`` triples.

Adjacent-channel ghosts: a very strong OOK burst splatters sidelobe energy
into the neighbouring slab, where it can demodulate as the same packet.
``cross_channel_dedup=True`` collapses same-digest messages seen on
different channels in the same or adjacent block to the first
(lowest-channel) copy; off by default, to keep strict per-channel receiver
semantics.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decoder.byte_queue import ByteQueue
from ..decoder.checkpoint import (WidebandCheckpoint, check_window, geometry_mismatch,
                                  require_boundary, require_kind)
from ..decoder.pipeline import WindowDecoder, WindowMeta, enqueue_fetch, fetch, ready
from ..device import DeviceLike, resolve_device
from ..ops.channelizer import ChannelizerSpec, channel_offsets_hz
from ..ops.channelizer_fused import channelize_requantize_fused
from ..ops.frontend import decode_windows_scan
from ..ops.spec import FrontendSpec, staged_geometry
from ..protocols.base import Digest, Message, Parser, digest as mk_digest
from ..utils.observability import Metrics, span, stamp

Triple = Tuple[int, int, Message]


class CrossChannelDeduper:
    """Optional adjacent-channel ghost dedup (module docstring): drops a
    message whose digest another channel already emitted in the same or
    adjacent block; processed in (block, channel) order so the lowest
    channel wins. The one-block horizon matches the reference's dedup reach
    (main.go:252-292)."""

    def __init__(self):
        self.seen: dict = {}

    def filter(self, msgs, on_drop=None):
        out = []
        for c, b, m in sorted(msgs, key=lambda t: (t[1], t[0])):
            d = mk_digest(m)
            prev = self.seen.get(d)
            if prev is not None and prev[1] != c and b - prev[0] <= 1:
                if on_drop is not None:
                    on_drop(c)
                continue
            self.seen[d] = (b, c)
            out.append((c, b, m))
        if out:
            horizon = max(b for _, b, _ in out) - 1
            self.seen = {d: (b, c) for d, (b, c) in self.seen.items() if b >= horizon}
        return out


def _wideband_step(
    chspec: ChannelizerSpec,
    spec: FrontendSpec,
    wb_hist: torch.Tensor,
    wb_new: torch.Tensor,
    chan_tail: torch.Tensor,
    first: bool,
):
    """One super-step on the chunk's device: wideband u16 -> packed results.

    wb_hist: (P * N,) u16, the previous chunk's last P frames (frame-major;
      ignored at the stream head, where ``first`` makes it read as 0.0).
    wb_new: (N * W,) u16, the chunk's interleaved byte pairs.
    chan_tail: (N, halo_staged) u16 carried per-channel staged halos.

    Returns (packed (N, P) u8, new wb_hist, new chan_tail, staged (N, S)).
    The staged batch is fresh each step: the parse of this step may
    re-decode its rows (overflow escalation) after the next step began.
    """
    n = chspec.n_channels
    w = spec.window
    hs = spec.halo_staged
    staged = torch.empty(
        (n, staged_geometry(spec).staged_samples), dtype=torch.uint16, device=wb_new.device
    )
    staged[:, :hs] = chan_tail
    staged[:, hs + w :].view(torch.int16).zero_()
    channelize_requantize_fused(chspec, wb_hist, wb_new, first, out=staged[:, hs : hs + w])
    new_tail = staged[:, w : w + hs].clone()
    frame_tail = wb_new[(w - chspec.history_frames) * n :].clone()
    packed = decode_windows_scan(spec, staged, [first] * n)
    return packed, frame_tail, new_tail, staged


class WidebandDecoder:
    """Channelize-and-decode pipeline over one wideband stream.

    Args:
      parsers: registered protocol parsers (shared across channels).
      n_channels: filter-bank size N; the wideband input rate must be
        ``N * data_rate * chip_length`` (each channel lands at exactly the
        rate the decoder expects, protocol/decode.go:133).
      window_blocks/max_hits/filter_fn: per-channel decode program knobs
        (see :class:`~rtlamr_tpu_torch.decoder.WindowDecoder`).
      cross_channel_dedup: collapse adjacent-channel ghosts.

    The filter bank is :class:`ChannelizerSpec`'s default design (8 taps a
    branch, cutoff 1/(2N)).
      device: ``None`` (the card, ``cuda``) or ``"cpu"`` (plain PyTorch
        versions). Raises when the card is asked for and there is none.
    """

    def __init__(
        self,
        parsers: Sequence[Parser],
        n_channels: int,
        window_blocks: Optional[int] = 64,
        max_hits: int = 256,
        filter_fn=None,
        cross_channel_dedup: bool = False,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cross_channel_dedup = cross_channel_dedup
        self.chspec = ChannelizerSpec(n_channels=n_channels)
        self._chan = [
            WindowDecoder(
                parsers,
                window_blocks=window_blocks,
                max_hits=max_hits,
                filter_fn=filter_fn,
                device=self.device,
            )
            for _ in range(n_channels)
        ]
        self.spec = self._chan[0].spec
        self.cfg = self._chan[0].cfg
        #: the decoder's own counters: ``windows_decoded`` counts the
        #: super-steps completed (each channel's decoder counts its windows)
        self.metrics = Metrics()
        self.reset()

    def reset(self) -> None:
        n, p = self.chspec.n_channels, self.chspec.history_frames
        for c in self._chan:
            c.reset()
        self._wb_hist = torch.zeros(p * n, dtype=torch.uint16, device=self.device)
        self._chan_tail = torch.zeros(
            (n, self.spec.halo_staged), dtype=torch.uint16, device=self.device
        )
        self._first = True
        self._window_index = 0
        self._queue = ByteQueue()
        self._inflight = None
        self._xchan = CrossChannelDeduper()

    @property
    def n_channels(self) -> int:
        return self.chspec.n_channels

    @property
    def window_bytes(self) -> int:
        """Wideband bytes consumed per super-step."""
        return 2 * self.chspec.n_channels * self.spec.window

    def discard_pending(self) -> int:
        """Drop the wideband bytes fed since the last whole super-step;
        returns how many (see :meth:`WindowDecoder.discard_pending`)."""
        return self._queue.discard()

    @property
    def in_flight(self) -> bool:
        """Whether a dispatched super-step awaits completion."""
        return self._inflight is not None

    @property
    def wideband_sample_rate(self) -> int:
        return self.chspec.n_channels * self.cfg.sample_rate

    def channel_center_freqs(self, wide_center_hz: int) -> np.ndarray:
        """Absolute RF center frequency of each channel for a capture
        centered at ``wide_center_hz`` (misc/modes.go channel math)."""
        return wide_center_hz + channel_offsets_hz(self.chspec, self.cfg.sample_rate)

    def metrics_snapshot(self) -> dict:
        """The counters summed across channels, the decoder's own extras
        (the CLI's ``bytes_dropped``), and the time since the decoder was
        made (once: every channel's is the same)."""
        agg: dict = {"elapsed_s": round(self._chan[0].metrics.elapsed(), 3)}
        for c in self._chan:
            for k, v in c.metrics.counters().items():
                agg[k] = agg.get(k, 0) + v
        agg.update(self.metrics.extra)
        return agg

    # -- state ----------------------------------------------------------------

    def export_state(self) -> Dict[str, object]:
        """The stream state as plain numpy/Python values, in the JAX
        package's ``WidebandCheckpoint`` vocabulary: ``wb_hist`` as (2, N, P)
        f32 DC-removed frames (zeros at the stream head), ``chan_tail``,
        ``first``, ``window_index``, each channel's
        :meth:`WindowDecoder.export_state`, the cross-channel ``xchan_seen``
        rows and the unconsumed bytes. The in-flight super-step must be
        drained first."""
        if self._inflight is not None:
            raise RuntimeError("export_state: drain() the in-flight super-step first")
        n, p = self.chspec.n_channels, self.chspec.history_frames
        if self._first:
            hist = np.zeros((2, n, p), np.float32)
        else:
            v = self._wb_hist.cpu().numpy().reshape(p, n).T.astype(np.int32)
            hist = np.stack([(v & 255), (v >> 8)]).astype(np.float32) - np.float32(127.5)
        return {
            "wb_hist": hist,
            "chan_tail": self._tail_rows(),
            "first": bool(self._first),
            "window_index": int(self._window_index),
            "channels": [c.export_state() for c in self._chan],
            "xchan_seen": [(tuple(d), b, c) for d, (b, c) in self._xchan.seen.items()],
            "pending": self._queue.state(),
        }

    def load_state(self, state: Dict[str, object]) -> None:
        """Resume a stream from :meth:`export_state` values, or the same
        values read from the JAX package's ``WidebandDecoder`` (its
        ``_wb_hist``, ``_chan_tail``, ``_first``, ``_window_index``, per
        channel decoder and ``_xchan.seen``)."""
        self.reset()
        n, p = self.chspec.n_channels, self.chspec.history_frames
        hs = self.spec.halo_staged
        hist = np.asarray(state["wb_hist"], np.float32)
        tail = np.asarray(state["chan_tail"], np.uint16)
        channels = list(state["channels"])
        if hist.shape != (2, n, p) or tail.shape != (n, hs) or len(channels) != n:
            raise ValueError(
                f"load_state: history {hist.shape}, tails {tail.shape}, "
                f"{len(channels)} channels; want (2, {n}, {p}), ({n}, {hs}), {n}"
            )
        first = bool(state["first"])
        packed = None
        if not first:
            # The history holds u8-derived samples minus 127.5: exact in f32.
            u = hist.astype(np.float64) + 127.5
            iu = np.round(u).astype(np.int64)
            if not (np.array_equal(iu, u) and iu.min() >= 0 and iu.max() <= 255):
                raise ValueError("load_state: wb_hist is not a u8-derived frame tail")
            packed = (iu[0] | (iu[1] << 8)).T.reshape(-1).astype(np.uint16)
        self._load_carries(packed, tail.copy())
        self._first = first
        self._window_index = int(state["window_index"])
        for c, st in zip(self._chan, channels):
            c.load_state(st)
        self._xchan.seen = {Digest(*d): (b, c) for d, b, c in state.get("xchan_seen", ())}
        self._queue = ByteQueue(state.get("pending", ()))

    def _tail_rows(self) -> np.ndarray:
        """The carried (N, halo_staged) channel tails, on the host."""
        return self._chan_tail.cpu().numpy().copy()

    def _load_carries(self, hist: Optional[np.ndarray], tail: np.ndarray) -> None:
        """Put the carried (P * N,) u16 frame tail (None: the stream head's,
        left as it is) and the (N, halo_staged) channel tails where the next
        super-step reads them."""
        if hist is not None:
            self._wb_hist = torch.from_numpy(hist).to(self.device)
        self._chan_tail = torch.from_numpy(tail).to(self.device)

    # -- checkpoints (decoder/checkpoint.py) ----------------------------------

    def checkpoint(self, byte_offset: int) -> WidebandCheckpoint:
        """The stream's resume point; only at a super-step boundary (no
        pending bytes, nothing in flight). ``byte_offset`` is the wideband
        bytes consumed."""
        require_boundary(self._queue.size, self.in_flight)
        state = self.export_state()
        chans = state["channels"]
        return WidebandCheckpoint(
            byte_offset=byte_offset,
            window_index=state["window_index"],
            first=state["first"],
            wb_hist=state["wb_hist"],
            chan_tail=np.ascontiguousarray(self._saved_tail(state["chan_tail"])),
            chan_last_block=[c["last_block"] for c in chans],
            chan_prev_digests=[[tuple(d) for d in c["dedup_prev"]] for c in chans],
            xchan_seen=state["xchan_seen"],
            window=self.spec.window,
        )

    def restore(self, ckpt) -> None:
        """Resume the stream at a :class:`WidebandCheckpoint`; decode
        continues bit-identically. Refuses a checkpoint of another kind or
        geometry."""
        require_kind(ckpt, WidebandCheckpoint, self)
        check_window(ckpt.window, self.spec.window)
        n, p = self.n_channels, self.chspec.history_frames
        tail = self._loaded_tail(np.asarray(ckpt.chan_tail))
        if len(ckpt.chan_last_block) != n or len(ckpt.chan_prev_digests) != n:
            raise ValueError(f"checkpoint geometry mismatch: {len(ckpt.chan_last_block)} "
                             f"channel states, decoder has {n} channels")
        hist = np.asarray(ckpt.wb_hist)
        if hist.shape != (2, n, p):
            raise geometry_mismatch("channelizer history", hist.shape, (2, n, p),
                                    "different taps_per_branch?")
        self.load_state({
            "wb_hist": hist,
            "chan_tail": tail,
            "first": ckpt.first,
            "window_index": ckpt.window_index,
            # A channel decoder's own carry is unused here (the tails live
            # in chan_tail); next is rebuilt at every block start.
            "channels": [
                {"carry": np.zeros(self.spec.halo_staged, np.uint16), "first": ckpt.first,
                 "window_index": ckpt.window_index, "last_block": last,
                 "dedup_prev": prev, "dedup_next": ()}
                for last, prev in zip(ckpt.chan_last_block, ckpt.chan_prev_digests)
            ],
            "xchan_seen": ckpt.xchan_seen,
        })

    def _saved_tail(self, rows: np.ndarray) -> np.ndarray:
        """A checkpoint's channel tails, from :meth:`export_state`'s rows."""
        return rows

    def _loaded_tail(self, tail: np.ndarray) -> np.ndarray:
        """A checkpoint's channel tails as :meth:`load_state` takes them;
        refuses another decoder's."""
        n, hs, halo = self.n_channels, self.spec.halo_staged, self.spec.halo
        if tail.shape != (n, hs):
            hint = ("a wideband-mesh decoder's tail: resume it with -channels and -mesh"
                    if tail.shape == (n, halo) else "different -channels or message types?")
            raise geometry_mismatch("chan_tail", tail.shape, (n, hs), hint)
        return tail

    # -- streaming ------------------------------------------------------------

    def feed(self, wb_bytes: np.ndarray) -> List[Triple]:
        """Feed wideband IQ bytes; returns (channel, block, message).

        A super-step in flight whose results have landed completes first
        (:meth:`poll`), its messages ahead of those of the super-steps
        the chunk completes. The chunk is copied, so the caller may reuse
        its buffer at once."""
        out = self.poll()
        self._queue.push(wb_bytes)
        self._stage_since = stamp()
        for chunk in self._queue.take(self.window_bytes):
            out.extend(self._process_chunk(chunk))
        self._stage_since = 0
        return out

    def poll(self) -> List[Triple]:
        """Complete the super-step in flight if its results are on the host;
        else nothing. Never waits for the card."""
        if self._inflight is None:
            return []
        since = stamp()
        handle, (_, _, _, window_index) = self._inflight
        if not ready(handle):
            return []
        with span("wideband.poll", window_index, since):
            self.metrics.windows_polled += 1
        return self.drain()

    def flush(self) -> List[Triple]:
        """Zero-pad and decode remaining full per-channel blocks; drain."""
        padded, blocks = self._queue.take_blocks(
            2 * self.chspec.n_channels * self.cfg.block_size, self.window_bytes)
        out = self._process_chunk(padded, valid_blocks=blocks) if blocks else []
        out.extend(self.drain())
        return out

    def drain(self) -> List[Triple]:
        if self._inflight is None:
            return []
        inflight, self._inflight = self._inflight, None
        return self._complete(inflight)

    def decode_capture(self, wb_bytes: np.ndarray) -> List[Triple]:
        self.reset()
        out = self.feed(np.asarray(wb_bytes, np.uint8))
        out.extend(self.flush())
        return out

    # -- internals ------------------------------------------------------------

    #: when :meth:`feed` began taking the super-steps it hands to
    #: :meth:`_process_chunk` (a :func:`stamp`; 0: not timed)
    _stage_since: int = 0

    def _process_chunk(
        self, chunk: np.ndarray, valid_blocks: Optional[int] = None
    ) -> List[Triple]:
        """Dispatch one super-step, then complete the one before it if no
        :meth:`poll` has (flush() drains the last)."""
        index = self._window_index
        since, self._stage_since = self._stage_since, 0
        with span("wideband.stage", index, since):
            u16 = torch.from_numpy(np.ascontiguousarray(chunk).view(np.uint16))
            if self.device.type == "cuda":
                # From pageable memory the copy has left ``chunk`` on return.
                u16 = u16.to(self.device, non_blocking=True)
        with span("wideband.step", index):
            packed, self._wb_hist, self._chan_tail, staged = _wideband_step(
                self.chspec, self.spec, self._wb_hist, u16, self._chan_tail, self._first
            )
        meta = (staged, self._first, valid_blocks, index)
        self._first = False
        self._window_index += 1
        out = self.drain()
        self._inflight = (enqueue_fetch(packed), meta)
        return out

    def _complete(self, inflight) -> List[Triple]:
        handle, (staged, first, valid_blocks, window_index) = inflight
        with span("wideband.fetch_wait", window_index):
            host = fetch(handle)  # ONE fetch for all channels
        out: List[Triple] = []
        with span("wideband.parse", window_index):
            for c, chan in enumerate(self._chan):
                msgs = chan.complete(host[c], WindowMeta(staged[c], first, valid_blocks,
                                                         window_index))
                out.extend((c, b, m) for b, m in msgs)
            if self.cross_channel_dedup:
                out = self._xchan.filter(out, on_drop=self._count_ghost)
        self.metrics.windows_decoded += 1
        return out

    def _count_ghost(self, c: int) -> None:
        self._chan[c].metrics.messages_dropped_dup += 1
