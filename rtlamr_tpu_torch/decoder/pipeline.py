"""Single-card streaming window pipeline.

Port of the JAX package's ``decoder/pipeline.py``: accumulate IQ into a
large window -> one window program on the card
(ops/frontend.decode_window_staged_packed: the CUDA decode stencil K1
launched, then the search in PyTorch ops replayed from a CUDA graph
captured once for the spec, device and stream; the first window of each
runs it eagerly) -> host-side parsing of the compacted candidates with the
reference's per-block ordering, digest dedup and filter semantics. The
window is a whole number of reference block sizes so the block-granular
dedup behavior (main.go:252-292) is preserved exactly.

Between windows only the last ``halo = PacketLength + SymbolLength`` samples
carry over (overlap-save).

Dispatch-ahead: a window's program is enqueued on the current CUDA stream,
followed by a non-blocking copy of its packed result buffer into pinned
host memory and an event; the window is completed (event waited on, buffer
parsed) only when the next window has been enqueued, so the card computes
window i+1 while the host parses window i. On the CPU the same code runs
synchronously.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.frontend import (
    decode_window_staged_packed,
    decode_windows_scan,
    unpack_lookahead,
    unpack_results,
)
from ..ops.spec import (
    FrontendSpec,
    lookahead_geometry,
    lookahead_spec,
    make_frontend_spec,
    resolved_blocks,
    staged_geometry,
)
from ..protocols.base import (
    DecoderConfig,
    Digest,
    Message,
    Parser,
    build_decoder_config,
    digest as mk_digest,
)
from ..protocols.r900 import PAYLOAD_SYMBOLS
from ..utils.observability import Metrics, span, stamp
from .byte_queue import ByteQueue
from .checkpoint import Checkpoint, check_window, geometry_mismatch, require_boundary, require_kind
from .dedup import BlockDeduper

FilterFn = Callable[[Message], bool]


class WindowMeta(NamedTuple):
    """A dispatched window, as :meth:`WindowDecoder.complete` needs it."""

    #: the (staged_samples,) u16 buffer on the device, re-decoded when the
    #: window's hits overflow the result buffer
    staged: torch.Tensor
    #: the stream-head flag the window program ran with
    first: bool
    #: blocks of the window that hold capture (None: all of them)
    valid_blocks: Optional[int]
    window_index: int
    #: the :func:`enqueue_fetch` handle of the window's look-ahead buffer
    #: (ops/frontend.decode_window_staged_packed), None: none
    ahead: Optional[tuple] = None


def enqueue_fetch(buf: torch.Tensor):
    """Start the device-to-host copy of a packed result buffer: into pinned
    memory, non-blocking, with an event to wait on. Returns the handle that
    :func:`fetch` takes."""
    if buf.device.type != "cuda":
        return buf, None
    host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(buf, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def fetch(handle) -> np.ndarray:
    """Wait for an :func:`enqueue_fetch` copy; the buffer as numpy."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()


def ready(handle) -> bool:
    """Whether an :func:`enqueue_fetch` copy has landed, so :func:`fetch`
    would not wait; never waits itself (always True on the CPU)."""
    event = handle[1]
    return event is None or event.query()


class StagingRing:
    """``depth`` host buffers of one staged window, filled in place by a
    reader (the native transport's ``read_staged``) and dispatched by
    :meth:`WindowDecoder.process_host_staged`.

    On the card the buffers are pinned, so a window's copy to the card is
    asynchronous and overlaps the next read; :meth:`acquire` hands a buffer
    out again only once the copy that last read it has completed (its
    :attr:`WindowDecoder.h2d_event`). Use::

        buf = ring.acquire()
        got = source.read_staged(buf, carry, spec.window)
        msgs = ring.submit(got)
    """

    def __init__(self, dec: "WindowDecoder", depth: int = 3):
        n = staged_geometry(dec.spec).staged_samples
        pin = dec.device.type == "cuda"
        self.dec = dec
        self.buffers = [torch.zeros(n, dtype=torch.uint16, pin_memory=pin) for _ in range(depth)]
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._i = 0

    def acquire(self) -> torch.Tensor:
        """The next buffer, once the copy to the card that last read it has
        completed."""
        event = self._events[self._i]
        if event is not None:
            event.synchronize()
        return self.buffers[self._i]

    def submit(self, samples: int) -> List[Tuple[int, Message]]:
        """Dispatch the buffer :meth:`acquire` handed out, which holds
        ``samples`` fresh samples; the previous window's messages. A short
        read is decoded as :meth:`WindowDecoder.flush` decodes the stream's
        tail: its whole blocks, with the rest of the window zeroed, and
        nothing when it holds no whole block."""
        spec, dec = self.dec.spec, self.dec
        i = self._i
        valid_blocks = None
        if samples < spec.window:
            valid_blocks = samples // spec.block_size
            if valid_blocks == 0:
                return []
            hs = spec.halo_staged
            self.buffers[i][hs + valid_blocks * spec.block_size : hs + spec.window] = 0
        msgs = dec.process_host_staged(self.buffers[i], valid_blocks)
        self._events[i] = dec.h2d_event
        self._i = (i + 1) % len(self.buffers)
        return msgs


class WindowDecoder:
    """Streaming decoder over fixed-size sample windows.

    A streamed window (:meth:`feed`, :meth:`process_host_staged`) but a
    stream's first and a short one also searches the next window's first
    blocks, whose bits it already holds (ops/spec.lookahead_geometry; none
    where PacketLength is every group's own), once the window's own buffer
    has left for the host. The blocks of that look-ahead in which every
    group's packets fit, or the group has no raw preamble hit, are
    resolved: each is parsed (in block order, through the same filter and
    dedup) by the feed that brings its bytes, or when a later window is
    dispatched, and later windows skip it. The stream is the same message
    for message wherever it ends; a short packet found in those blocks
    comes out a window sooner.

    Args:
      parsers: registered protocol parsers (registration order is the
        deterministic message order within a block).
      window_blocks: reference blocks per device window. Larger windows
        amortize launch/transfer overhead; dedup semantics are
        window-size-invariant.
      max_hits: device-side hit compaction capacity per preamble group per
        window; overflow escalates to a high-capacity variant, then to an
        exact NumPy path for that window.
      filter_fn: optional message filter applied before dedup, matching the
        reference's FilterChain position (main.go:237).
      device: ``None`` (the card, ``cuda``) or ``"cpu"`` (plain PyTorch
        versions). Raises when the card is asked for and there is none.
    """

    def __init__(
        self,
        parsers: Sequence[Parser],
        window_blocks: Optional[int] = 64,
        max_hits: int = 256,
        filter_fn: Optional[FilterFn] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.parsers = list(parsers)
        self.cfg: DecoderConfig = build_decoder_config(self.parsers)
        if window_blocks is None:
            # Minimum window that covers the halo.
            halo = self.cfg.packet_length + self.cfg.symbol_length
            window_blocks = -(-halo // self.cfg.block_size)
        self.spec: FrontendSpec = make_frontend_spec(self.cfg, window_blocks, max_hits)
        self.filter_fn = filter_fn
        self.metrics = Metrics()
        # Group index -> parsers, aligned with spec.groups order.
        self._group_parsers = [
            self.cfg.preamble_groups[g.preamble] for g in self.spec.groups
        ]
        #: the spec has a look-ahead (ops/spec.lookahead_geometry)
        self.lookahead = lookahead_geometry(self.spec).extent > 0
        self.reset()

    # -- streaming state ----------------------------------------------------

    def reset(self) -> None:
        # Carry between windows: the last halo_staged SAMPLES (u16 = one
        # interleaved IQ byte pair each) of the previous window's stream.
        self._carry = np.zeros(self.spec.halo_staged, np.uint16)
        self._first = True
        self._window_index = 0
        self._deduper = BlockDeduper()
        self._last_block = -1
        #: the last block the look-ahead emitted (-1: none); later windows
        #: skip every block up to it
        self._lookahead_mark = -1
        #: the last completed window's look-ahead, not fetched yet: (its
        #: enqueue_fetch handle, its window)
        self._ahead_fetch = None
        #: the resolved look-ahead not emitted yet: (its unpacked result,
        #: its window, its last resolved block, the blocks of its
        #: candidates)
        self._ahead = None
        #: blocks of the windows dispatched (a short window's valid ones)
        self._blocks_dispatched = 0
        self._queue = ByteQueue()
        #: one-deep dispatch-ahead pipeline: (result handle, meta) of the
        #: window whose results have not been parsed yet.
        self._inflight = None

    def export_state(self) -> Dict[str, object]:
        """The stream state as plain numpy/Python values: the staged halo
        carry, the first-window flag, the window and block counters, the
        digest sets of the cross-block dedup, the unconsumed bytes and the
        last block the look-ahead emitted (None: none). The dispatch-ahead
        pipeline must be drained first."""
        if self._inflight is not None:
            raise RuntimeError("export_state: drain() the in-flight window first")
        return {
            "carry": self._host_carry(),
            "first": bool(self._first),
            "window_index": int(self._window_index),
            "last_block": int(self._last_block),
            "dedup_prev": set(self._deduper.prev),
            "dedup_next": set(self._deduper.next),
            "pending": self._queue.state(),
            "lookahead_mark": None if self._lookahead_mark < 0 else int(self._lookahead_mark),
        }

    def load_state(self, state: Dict[str, object]) -> None:
        """Resume a stream from :meth:`export_state` values (or the same
        values read from the JAX package's decoder, which has no
        ``lookahead_mark``: none)."""
        self.reset()
        self._load_carry(np.asarray(state["carry"], np.uint16))
        self._first = bool(state["first"])
        self._window_index = int(state["window_index"])
        self._last_block = int(state["last_block"])
        self._deduper.prev = {Digest(*d) for d in state["dedup_prev"]}
        self._deduper.next = {Digest(*d) for d in state["dedup_next"]}
        self._queue = ByteQueue(state.get("pending", ()))
        mark = state.get("lookahead_mark")
        self._lookahead_mark = -1 if mark is None else int(mark)
        self._blocks_dispatched = self._window_index * self._window_blocks

    def _host_carry(self) -> np.ndarray:
        """The carry as :meth:`export_state` gives it."""
        return self._carry.copy()

    def _load_carry(self, carry: np.ndarray) -> None:
        """Take a carry from :meth:`load_state`."""
        if carry.shape != (self.spec.halo_staged,):
            raise ValueError(
                f"load_state: carry of {carry.shape}, want ({self.spec.halo_staged},)"
            )
        self._carry = carry.copy()

    @property
    def window_bytes(self) -> int:
        return 2 * self.spec.window

    @property
    def _window_blocks(self) -> int:
        return self.spec.window // self.spec.block_size

    def discard_pending(self) -> int:
        """Drop the bytes fed since the last whole window; returns how many.
        The stream then stands at a window boundary, where a checkpoint can
        be taken; the caller feeds the dropped bytes again on resume."""
        return self._queue.discard()

    @property
    def in_flight(self) -> bool:
        """Whether a dispatched window awaits completion."""
        return self._inflight is not None

    # -- checkpoints (decoder/checkpoint.py) ----------------------------------

    def checkpoint(self, byte_offset: int) -> Checkpoint:
        """The stream's resume point; only at a window boundary (no pending
        bytes, nothing in flight). ``byte_offset`` is the capture bytes
        consumed."""
        require_boundary(self._queue.size, self.in_flight)
        state = self.export_state()
        return Checkpoint(
            byte_offset=byte_offset,
            window_index=state["window_index"],
            last_block=state["last_block"],
            first=state["first"],
            carry=state["carry"],
            prev_digests=[tuple(d) for d in state["dedup_prev"]],
            window=self.spec.window,
            lookahead_mark=state["lookahead_mark"],
        )

    def restore(self, ckpt) -> None:
        """Resume the stream at a :class:`Checkpoint`; decode continues
        bit-identically. Refuses a checkpoint of another kind or geometry."""
        require_kind(ckpt, Checkpoint, self)
        check_window(ckpt.window, self.spec.window)
        carry = np.asarray(ckpt.carry, np.uint16)
        want, other, hint = self._carry_geometry()
        if carry.shape != want:
            raise geometry_mismatch("carry", carry.shape, want,
                                    hint if carry.shape == other else "different message types?")
        self.load_state({
            "carry": carry,
            "first": ckpt.first,
            "window_index": ckpt.window_index,
            "last_block": ckpt.last_block,
            "dedup_prev": ckpt.prev_digests,
            # next is rebuilt at every block start (decoder/dedup.py)
            "dedup_next": (),
            "lookahead_mark": ckpt.lookahead_mark,
        })

    def _carry_geometry(self) -> Tuple[Tuple[int], Tuple[int], str]:
        """The carry shape of this decoder's checkpoints, and the other
        decoder's (the mesh decoder's) with the hint of its refusal."""
        return ((self.spec.halo_staged,), (self.spec.halo,),
                "a mesh decoder's tail: resume it with -mesh, the multi-GPU "
                "time-sharded decoder")

    # -- capture / streaming APIs ------------------------------------------

    def feed(self, iq_bytes: np.ndarray) -> List[Tuple[int, Message]]:
        """Feed arbitrary-length IQ bytes; decode any completed windows.

        The chunk is copied, so the caller may reuse its buffer at once."""
        self._queue.push(iq_bytes)
        out = self._release_fed()
        windows = self._queue.take(self.window_bytes)
        if windows:
            for window in windows:
                out.extend(self._process_window(window))
            out.extend(self._release_fed())
        return out

    def _release_fed(self) -> List[Tuple[int, Message]]:
        """The look-ahead's messages of every block fed so far."""
        if self._ahead is None and self._ahead_fetch is None:
            return []
        return self._release(self._blocks_dispatched
                             + self._queue.size // (2 * self.cfg.block_size))

    def flush(self) -> List[Tuple[int, Message]]:
        """Decode remaining full blocks (zero-padding the final window) and
        drain the dispatch-ahead pipeline."""
        padded, blocks = self._queue.take_blocks(2 * self.cfg.block_size, self.window_bytes)
        out = self._process_window(padded, valid_blocks=blocks) if blocks else []
        out.extend(self.drain())
        return out

    def drain(self) -> List[Tuple[int, Message]]:
        if self._inflight is None:
            return []
        inflight, self._inflight = self._inflight, None
        return self._complete_inflight(inflight)

    def _complete_inflight(self, inflight) -> List[Tuple[int, Message]]:
        handle, meta = inflight
        with span("pipeline.fetch_wait", -1 if isinstance(meta, list) else meta.window_index):
            host = fetch(handle)
        if isinstance(meta, list):  # batched (decode_staged_batch)
            out: List[Tuple[int, Message]] = []
            for row, m in zip(host, meta):
                out.extend(self.complete(row, m))
            return out
        return self.complete(host, meta)

    def _dispatch(self, inflight) -> List[Tuple[int, Message]]:
        """Make ``inflight`` the pending window; complete the previous one."""
        msgs = self.drain()
        self._inflight = inflight
        return msgs

    def decode_staged(
        self, staged: Sequence[torch.Tensor], drain: bool = True
    ) -> List[Tuple[int, Message]]:
        """Decode windows already staged in device memory.

        ``staged[i]`` is a (staged_samples,) uint16 tensor on the decoder's
        device in the StagedGeometry layout (e.g. a slice of a
        device-resident staged capture). Skips per-window host->device
        transfers entirely.
        """
        out: List[Tuple[int, Message]] = []
        for iq_full in staged:
            buf = decode_window_staged_packed(self.spec, iq_full, self._first)
            meta = WindowMeta(iq_full, self._first, None, self._window_index)
            self._first = False
            self._window_index += 1
            self._blocks_dispatched += self._window_blocks
            out.extend(self._dispatch((enqueue_fetch(buf), meta)))
        if drain:
            out.extend(self.drain())
        return out

    def decode_staged_batch(
        self, staged_batch: torch.Tensor, drain: bool = True
    ) -> List[Tuple[int, Message]]:
        """Decode a (K, staged_samples) u16 device batch into one (K, P)
        result buffer, fetched once. Keeps the one-deep dispatch-ahead
        pipeline across batches."""
        k = int(staged_batch.shape[0])
        firsts_host = [self._first] + [False] * (k - 1)
        packed = decode_windows_scan(self.spec, staged_batch, firsts_host)
        metas = [
            WindowMeta(staged_batch[i], firsts_host[i], None, self._window_index + i)
            for i in range(k)
        ]
        self._first = False
        self._window_index += k
        self._blocks_dispatched += k * self._window_blocks
        out = self._dispatch((enqueue_fetch(packed), metas))
        if drain:
            out.extend(self.drain())
        return out

    def decode_capture(self, iq_bytes: np.ndarray) -> List[Tuple[int, Message]]:
        """Decode a whole capture; returns (block_index, message) pairs."""
        self.reset()
        out = self.feed(np.asarray(iq_bytes, np.uint8))
        out.extend(self.flush())
        return out

    # -- internals ----------------------------------------------------------

    def _process_window(
        self, window_bytes: np.ndarray, valid_blocks: Optional[int] = None
    ) -> List[Tuple[int, Message]]:
        """Stage one window of IQ bytes behind the carried halo; dispatch it
        and complete the previous one (results arrive one window late;
        flush() drains the tail)."""
        self._stage_since = stamp()
        spec = self.spec
        geo = staged_geometry(spec)
        hs, w = spec.halo_staged, spec.window
        staged = np.zeros(geo.staged_samples, np.uint16)
        staged[:hs] = self._carry
        staged[hs : hs + w] = np.ascontiguousarray(window_bytes).view(np.uint16)
        return self.process_host_staged(staged, valid_blocks)

    #: the event recorded after the last :meth:`process_host_staged` copy to
    #: the card (None on the CPU)
    h2d_event: Optional[torch.cuda.Event] = None
    #: when :meth:`_process_window` began staging the window it hands to
    #: :meth:`process_host_staged` (a :func:`stamp`; 0: not timed)
    _stage_since: int = 0

    def process_host_staged(
        self, staged: Union[np.ndarray, torch.Tensor], valid_blocks: Optional[int] = None
    ) -> List[Tuple[int, Message]]:
        """Dispatch one externally staged u16 window buffer.

        ``staged`` is a (staged_samples,) uint16 buffer in the
        StagedGeometry layout with the carry already in place: a numpy
        array, or a contiguous CPU ``torch.uint16`` tensor such as the
        native transport's ``read_staged`` fills (``native/``). From a
        pinned tensor the copy to the card is asynchronous: the buffer may
        be refilled only once :attr:`h2d_event`, recorded after the copy,
        has completed (:class:`StagingRing` waits for it). From any other
        buffer the copy has left it when this returns. self._carry is
        refreshed from the buffer.
        """
        spec = self.spec
        hs, w = spec.halo_staged, spec.window
        index = self._window_index
        since, self._stage_since = self._stage_since, 0
        with span("pipeline.stage", index, since):
            if isinstance(staged, torch.Tensor):
                if (staged.device.type != "cpu" or staged.dtype != torch.uint16
                        or staged.dim() != 1 or not staged.is_contiguous()):
                    raise ValueError(
                        "process_host_staged: want a contiguous 1-D CPU torch.uint16 "
                        f"tensor, got {staged.dtype} {tuple(staged.shape)} on {staged.device}")
                host = staged
            else:
                host = torch.from_numpy(np.ascontiguousarray(staged, np.uint16))
            if self.device.type == "cuda":
                staged_t = host.to(self.device, non_blocking=True)
                self.h2d_event = torch.cuda.Event()
                self.h2d_event.record(torch.cuda.current_stream(self.device))
            else:
                staged_t = host.clone()
                self.h2d_event = None
            # The device copy serves an escalation; the carry comes from the
            # host.
            self._carry = host[w : w + hs].numpy().copy()
        # A first window's look-ahead is not read (its stencil zeroes the
        # stream's history, the next window's does not), nor a short one's
        # (it lies past the capture).
        looks = self.lookahead and not self._first and valid_blocks is None
        with span("frontend.enqueue", index):
            if looks:
                buf, ahead = decode_window_staged_packed(spec, staged_t, self._first,
                                                         lookahead=True)
            else:
                buf, ahead = decode_window_staged_packed(spec, staged_t, self._first), None
        handle = enqueue_fetch(buf)
        # The look-ahead's search queues behind the window's copy to the
        # host, so the window's messages do not wait for it.
        meta = WindowMeta(staged_t, self._first, valid_blocks, index,
                          None if ahead is None else enqueue_fetch(ahead()))
        self._first = False
        self._window_index += 1
        self._blocks_dispatched += self._window_blocks if valid_blocks is None else valid_blocks
        return self._dispatch((handle, meta))

    def complete(self, host_row: np.ndarray, meta: WindowMeta) -> List[Tuple[int, Message]]:
        """Parse one dispatched window's packed result buffer into its
        messages: unpack, escalate an overflowed window (the high-capacity
        program, then the exact host path), then the reference's per-block
        order, filter and digest dedup against this decoder's block state.

        ``host_row`` is the window's (P,) u8 packed buffer on the host;
        windows must be completed in stream order. The streaming calls run
        it one window late; the wideband decoder runs it for each channel of
        a super-step. The look-ahead's blocks of windows dispatched come
        first; the window's own look-ahead (``meta.ahead``) is left for the
        feeds that bring its blocks."""
        staged, first, valid_blocks, window_index = meta[:4]
        with span("pipeline.parse", window_index):
            spec = self.spec
            # (a window dispatched by process_host_staged alone has had no
            # feed to release the look-ahead's blocks in it)
            msgs = self._release(self._blocks_dispatched)
            res = unpack_results(spec, host_row)
            if self._overflowed(res, spec):
                # Escalate: re-decode this window with a high-capacity
                # variant; the exact host path last.
                self.metrics.hit_overflows += 1
                big = self._big_spec()
                big_buf = decode_window_staged_packed(big, staged, first)
                res = unpack_results(big, big_buf.cpu().numpy())
                if self._overflowed(res, big):
                    res = self._window_results_numpy(staged.cpu().numpy(), first)
            msgs.extend(self._parse_window(res, valid_blocks, window_index))
            if meta.ahead is not None:
                self._ahead_fetch = (meta.ahead, window_index)
                msgs.extend(self._release(self._blocks_dispatched))
            self.metrics.windows_decoded += 1
            self.metrics.samples_in += spec.window
        return msgs

    def _keep_lookahead(self, handle, window_index: int) -> None:
        """Fetch a window's look-ahead (its :func:`enqueue_fetch` handle)
        and keep it for the feeds that bring its resolved blocks, when it
        resolves blocks past the kept one's. One whose search overflowed a
        capacity resolves none: those blocks wait for their own window.
        The span ``pipeline.lookahead`` (in no window: the window's own
        has closed) covers the fetch, unpack and resolution of a
        look-ahead that resolves blocks."""
        since = stamp()
        spec = self.spec
        ahead, guards = unpack_lookahead(spec, fetch(handle))
        n = 0 if self._overflowed(ahead, lookahead_spec(spec)) else resolved_blocks(spec, guards)
        wb = self._window_blocks
        last = (window_index + 1) * wb + n - 1
        if n == 0 or last <= max(self._lookahead_mark, self._ahead[2] if self._ahead else -1):
            return
        with span("pipeline.lookahead", -1, since):
            rows = np.concatenate([np.asarray(i, np.int64) for i in ahead["idx"]])
            blocks = (window_index + 1) * wb + rows // spec.block_size
            self._ahead = (ahead, window_index, last, blocks)

    def _release(self, fed_blocks: int) -> List[Tuple[int, Message]]:
        """The messages of the kept look-ahead's resolved blocks below
        ``fed_blocks`` not emitted yet, parsed as their window would parse
        them; moves the mark to the last of them. A look-ahead not fetched
        yet is fetched once one of its blocks is fed."""
        wb = self._window_blocks
        if self._ahead_fetch is not None and fed_blocks > (self._ahead_fetch[1] + 1) * wb:
            (handle, window_index), self._ahead_fetch = self._ahead_fetch, None
            self._keep_lookahead(handle, window_index)
        if self._ahead is None:
            return []
        ahead, window_index, last, blocks = self._ahead
        upto = min(last, fed_blocks - 1)
        if upto <= self._lookahead_mark or upto < (window_index + 1) * wb:
            return []
        msgs = []
        if ((blocks > self._lookahead_mark) & (blocks <= upto)).any():
            # The look-ahead's positions are the next window's.
            msgs = self._parse_window(ahead, upto - (window_index + 1) * wb + 1,
                                      window_index + 1)
        self._lookahead_mark = upto
        if upto == last:
            self._ahead = None
        return msgs

    def _overflowed(self, res: Dict[str, object], spec=None) -> bool:
        """True when device compaction capacity was exceeded: raw hits past
        the gather capacity, or distinct candidates past the output slots."""
        spec = spec or self.spec
        counts = np.asarray(res["counts"])
        return bool(
            (counts[:, 0] > spec.gather_hits).any()
            or (counts[:, 1] > spec.max_hits).any()
        )

    def _big_spec(self) -> FrontendSpec:
        """High-capacity program variant for hit-dense windows."""
        if not hasattr(self, "_big_spec_cache"):
            w = self.spec.window
            gather = min(1 << 16, w)
            self._big_spec_cache = dataclasses.replace(
                self.spec,
                max_hits=min(4096, w),
                gather_hits=gather,
                # Slice capacity == gather capacity: the pre-slice plateau
                # collapse can't overflow in the escalation variant.
                slice_hits=gather,
                # Row capacity == gather capacity: a row overflow here
                # implies >gather raw hits, so the same overflow check
                # falls through to the exact host path.
                gather_rows=min(gather, w // 128),
            )
        return self._big_spec_cache

    def _parse_window(
        self,
        res: Dict[str, object],
        valid_blocks: Optional[int],
        window_index: int,
    ) -> List[Tuple[int, Message]]:
        """Two-phase host parse.

        Phase A (vectorized, whole window): per preamble group — batched
        checksum pre-filter, per-block exact-duplicate collapse, then each
        parser's :meth:`~rtlamr_tpu_torch.protocols.base.Parser.parse_batch` over
        the surviving candidate MATRIX (batched CRC/RS + batched bitfield
        extraction; dataclasses built only for emitted rows).

        Phase B (ordered, per block): the reference's emission semantics —
        blocks ascending, parsers in registration order within a group,
        candidates ascending within a parser; FilterChain then digest dedup
        per block (main.go:235-292).

        Duplicate collapse note: preamble hits form plateaus of adjacent
        positions slicing identical packets; the reference processes each
        and dedups via its per-parser seen map (scm/scm.go:62-74) —
        collapsing exact duplicates per block first is equivalent (first
        occurrence kept, ascending order preserved). The dedup key is the
        4-ary symbols for R900 groups (r900/r900.go:209), the packed
        packet bytes otherwise.
        """
        spec = self.spec
        bs = spec.block_size
        wb = spec.window // bs
        if valid_blocks is None:
            valid_blocks = wb
        window_block0 = window_index * wb

        # Phase A.
        group_parsed = {}  # g -> (b_arr, [per-parser {row: Message}])
        for g, gspec in enumerate(spec.groups):
            count = int(np.asarray(res["counts"])[g][1])
            full = np.asarray(res["idx"][g])
            cap = min(count, full.shape[0])
            idx = full[:cap]
            if idx.size == 0:
                continue
            data = np.asarray(res["bytes"][g])[:cap]
            syms = (
                np.asarray(res["symbols"][g])[:cap]
                if g in res["symbols"]
                else None
            )
            pvalid = (
                np.asarray(res["pvalid"][g])[:cap]
                if "pvalid" in res
                else None
            )
            b_arr = idx // bs
            keep = b_arr < valid_blocks
            if self._lookahead_mark >= window_block0:
                # Blocks the look-ahead has emitted already.
                keep &= b_arr > self._lookahead_mark - window_block0
            if not keep.any():
                continue
            idx, b_arr, data = idx[keep], b_arr[keep], data[keep]
            if syms is not None:
                syms = syms[keep]
            # Checksum pre-filter (crc/crc.go:49-55, r900.go:215-221): the
            # device program already computed each parser's verdict per
            # surviving row (ops/frontend pvalid bitmask) — unpack it
            # instead of recomputing the CRC/RS on host. The exact NumPy
            # fallback path carries no pvalid, and groups without device
            # validators keep the vectorized host check.
            if (
                pvalid is not None
                and spec.device_validate
                and gspec.validators is not None
            ):
                pvalid = pvalid[keep]
                masks = [
                    ((pvalid >> j) & 1).astype(bool)
                    for j in range(len(self._group_parsers[g]))
                ]
            else:
                masks = [
                    p.valid_mask(data, syms) for p in self._group_parsers[g]
                ]
            valid = np.zeros(idx.shape[0], dtype=bool)
            for m in masks:
                valid |= m
            if not valid.any():
                continue
            b_arr, data = b_arr[valid], data[valid]
            masks = [m[valid] for m in masks]
            if syms is not None:
                syms = syms[valid]
            # Per-block first-occurrence duplicate collapse (see docstring).
            # The scalar path dedups per PARSER at the parser's own packet
            # width (scm/scm.go:62-74: seen keys are that parser's packed
            # bytes) — replicate exactly: one first-occurrence mask per
            # distinct key width in the group, the union of kept rows
            # survives, and each parser's valid mask is ANDed with the mask
            # for ITS width. (Every current group is width-uniform, but a
            # mixed-width group would otherwise under-collapse for the
            # shorter parser.)
            key_mat = syms if gspec.wants_r900 else data
            widths = sorted(
                {
                    key_mat.shape[1]
                    if gspec.wants_r900
                    else (p.cfg.packet_symbols + 7) >> 3
                    for p in self._group_parsers[g]
                }
            )
            fo_by_width: Dict[int, np.ndarray] = {}
            n_cand = key_mat.shape[0]
            b_bytes = b_arr.astype("<u4")[:, None].view(np.uint8)
            for width in widths:
                # Vectorized (block, key-row) first-occurrence mask: prepend
                # the block index bytes to each key row and dedup the raw
                # records as fixed-size void scalars — np.unique's
                # return_index is documented to give FIRST occurrences, so
                # ascending order (the reference's seen-map semantics,
                # scm/scm.go:62-74) is preserved with no per-row Python.
                rec = np.ascontiguousarray(
                    np.concatenate([b_bytes, key_mat[:, :width]], axis=1)
                )
                v = rec.view(f"V{rec.shape[1]}").ravel()
                fo = np.zeros(n_cand, dtype=bool)
                fo[np.unique(v, return_index=True)[1]] = True
                fo_by_width[width] = fo
            union = np.zeros(key_mat.shape[0], dtype=bool)
            for fo in fo_by_width.values():
                union |= fo
            rows_keep = np.nonzero(union)[0]
            b_arr, data = b_arr[rows_keep], data[rows_keep]
            parser_masks = []
            for p, m in zip(self._group_parsers[g], masks):
                width = (
                    key_mat.shape[1]
                    if gspec.wants_r900
                    else (p.cfg.packet_symbols + 7) >> 3
                )
                parser_masks.append(
                    (m & fo_by_width[width])[rows_keep]
                )
            if syms is not None:
                syms = syms[rows_keep]
            group_parsed[g] = (
                b_arr,
                [
                    p.parse_batch(data, syms, valid=m)
                    for p, m in zip(self._group_parsers[g], parser_masks)
                ],
            )

        # Phase B.
        out: List[Tuple[int, Message]] = []
        blocks = sorted(
            {int(b) for b_arr, _ in group_parsed.values() for b in b_arr}
        )
        # Per-group block -> (lo, hi) contiguous candidate ranges, built
        # once vectorized (b_arr ascends) instead of two searchsorted
        # calls per (block, group) pair.
        group_ranges: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for g, (b_arr, _parsed) in group_parsed.items():
            ub, starts = np.unique(b_arr, return_index=True)
            ends = np.append(starts[1:], b_arr.size)
            group_ranges[g] = dict(
                zip(ub.tolist(), zip(starts.tolist(), ends.tolist()))
            )
        for b in blocks:
            global_block = window_block0 + b
            if global_block > self._last_block + 1:
                # Intervening empty blocks cleared the prev digest set
                # (each empty block swaps in an empty next, main.go:292).
                self._deduper.prev = set()
            self._deduper.start_block()
            for g in group_parsed:
                rng = group_ranges[g].get(b)
                if rng is None:
                    continue
                lo, hi = rng
                _b_arr, parsed = group_parsed[g]
                for per_parser in parsed:
                    for r in range(lo, hi):
                        msg = per_parser.get(r)
                        if msg is None:
                            continue
                        if self.filter_fn is not None and not self.filter_fn(msg):
                            self.metrics.messages_dropped_filter += 1
                            continue
                        if not self._deduper.check(mk_digest(msg)):
                            self.metrics.messages_dropped_dup += 1
                            continue
                        self.metrics.messages_out += 1
                        out.append((global_block, msg))
            self._deduper.end_block()
            self._last_block = global_block
        return out

    def _window_results_numpy(
        self, staged: np.ndarray, first: bool
    ) -> Dict[str, object]:
        """Exact NumPy mirror of ops/frontend.decode_window without the
        hit-capacity cap; used when a window overflows max_hits. ``staged``
        is the u16 StagedGeometry buffer (I low byte, Q high byte)."""
        spec = self.spec
        cl, sl, pl, w = (
            spec.chip_length,
            spec.symbol_length,
            spec.packet_length,
            spec.window,
        )
        ps = spec.pad_shift
        v = staged.astype(np.int64)
        di = 255 - 2 * (v & 255)
        dq = 255 - 2 * (v >> 8)
        mag = di * di + dq * dq
        if first:
            mag[: spec.halo_staged] = 0
        cs = np.concatenate([np.zeros(1, np.int64), np.cumsum(mag)])
        lp = w + pl - sl
        f = (
            2 * cs[ps + cl : ps + cl + lp]
            - cs[ps : ps + lp]
            - cs[ps + sl : ps + sl + lp]
        )
        bits = (f >= 0).astype(np.uint8)
        if first:
            bits[:pl] = 0

        q6 = None
        if spec.wants_r900:
            lq = w + pl - 2 * sl
            c = [
                cs[ps + sl + i * cl : ps + sl + i * cl + lq] for i in range(5)
            ]
            a0 = 2 * c[2] - c[4] - c[0]
            a1 = 2 * c[1] - 2 * c[2] + 2 * c[3] - c[4] - c[0]
            a2 = 2 * c[1] - 2 * c[3] + c[4] - c[0]
            mags = np.stack([np.abs(a0), np.abs(a1), np.abs(a2)])
            argmax = np.argmax(mags, axis=0)
            chosen = np.take_along_axis(
                np.stack([a0, a1, a2]), argmax[None, :], axis=0
            )[0]
            q6 = (argmax + np.where(chosen > 0, 3, 0)).astype(np.uint8)

        counts, idxs, byte_mats, symbol_mats = [], [], [], {}
        for g, group in enumerate(spec.groups):
            acc = np.ones(w, dtype=bool)
            for k, bit in enumerate(group.bits):
                acc &= bits[k * sl : k * sl + w] == bit
            hit_idx = np.nonzero(acc)[0].astype(np.int32)
            counts.append(len(hit_idx))
            idxs.append(hit_idx)
            s_g = group.packet_symbols
            nbytes = (s_g + 7) >> 3
            pkt_bits = np.zeros((len(hit_idx), nbytes * 8), np.uint8)
            for i, q in enumerate(hit_idx):
                pkt_bits[i, :s_g] = bits[q : q + s_g * sl : sl]
            byte_mats.append(np.packbits(pkt_bits, axis=-1))
            if group.wants_r900:
                base = spec.preamble_length - sl
                sym = np.zeros((len(hit_idx), PAYLOAD_SYMBOLS), np.uint8)
                for i, q in enumerate(hit_idx):
                    start = q + base
                    sym[i] = q6[start : start + PAYLOAD_SYMBOLS * 4 * cl : 4 * cl]
                symbol_mats[g] = sym
        # Disable the cap for this result set ((G, 2) raw/unique counts).
        counts_arr = np.stack(
            [np.asarray(counts, np.int32), np.asarray(counts, np.int32)],
            axis=1,
        )
        return {
            "counts": counts_arr,
            "idx": idxs,
            "bytes": byte_mats,
            "symbols": symbol_mats,
            "_uncapped": True,
        }
