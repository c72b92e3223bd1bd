"""Time-sharded decode over several devices, in one process.

Port of the JAX package's ``parallel/mesh.py`` (``-mesh`` with one
channel). A super-batch of ``n * K`` windows (``n`` devices, ``K =
scan_windows``) is split along time: shard ``s`` decodes the contiguous
windows ``[s*K, (s+1)*K)`` on ``devices[s]`` with
:func:`~rtlamr_tpu_torch.ops.frontend.decode_windows_scan` (the decode
stencil kernel once a window, then the search). Every shard's ``(K, P)``
result rows are copied into one pinned ``(n, K, P)`` host buffer, waited for
once, one super-batch late (dispatch-ahead), and parsed in global window
order, so the reference's adjacent-block digest dedup (main.go:252-292)
applies across shard boundaries unchanged.

Halos: every window needs the ``halo`` samples before it. A super-batch is
laid out as the JAX package lays it out (:func:`stage_superbatch`): a window
``k >= 1`` of a shard gets its halo from window ``k - 1`` when it is staged,
and each shard's window 0 has a zero halo. The halo ring fills that on the
devices, as the JAX package's ``ppermute`` does
(:meth:`MeshDecoder.decode_superbatch_staged`): the last ``halo`` samples of
shard ``s``'s last window are copied card to card into shard ``s + 1``'s
window 0, shard 0 takes the carry, and the wrap hop copies shard ``n - 1``'s
tail to shard 0's card, where it stays as the next super-batch's carry; it
reaches the host only for a checkpoint. The ring's copies are ``copy_``
between devices, which PyTorch orders against the current streams of both
cards (the copy waits for the work already enqueued on either, and later
work on the destination waits for the copy), so no event is needed beside
them. The fill goes into a copy of window 0 that the decoder owns, so a
caller's batch is left as it was and can be decoded again, and an overflowed
window is escalated with its full halo from its device copy.

The streaming path (:meth:`MeshDecoder.feed`) stages each super-batch on the
host into a pinned buffer, copies each shard's windows to its card and goes
through the same method. Across processes the multi-host decoder
(``parallel/distributed.py``) sends each segment's tail to the next process
over gloo and hands it to :meth:`MeshDecoder.decode_segment`, which puts it
on shard 0's card as the carry.

A device may repeat in ``devices`` (``["cpu"] * 4``, ``["cuda:0"] * 2``):
its shards then run one after another on it, and the ring's copies between
them stay on that device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decoder.pipeline import FilterFn, WindowDecoder, WindowMeta
from ..device import DeviceLike, resolve_device
from ..ops.frontend import decode_windows_scan, packed_size
from ..ops.spec import FrontendSpec, staged_geometry
from ..protocols.base import Message, Parser


def stage_superbatch(
    spec: FrontendSpec, iq_bytes: np.ndarray, n: int, k: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stage ``n*k`` windows of raw interleaved IQ into (n, k,
    staged_samples) u16 (into ``out`` when given), byte for byte as the JAX
    package stages them: each window's own samples at ``[halo_staged,
    halo_staged + window)``; the halo of a window ``k >= 1`` of a shard, the
    last ``halo`` samples of window ``k - 1``, at ``[pad_shift,
    halo_staged)``; zeros elsewhere. Each shard's window 0 keeps a zero halo:
    the halo ring fills it on the devices."""
    w, halo = spec.window, spec.halo
    ps, hs = spec.pad_shift, spec.halo_staged
    size = staged_geometry(spec).staged_samples
    u16 = np.ascontiguousarray(iq_bytes, np.uint8).view(np.uint16)
    if u16.size != n * k * w:
        raise ValueError(f"stage_superbatch: {u16.size} samples, want {n * k * w}")
    u16 = u16.reshape(n, k, w)
    sb = np.empty((n, k, size), np.uint16) if out is None else out
    sb[:, :, :ps] = 0
    sb[:, 0, ps:hs] = 0
    sb[:, 1:, ps:hs] = u16[:, :-1, w - halo :]
    sb[:, :, hs : hs + w] = u16
    sb[:, :, hs + w :] = 0
    return sb


def require_halo_window(spec: FrontendSpec) -> None:
    """Refuse a shard's window shorter than the halo its next shard takes."""
    if spec.window < spec.halo:
        raise ValueError("per-shard window must cover the halo: need window_blocks >= "
                         f"{-(-spec.halo // spec.block_size)} "
                         f"(window {spec.window} < halo {spec.halo})")


def _copy16(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for u16 tensors, between any two devices (moved
    as int16: the same bytes)."""
    dst.view(torch.int16).copy_(src.view(torch.int16))


class _Events(list):
    """The copy events of a super-batch's fetch, one a device, waited for as
    one (``pipeline.fetch`` calls ``synchronize``, ``pipeline.ready``
    ``query``)."""

    @classmethod
    def record(cls, devices: Sequence[torch.device]) -> "_Events":
        """An event recorded on the current stream of each distinct device."""
        events = cls()
        for dev in dict.fromkeys(devices):
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(dev))
        return events

    def synchronize(self) -> None:
        for event in self:
            event.synchronize()

    def query(self) -> bool:
        """Whether every device's copy has completed; never waits."""
        return all(event.query() for event in self)


class MeshDecoder(WindowDecoder):
    """Time-sharded decoder over ``n`` devices (module docstring).

    Decode semantics (message sets, block indices, dedup) are those of
    :class:`WindowDecoder`; each :meth:`feed` step decodes ``n *
    scan_windows`` windows. The stream state's carry is the JAX mesh
    decoder's: the stream's last ``halo`` samples, (halo,) u16.

    Args:
      devices: one device a shard; ``None`` means every visible card, and
        raises when there is none (the decoder never moves to the CPU on
        its own; pass ``["cpu"] * n`` for the plain versions). A device may
        repeat.
      scan_windows: windows a shard decodes each step (K).
      The other arguments are :class:`WindowDecoder`'s.
    """

    def __init__(
        self,
        parsers: Sequence[Parser],
        devices: Optional[Sequence[DeviceLike]] = None,
        window_blocks: Optional[int] = 64,
        max_hits: int = 256,
        filter_fn: Optional[FilterFn] = None,
        scan_windows: int = 2,
    ):
        self.devices = resolve_devices(devices, "MeshDecoder")
        if scan_windows < 1:
            raise ValueError(f"MeshDecoder: scan_windows {scan_windows} < 1")
        self.n_devices = len(self.devices)
        self.scan_windows = scan_windows
        super().__init__(parsers, window_blocks=window_blocks, max_hits=max_hits,
                         filter_fn=filter_fn, device=self.devices[0])
        require_halo_window(self.spec)

    def reset(self) -> None:
        super().reset()
        #: the stream's last ``halo`` samples before the next super-batch, on
        #: shard 0's device: the wrap hop's delivery (zeros at the stream head)
        self._carry = torch.zeros(self.spec.halo, dtype=torch.int16,
                                  device=self.devices[0]).view(torch.uint16)

    def _host_carry(self) -> np.ndarray:
        return self._carry.cpu().numpy().copy()

    def _load_carry(self, carry: np.ndarray) -> None:
        if carry.shape != (self.spec.halo,):
            raise ValueError(f"load_state: carry of {carry.shape}, want ({self.spec.halo},)")
        self._carry = torch.from_numpy(carry.copy()).to(self.devices[0])

    def _carry_geometry(self) -> Tuple[Tuple[int], Tuple[int], str]:
        return ((self.spec.halo,), (self.spec.halo_staged,),
                "a single-device decoder's tail; resume it without -mesh")

    @property
    def window_bytes(self) -> int:  # feed() granularity: one super-batch
        return 2 * self.spec.window * self.n_devices * self.scan_windows

    def decode_segment(
        self, super_bytes: np.ndarray, valid_blocks: Optional[int], carry: np.ndarray,
        first: bool, window_index: int,
    ) -> List[Tuple[int, Message]]:
        """Dispatch one super-batch that is a segment of a longer stream and
        complete the previous one, as :meth:`feed` does: ``carry`` is the
        (halo_staged,) u16 stream samples before the segment, whose last
        ``halo`` go to shard 0's device as the carry; ``first`` whether it
        starts the stream, ``window_index`` the stream index of its first
        window. The multi-host decoder decodes each process's segment with
        it."""
        carry = np.asarray(carry, np.uint16)
        if carry.shape != (self.spec.halo_staged,):
            raise ValueError(f"decode_segment: carry of {carry.shape}, "
                             f"want ({self.spec.halo_staged},)")
        self._load_carry(carry[self.spec.pad_shift :])
        self._first = first
        self._window_index = window_index
        return self._process_window(super_bytes, valid_blocks)

    def _process_window(
        self, super_bytes: np.ndarray, valid_blocks: Optional[int] = None
    ) -> List[Tuple[int, Message]]:
        """Stage one super-batch into a host buffer, copy each shard's
        windows to its device and decode them there with
        :meth:`decode_superbatch_staged`; complete the previous super-batch."""
        n, k = self.n_devices, self.scan_windows
        cuda = self.device.type == "cuda"
        size = staged_geometry(self.spec).staged_samples
        # A fresh pinned buffer a super-batch: the host allocator reuses it
        # only once the copies that read it have completed. On the CPU each
        # shard decodes its rows of it in place.
        sb = torch.empty((n, k, size), dtype=torch.uint16, pin_memory=cuda)
        stage_superbatch(self.spec, super_bytes, n, k, out=sb.numpy())
        shards = [sb[s].to(dev, non_blocking=True) if cuda else sb[s]
                  for s, dev in enumerate(self.devices)]
        return self.decode_superbatch_staged(shards, valid_blocks, drain=False)

    def decode_superbatch_staged(
        self, sb: Sequence[torch.Tensor], valid_blocks: Optional[int] = None,
        drain: bool = True,
    ) -> List[Tuple[int, Message]]:
        """Decode a super-batch already on the devices.

        ``sb[s]`` is shard ``s``'s (K, staged_samples) u16 windows on
        ``devices[s]``, in the :func:`stage_superbatch` layout (window 0's
        halo zero). The halo ring (module docstring) fills each shard's
        window-0 halo in a copy the decoder owns, so ``sb`` is left
        unchanged; then each shard's window programs and the one fetch are
        enqueued and the previous super-batch is completed. Returns its
        messages and, with ``drain``, this one's too. ``valid_blocks``
        counts the blocks of a partial last super-batch, over all its
        windows."""
        spec = self.spec
        n, k = self.n_devices, self.scan_windows
        w, halo, hs = spec.window, spec.halo, spec.halo_staged
        size = staged_geometry(spec).staged_samples
        if len(sb) != n or any(
            tuple(b.shape) != (k, size) or b.dtype != torch.uint16 or b.device != dev
            for b, dev in zip(sb, self.devices)
        ):
            raise ValueError(
                f"decode_superbatch_staged: want {n} ({k}, {size}) uint16 tensors, "
                f"one on each of {[str(d) for d in self.devices]}; got "
                f"{[(b.dtype, tuple(b.shape), str(b.device)) for b in sb]}")
        cuda = self.device.type == "cuda"
        # The ring: window 0 of shard s gets the tail of shard s - 1's last
        # window (shard 0: the carry); the last shard's tail is the next carry.
        left = self._carry
        shards = []
        for s, dev in enumerate(self.devices):
            win0 = torch.empty(size, dtype=torch.uint16, device=dev)
            _copy16(win0, sb[s][0])
            _copy16(win0[spec.pad_shift : hs], left)
            shards.append([win0, *sb[s][1:]])
            left = sb[s][k - 1, hs + w - halo : hs + w]
        carry = torch.empty(halo, dtype=torch.uint16, device=self.devices[0])
        _copy16(carry, left)  # the wrap hop
        self._carry = carry

        host = torch.empty((n, k, packed_size(spec)), dtype=torch.uint8, pin_memory=cuda)
        for s, windows in enumerate(shards):
            firsts = [self._first and s == 0 and kk == 0 for kk in range(k)]
            host[s].copy_(decode_windows_scan(spec, windows, firsts), non_blocking=cuda)
        events = _Events.record(self.devices) if cuda else None

        wb = w // spec.block_size
        total = n * k * wb if valid_blocks is None else valid_blocks
        metas = []
        for win in range(n * k):
            win_valid = min(max(total - win * wb, 0), wb)
            if win_valid == 0:
                break  # the valid windows are a prefix
            s, kk = divmod(win, k)
            metas.append(WindowMeta(
                shards[s][kk], self._first and win == 0,
                win_valid if win_valid < wb else None, self._window_index + win,
            ))
        self._window_index += n * k
        self._first = False
        # Rows in global window order; rows past the last valid window are
        # not completed.
        out = self._dispatch(((host.view(n * k, -1), events), metas))
        if drain:
            out.extend(self.drain())
        return out


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current index>``, so equal cards compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(devices: Optional[Sequence[DeviceLike]], who: str) -> List[torch.device]:
    """A decoder's device list: ``None`` is every visible card, and raises
    when there is none (no decoder moves to the CPU on its own); otherwise
    one or more devices of one type, each ``cuda`` made ``cuda:<index>``. A
    device may repeat."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = [_indexed(resolve_device(d)) for d in devices]
    if not out or len({d.type for d in out}) != 1:
        raise ValueError(f"{who}: want one or more devices of one type, got {devices}")
    return out


def dryrun(n_devices: int, window_blocks: Optional[int] = None,
           device: DeviceLike = None) -> int:
    """Decode, with ``n_devices`` shards on ``device`` (``None``: the card),
    a noisy all-protocol capture with packets planted inside shards, exactly
    on the first shard boundary and on the super-batch boundary; check that
    each boundary packet decodes exactly once and that the (block, message)
    stream equals the NumPy oracle's. Returns the number of messages."""
    from ..protocols import new_parser
    from ..ref import ReferenceDecoder, synth

    chip_length = 8  # smallest supported => tiniest shapes (flags.go:127)
    names = ("scm", "idm", "r900")
    parsers = [new_parser(n, chip_length) for n in names]
    dec = MeshDecoder(
        parsers,
        devices=[device] * n_devices,
        window_blocks=window_blocks,
        max_hits=32,
    )
    cfg = dec.cfg
    w = dec.spec.window
    k = dec.scan_windows
    shard_span = k * w  # samples per shard's contiguous run
    super_span = n_devices * shard_span
    scm_packet_len = 96 * cfg.symbol_length

    # Non-overlapping burst offsets (IDM is 736 symbols long):
    sl = cfg.symbol_length
    o_scm = cfg.block_size // 4
    o_idm = o_scm + 96 * sl + 2 * sl
    o_r900 = o_idm + 736 * sl + 2 * sl
    bursts = [
        synth.bits_to_burst(synth.make_scm_bits(meter_id=123456, consumption=42), o_scm),
        synth.bits_to_burst(synth.make_idm_bits(serial=777777), o_idm),
        synth.r900_burst(synth.make_r900_symbols(meter_id=424242), o_r900),
    ]
    expected = [123456, 424242, 777777]
    if n_devices > 1:
        # Exactly on the first shard boundary: found once and once only
        # (the halo ring + digest dedup).
        bursts.append(synth.bits_to_burst(
            synth.make_scm_bits(meter_id=654321, consumption=7),
            shard_span - scm_packet_len // 2))
        expected.append(654321)
    # Straddling the super-batch boundary: exercises the carry.
    bursts.append(synth.bits_to_burst(
        synth.make_scm_bits(meter_id=13579, consumption=9), super_span - scm_packet_len // 2))
    expected.append(13579)
    iq = synth.render_iq(2 * super_span, bursts, chip_length, noise=2.0, seed=31)

    msgs = dec.decode_capture(iq)
    ids = sorted(m.meter_id() for _, m in msgs)
    if ids != sorted(expected):
        raise AssertionError(f"mesh dryrun decoded {ids}, expected {sorted(expected)}")

    # Full conformance: identical (block, message) stream to the oracle.
    oracle = ReferenceDecoder(
        [new_parser(n, chip_length) for n in names], arithmetic="int"
    ).decode_capture(iq)
    got = [(b, str(m)) for b, m in msgs]
    want = [(b, str(m)) for b, m in oracle]
    if got != want:
        raise AssertionError(f"mesh dryrun diverged from the oracle:\n{got}\n{want}")
    return len(msgs)
