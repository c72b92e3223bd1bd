"""Wideband decode over a (channel x time) layout of devices, in one process.

Port of the JAX package's ``parallel/wideband_mesh.py`` (``-channels N
-mesh``). ``devices`` is read as a ``cdev x tdev`` grid, row major: the
device of channel shard ``ci`` and time shard ``x`` is ``devices[ci * tdev +
x]``. A super-batch is ``tdev * K`` windows of every channel (``K =
scan_windows``); time shard ``x`` owns the windows ``[x*K, (x+1)*K)``.

- **Channel axis.** Channel shard ``ci`` owns the ``C = N / cdev`` channels
  ``[ci*C, (ci+1)*C)``. Each (channel shard, time shard) runs the channelizer
  kernel K2 once a super-batch over its time shard's wideband frames: every
  polyphase branch, and only its own rows of the DFT mix
  (``channelize_requantize_fused(..., channel_start, channel_count)``), as
  the JAX mesh's ``mix_channels`` slice does. No data crosses this axis.
- **Time axis.** The JAX mesh moves two carries to the right neighbour by
  ``ppermute``. Here one process holds the whole super-batch:

  - the filter history of time shard ``x`` is the ``P`` wideband frames
    just before its span, a slice of the super-batch's bytes on the host
    (time shard 0 reads the previous super-batch's last frames, kept on the
    host, or zeros at the stream head);
  - the decode halo of time shard ``x``'s first window is the last
    ``halo_staged`` samples of time shard ``x - 1``'s channel rows, which
    lie on the card of the same channel shard: one device-to-device copy
    (none when the card repeats). Time shard 0 reads the previous
    super-batch's, carried on the card of the last time shard.

  Inside a time shard, window ``k``'s halo is the end of window ``k - 1``:
  K2 writes the shard's rows behind their halo, and each window is staged
  from them (``halo_staged + W`` samples, zeros after) as
  :class:`~rtlamr_tpu_torch.parallel.WidebandDecoder` stages it.

Each (channel shard, time shard) decodes its ``C * K`` windows with the
window program (the decode stencil K1 once a window, then the search); all
result rows go into one pinned ``(cdev, tdev, C, K, P)`` host buffer, waited
for once: at the first feed that finds every shard's copy landed (the
inherited ``poll``), at the latest when the next super-batch is dispatched
(dispatch-ahead). Messages are parsed in
global window order and, within a window, channel by channel, through each
channel's :class:`~rtlamr_tpu_torch.decoder.WindowDecoder`, so every
channel keeps the reference's block numbering and digest dedup; an
overflowed window is escalated from its staged rows on their device. The
:class:`~rtlamr_tpu_torch.parallel.wideband.CrossChannelDeduper` runs last.
The message stream equals the single-card ``WidebandDecoder``'s.

A device may repeat in ``devices`` (``["cpu"] * 4``, ``["cuda:0"] * 4``):
its shards then run one after another on it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..decoder.checkpoint import geometry_mismatch
from ..decoder.pipeline import FilterFn, WindowMeta, fetch
from ..device import DeviceLike
from ..ops.channelizer_fused import channelize_requantize_fused
from ..ops.frontend import decode_windows_scan, packed_size
from ..ops.spec import staged_geometry
from ..protocols.base import Parser
from .mesh import _Events, require_halo_window, resolve_devices
from .wideband import Triple, WidebandDecoder


class WidebandMeshDecoder(WidebandDecoder):
    """Channelize-and-decode over a ``cdev x tdev`` grid of devices (module
    docstring). Message streams per channel are those of
    :class:`WidebandDecoder`; each :meth:`feed` step decodes one
    super-batch, ``2 * N * W * tdev * scan_windows`` wideband bytes.

    Args:
      n_channels: filter-bank size N, divisible by ``cdev``.
      mesh_shape: ``(cdev, tdev)``, channel shards by time shards.
      devices: the grid's devices, row major; ``None`` means every visible
        card, and raises when there is none. The first ``cdev * tdev`` are
        used; a device may repeat.
      scan_windows: windows of every channel a time shard decodes each
        super-batch (K).
      The other arguments are :class:`WidebandDecoder`'s; ``window_blocks``
      None is the least window that covers the halo.
    """

    def __init__(
        self,
        parsers: Sequence[Parser],
        n_channels: int,
        mesh_shape: Tuple[int, int],
        devices: Optional[Sequence[DeviceLike]] = None,
        window_blocks: Optional[int] = None,
        max_hits: int = 256,
        filter_fn: Optional[FilterFn] = None,
        scan_windows: int = 2,
        cross_channel_dedup: bool = False,
    ):
        cdev, tdev = mesh_shape
        if cdev < 1 or tdev < 1 or n_channels % cdev:
            raise ValueError(f"mesh {mesh_shape}: n_channels {n_channels} must be divisible "
                             "by mesh cdev")
        if scan_windows < 1:
            raise ValueError(f"WidebandMeshDecoder: scan_windows {scan_windows} < 1")
        devices = resolve_devices(devices, "WidebandMeshDecoder")
        if len(devices) < cdev * tdev:
            raise ValueError(f"mesh {mesh_shape} needs {cdev * tdev} devices, have {len(devices)}")
        self.devices = devices[: cdev * tdev]
        self.cdev, self.tdev = cdev, tdev
        self.scan_windows = scan_windows
        super().__init__(parsers, n_channels, window_blocks=window_blocks, max_hits=max_hits,
                         filter_fn=filter_fn, cross_channel_dedup=cross_channel_dedup,
                         device=self.devices[0])
        require_halo_window(self.spec)

    def device_of(self, ci: int, x: int) -> torch.device:
        """The device of channel shard ``ci`` and time shard ``x``."""
        return self.devices[ci * self.tdev + x]

    @property
    def channels_per_shard(self) -> int:
        return self.chspec.n_channels // self.cdev

    def reset(self) -> None:
        super().reset()
        n, p = self.chspec.n_channels, self.chspec.history_frames
        c, hs = self.channels_per_shard, self.spec.halo_staged
        # The last P frames of the stream, on the host; the channel tails of
        # each channel shard on the card of its last time shard.
        self._wb_hist = torch.zeros(p * n, dtype=torch.uint16)
        self._chan_tail = [
            torch.zeros((c, hs), dtype=torch.int16, device=self.device_of(ci, self.tdev - 1))
            .view(torch.uint16)
            for ci in range(self.cdev)
        ]

    @property
    def superbatch_bytes(self) -> int:
        """Wideband bytes consumed per super-batch."""
        return 2 * self.chspec.n_channels * self.spec.window * self.tdev * self.scan_windows

    @property
    def window_bytes(self) -> int:
        """Wideband bytes consumed per decode step (one super-batch)."""
        return self.superbatch_bytes

    def _tail_rows(self) -> np.ndarray:
        return torch.cat([t.cpu() for t in self._chan_tail]).numpy().copy()

    def _load_carries(self, hist: Optional[np.ndarray], tail: np.ndarray) -> None:
        if hist is not None:
            self._wb_hist = torch.from_numpy(hist)
        c = self.channels_per_shard
        self._chan_tail = [
            torch.from_numpy(tail[ci * c : (ci + 1) * c].copy()).to(
                self.device_of(ci, self.tdev - 1))
            for ci in range(self.cdev)
        ]

    def _saved_tail(self, rows: np.ndarray) -> np.ndarray:
        return rows[:, self.spec.pad_shift :]  # the JAX wideband mesh's (N, halo)

    def _loaded_tail(self, tail: np.ndarray) -> np.ndarray:
        n, hs, halo = self.n_channels, self.spec.halo_staged, self.spec.halo
        if tail.shape != (n, halo):
            hint = ("a single-card wideband decoder's tail; resume it without -mesh"
                    if tail.shape == (n, hs) else "different -channels or message types?")
            raise geometry_mismatch("chan_tail", tail.shape, (n, halo), hint)
        # The pad_shift samples before the halo are read by no stencil.
        return np.concatenate([np.zeros((n, hs - halo), np.uint16), tail], axis=1)

    def decode_superbatch(self, wb_bytes: np.ndarray,
                          valid_blocks: Optional[int] = None) -> List[Triple]:
        """Dispatch one super-batch of wideband bytes (``valid_blocks``: the
        blocks of every channel that hold capture, for a zero-padded last
        one; None = all); returns the previous super-batch's (channel,
        block, message) triples (:meth:`drain` returns the last one's)."""
        chunk = np.ascontiguousarray(wb_bytes, np.uint8).reshape(-1)
        if chunk.size != self.superbatch_bytes:
            raise ValueError(f"decode_superbatch: {chunk.size} bytes, want "
                             f"{self.superbatch_bytes}")
        return self._process_chunk(chunk, valid_blocks)

    def _process_chunk(self, chunk: np.ndarray,
                       valid_blocks: Optional[int] = None) -> List[Triple]:
        """Dispatch one super-batch (module docstring) and complete the
        previous one."""
        spec, chspec = self.spec, self.chspec
        n, p = chspec.n_channels, chspec.history_frames
        k, c = self.scan_windows, self.channels_per_shard
        w, hs = spec.window, spec.halo_staged
        size = staged_geometry(spec).staged_samples
        cuda = self.device.type == "cuda"
        u16 = torch.from_numpy(np.ascontiguousarray(chunk).view(np.uint16))
        span = k * n * w  # stream elements of a time shard
        first = self._first
        host = torch.empty((self.cdev, self.tdev, c, k, packed_size(spec)), dtype=torch.uint8,
                           pin_memory=cuda)
        staged: Dict[Tuple[int, int], torch.Tensor] = {}
        inputs: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}
        for ci in range(self.cdev):
            left = self._chan_tail[ci]
            for x in range(self.tdev):
                dev = self.device_of(ci, x)
                if (x, dev) not in inputs:
                    # From pageable memory the copy has left ``chunk`` on return.
                    hist = self._wb_hist if x == 0 else u16[x * span - p * n : x * span]
                    inputs[(x, dev)] = (hist.to(dev, non_blocking=True),
                                        u16[x * span : (x + 1) * span].to(dev, non_blocking=True))
                hist_d, wb_d = inputs[(x, dev)]
                rows = torch.empty((c, hs + k * w), dtype=torch.uint16, device=dev)
                # (u16 moved as int16: the same bytes)
                rows[:, :hs].view(torch.int16).copy_(left.view(torch.int16))  # from time shard x - 1
                channelize_requantize_fused(chspec, hist_d, wb_d, first and x == 0,
                                            out=rows[:, hs:], channel_start=ci * c,
                                            channel_count=c)
                batch = torch.empty((c, k, size), dtype=torch.uint16, device=dev)
                batch[:, :, hs + w :].view(torch.int16).zero_()
                batch[:, :, : hs + w].view(torch.int16).copy_(
                    rows.view(torch.int16).unfold(1, hs + w, w))
                firsts = [first and x == 0 and kk == 0 for kk in range(k)] * c
                packed = decode_windows_scan(spec, batch.view(c * k, size), firsts)
                host[ci, x].copy_(packed.view(c, k, -1), non_blocking=cuda)
                staged[(ci, x)] = batch
                left = rows[:, k * w :]
            self._chan_tail[ci] = left.clone()
        self._wb_hist = u16[-p * n :].clone()
        events = _Events.record(self.devices) if cuda else None
        meta = (staged, first, valid_blocks, self._window_index)
        self._window_index += self.tdev * k
        self._first = False
        out = self.drain()
        self._inflight = ((host, events), meta)
        return out

    def _complete(self, inflight) -> List[Triple]:
        """Parse one dispatched super-batch in global window order, channel
        by channel within a window; the ghost dedup last."""
        handle, (staged, first, valid_blocks, window_index) = inflight
        host = fetch(handle)  # ONE wait for every shard's rows
        k, c = self.scan_windows, self.channels_per_shard
        wb = self.spec.window // self.spec.block_size
        total = self.tdev * k * wb if valid_blocks is None else valid_blocks
        out: List[Triple] = []
        for win in range(self.tdev * k):
            win_valid = min(max(total - win * wb, 0), wb)
            if win_valid == 0:
                break  # the valid windows are a prefix
            x, kk = divmod(win, k)
            for ch, chan in enumerate(self._chan):
                ci, r = divmod(ch, c)
                msgs = chan.complete(host[ci, x, r, kk], WindowMeta(
                    staged[(ci, x)][r, kk], first and win == 0,
                    win_valid if win_valid < wb else None, window_index + win))
                out.extend((ch, b, m) for b, m in msgs)
        if self.cross_channel_dedup:
            out = self._xchan.filter(out, on_drop=self._count_ghost)
        self.metrics.windows_decoded += 1
        return out


def dryrun(n_devices: int, device: DeviceLike = None) -> int:
    """Decode, over ``n_devices`` shards on ``device`` (``None``: the card),
    a four-channel capture with packets inside shards, exactly on the first
    time-shard seam and straddling the super-batch boundary, each on its own
    channel; the (channel, block, message) stream must equal the single-card
    :class:`WidebandDecoder`'s. Returns the number of messages."""
    from ..protocols import new_parser
    from ..ref import synth

    chip, n_channels = 8, 4
    cdev = 2 if n_devices >= 2 and n_devices % 2 == 0 else 1
    tdev = n_devices // cdev
    parsers = [new_parser("scm", chip)]
    dec = WidebandMeshDecoder(parsers, n_channels=n_channels, mesh_shape=(cdev, tdev),
                              devices=[device] * n_devices, max_hits=32)
    w, k = dec.spec.window, dec.scan_windows
    shard_span = k * w
    batch_span = tdev * shard_span
    scm_len = 96 * dec.cfg.symbol_length

    def scm(meter_id, offset):
        return synth.bits_to_burst(
            synth.make_scm_bits(meter_id=meter_id, consumption=meter_id % 10), offset)

    planted = [(0, scm(111001, dec.cfg.block_size // 2)), (2, scm(333003, w + 64)),
               (3, scm(444004, batch_span - scm_len // 2))]
    if tdev > 1:
        planted.append((1, scm(222002, shard_span - scm_len // 2)))
    wb = synth.render_wideband(2 * batch_span, planted, n_channels, chip,
                               amplitude=90.0, noise=2.0, seed=41)
    msgs = dec.decode_capture(wb)
    ids = sorted(m.meter_id() for _, _, m in msgs)
    want_ids = sorted([111001, 333003, 444004] + ([222002] if tdev > 1 else []))
    if ids != want_ids:
        raise AssertionError(f"wideband mesh dryrun decoded {ids}, expected {want_ids}")
    single = WidebandDecoder(parsers, n_channels=n_channels, window_blocks=w // dec.cfg.block_size,
                             max_hits=32, device=dec.device)
    got = sorted((c, b, str(m)) for c, b, m in msgs)
    want = sorted((c, b, str(m)) for c, b, m in single.decode_capture(wb))
    if got != want:
        raise AssertionError(f"wideband mesh diverged from the single-card decoder:\n{got}\n{want}")
    return len(msgs)
