"""Multi-host (multi-process) decode on ``torch.distributed``.

Port of the JAX package's ``parallel/distributed.py`` (``-coordinator``).
Every process (a host, or a process a card) runs the same program: it calls
:func:`initialize`, which joins one ``gloo`` process group over TCP, and
decodes its own contiguous segment of every super-batch of the sample
stream. A super-batch is ``n_global * scan_windows`` windows, ``n_global =
num_processes * n_local``; process ``p`` owns the windows ``[p * n_local * K,
(p + 1) * n_local * K)``. No process holds the global stream.

Each process decodes its segment as the one-process
:class:`~rtlamr_tpu_torch.parallel.MeshDecoder` decodes a super-batch over
its local devices (``decode_segment``: the halo ring across them, one
window program a window, one pinned fetch, dispatch-ahead). What crosses
processes is host data, sent point to point over gloo:

- **The halo.** Each process reads its own segment on the host, so the only
  samples it lacks are the ``halo_staged`` u16 samples before it: the end
  of process ``p - 1``'s segment (about 213 KB at 1024-block windows). Each
  process sends its segment's tail to ``p + 1`` (``isend``) and receives its
  own halo from ``p - 1``; the wrap hop ``n - 1 -> 0`` is the stream tail,
  the carry into process 0's next super-batch (the JAX program's
  ``left_recv``); process 0 starts from zeros at the stream head. The
  received halo is the carry of the process's local halo ring, so every
  window's staged buffer holds its true halo and an overflowed window
  escalates from its device copy.
- **The seam dedup.** The reference's digest dedup looks one block back
  (main.go:252-292), so only a process's first block can repeat its left
  neighbour's last block. One super-batch late, with the parse, each
  process sends ``p + 1`` the index of its last block with messages and
  those messages' 8-byte digest hashes behind a length header (no capacity
  to overflow), and drops its first block's messages whose hash the left
  neighbour sent; the last process's go to process 0 for the next
  super-batch. The JAX package allgathers these to every process; only the
  right neighbour needs them.

Why gloo and not NCCL: the halo and the digests are host data (each process
reads its segment on the host), and NCCL would need them on a card and one
process a card; it refuses two ranks on one card, which would keep the
multi-process path off a one-card machine.
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..decoder.checkpoint import MultiHostCheckpoint, geometry_mismatch, require_kind
from ..decoder.pipeline import FilterFn
from ..device import DeviceLike
from ..protocols.base import Message, Parser, digest as mk_digest
from .mesh import MeshDecoder

#: point-to-point tags: the halo ring, and the seam digests' header and hashes
TAG_HALO, TAG_SEAM, TAG_DIGESTS = 1, 2, 3


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices_per_process: Optional[int] = None,
) -> Optional[List[str]]:
    """Join the ``gloo`` process group of ``num_processes`` processes at
    ``coordinator_address`` (``host:port``; process 0 listens there) as
    ``process_id``. Returns this process's local devices for
    :class:`MultiHostDecoder`: ``cpu_devices_per_process`` CPU devices (the
    plain versions), or None, every visible card."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    if cpu_devices_per_process:
        return ["cpu"] * cpu_devices_per_process
    return None


def _digest_hash(d) -> bytes:
    """Stable 8-byte hash of a message digest tuple (the JAX package's, so a
    checkpoint's ``prev_batch_tail`` reads in both packages)."""
    return hashlib.blake2b(repr(d).encode(), digest_size=8).digest()


class MultiHostDecoder:
    """Time-sharded decoder over every process's local devices (module
    docstring). Each process feeds its own contiguous segment of each
    super-batch to :meth:`decode_superbatch_local` and receives the messages
    of its windows, seam-deduplicated against its left neighbour.

    Args:
      devices: this process's devices, a shard each; ``None`` means every
        visible card, and raises when there is none. Every process must
        have as many.
      scan_windows: windows a shard decodes each super-batch (K).
      The other arguments are :class:`MeshDecoder`'s.
    """

    def __init__(
        self,
        parsers: Sequence[Parser],
        window_blocks: Optional[int] = 64,
        max_hits: int = 256,
        scan_windows: int = 2,
        filter_fn: Optional[FilterFn] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if not dist.is_initialized():
            raise RuntimeError("MultiHostDecoder: call initialize() first")
        self.process_id = dist.get_rank()
        self.num_processes = dist.get_world_size()
        self._local = MeshDecoder(parsers, devices=devices, window_blocks=window_blocks,
                                  max_hits=max_hits, filter_fn=filter_fn,
                                  scan_windows=scan_windows)
        self.spec, self.cfg = self._local.spec, self._local.cfg
        self.devices = self._local.devices
        self.n_local = self._local.n_devices
        self.scan_windows = scan_windows
        counts = [None] * self.num_processes
        dist.all_gather_object(counts, self.n_local)
        if len(set(counts)) != 1:
            raise ValueError(f"MultiHostDecoder: every process needs as many devices; "
                             f"they have {counts}")
        self.n_global = self.n_local * self.num_processes
        if self.n_local * scan_windows * self.spec.window < self.spec.halo_staged:
            raise ValueError("MultiHostDecoder: a process's segment must cover the halo "
                             f"({self.spec.halo_staged} samples); use a wider window")
        self.reset()

    def reset(self) -> None:
        self._local.reset()
        hs = self.spec.halo_staged
        #: process 0's halo for its next super-batch: the stream tail,
        #: received from the last process (zeros at the stream head)
        self._carry = np.zeros(hs, np.uint16)
        self._first = True
        self._window_index = 0
        #: (block, digest hashes) of the last process's last block with
        #: messages in the previous super-batch: process 0's seam predecessor
        self._prev_batch_tail: Optional[Tuple[int, set]] = None
        ex = self._local.metrics.extra
        ex["superbatches"] = 0
        ex["ring_exchange_ms"] = 0.0
        ex["seam_dedup_ms"] = 0.0

    @property
    def metrics(self):
        return self._local.metrics

    @property
    def local_window_bytes(self) -> int:
        """Bytes of raw IQ this process contributes per super-batch."""
        return self._local.window_bytes

    def decode_superbatch_local(
        self, iq_local: np.ndarray, valid_blocks: Optional[int] = None
    ) -> List[Tuple[int, Message]]:
        """Dispatch one super-batch; complete and return the PREVIOUS one.

        ``iq_local``: this process's ``local_window_bytes`` of raw
        interleaved IQ, its contiguous segment of the global stream.
        ``valid_blocks``: the global count of valid blocks in the
        super-batch (for a zero-padded final one); None = all. Every process
        calls it for every super-batch; call :meth:`drain` after the last."""
        iq = np.ascontiguousarray(iq_local, np.uint8).reshape(-1)
        if iq.size != self.local_window_bytes:
            raise ValueError(f"decode_superbatch_local: {iq.size} bytes, want "
                             f"{self.local_window_bytes}")
        p, n = self.process_id, self.num_processes
        nk = self.n_local * self.scan_windows
        local_blocks = nk * (self.spec.window // self.spec.block_size)
        total = n * local_blocks if valid_blocks is None else valid_blocks
        local_valid = min(max(total - p * local_blocks, 0), local_blocks)
        tail = iq.view(np.uint16)[-self.spec.halo_staged :].copy()

        t = time.perf_counter()
        sends = ([dist.isend(torch.from_numpy(tail.view(np.uint8)), (p + 1) % n, tag=TAG_HALO)]
                 if n > 1 else [])
        carry = self._carry if p == 0 else self._recv_u16(tail.size, p - 1)
        ring_s = time.perf_counter() - t

        had_prev = self._local.in_flight
        msgs = self._local.decode_segment(
            iq, None if local_valid == local_blocks else local_valid, carry,
            self._first and p == 0, self._window_index + p * nk)
        self._window_index += n * nk
        self._first = False

        t = time.perf_counter()
        if p == 0:
            self._carry = self._recv_u16(tail.size, n - 1) if n > 1 else tail
        for req in sends:
            req.wait()
        ex = self._local.metrics.extra
        ex["ring_exchange_ms"] += (ring_s + time.perf_counter() - t) * 1e3
        ex["superbatches"] += 1
        return self._seam_dedup(msgs) if had_prev else msgs

    def drain(self) -> List[Tuple[int, Message]]:
        """Complete the dispatch-ahead pipeline (every process calls it after
        its last super-batch)."""
        had_prev = self._local.in_flight
        msgs = self._local.drain()
        return self._seam_dedup(msgs) if had_prev else msgs

    def checkpoint(self, byte_offset: int) -> MultiHostCheckpoint:
        """This process's resume point (drain first; the carry rows as
        decoder/checkpoint.py says); ``byte_offset``: the global stream's."""
        loc = self._local.export_state()  # raises with a super-batch in flight
        carry = None
        if not self._first:
            carry = np.zeros((self.n_local, self.spec.halo), np.uint16)
            if self.process_id == 0:
                carry[0] = self._carry[self.spec.pad_shift :]  # the stream tail
        tail = self._prev_batch_tail
        return MultiHostCheckpoint(
            byte_offset=byte_offset,
            window_index=self._window_index,
            first=self._first,
            last_block=loc["last_block"],
            carry_local=carry,
            prev_digests=[tuple(d) for d in loc["dedup_prev"]],
            prev_batch_tail=None if tail is None else (tail[0], sorted(tail[1])),
            num_processes=self.num_processes,
            process_id=self.process_id,
            n_global=self.n_global,
            scan_windows=self.scan_windows,
            window=self.spec.window,
        )

    def restore(self, ckpt) -> None:
        """Resume this process's stream at a :class:`MultiHostCheckpoint`;
        refuses one of another kind or saved for another topology."""
        require_kind(ckpt, MultiHostCheckpoint, self)
        got = (ckpt.num_processes, ckpt.n_global, ckpt.process_id, ckpt.scan_windows, ckpt.window)
        want = (self.num_processes, self.n_global, self.process_id, self.scan_windows,
                self.spec.window)
        if got != want:
            raise ValueError(
                f"checkpoint topology mismatch: saved for {got[0]} procs x {got[1]} devices "
                f"(proc {got[2]}, K={got[3]}, window={got[4]}), decoder is {want[0]} x "
                f"{want[1]} (proc {want[2]}, K={want[3]}, window={want[4]})")
        halo, hs = self.spec.halo, self.spec.halo_staged
        # Row 0 is process 0's stream tail (other processes receive theirs);
        # the pad_shift samples before the halo are read by no stencil.
        carry = np.zeros(hs, np.uint16)
        if ckpt.carry_local is not None:
            rows = np.asarray(ckpt.carry_local, np.uint16)
            if rows.size != self.n_local * halo:
                raise geometry_mismatch("carry", rows.shape, (self.n_local, halo),
                                        "different message types?")
            if self.process_id == 0:
                carry[hs - halo :] = rows.reshape(-1, halo)[0]
        self.reset()
        self._local.load_state({
            "carry": self._carry[self.spec.pad_shift :], "first": False, "window_index": 0,
            "last_block": ckpt.last_block, "dedup_prev": ckpt.prev_digests, "dedup_next": (),
        })
        self._window_index = int(ckpt.window_index)
        self._first = bool(ckpt.first)
        self._carry = carry
        tail = ckpt.prev_batch_tail
        self._prev_batch_tail = None if tail is None else (tail[0], set(tail[1]))

    @staticmethod
    def _recv_u16(size: int, src: int) -> np.ndarray:
        """``size`` u16 samples of the halo ring from ``src`` (sent as bytes)."""
        buf = torch.empty(2 * size, dtype=torch.uint8)
        dist.recv(buf, src, tag=TAG_HALO)
        return buf.numpy().view(np.uint16)

    def _seam_dedup(self, msgs: List[Tuple[int, Message]]) -> List[Tuple[int, Message]]:
        """Drop this process's first-block messages that repeat its seam
        predecessor's last block (module docstring): process ``p - 1``'s
        last block of this super-batch, or for process 0 the last process's
        of the previous one. Blocks that are not adjacent do not interact."""
        p, n = self.process_id, self.num_processes
        if n == 1:
            return msgs
        t = time.perf_counter()
        first_b = msgs[0][0] if msgs else -1
        last_b = msgs[-1][0] if msgs else -1
        mine = b"".join(_digest_hash(mk_digest(m)) for b, m in msgs if b == last_b)
        dst, src = (p + 1) % n, (p - 1) % n
        sends = [dist.isend(torch.tensor([last_b, len(mine) // 8], dtype=torch.int64), dst,
                            tag=TAG_SEAM)]
        if mine:
            sends.append(dist.isend(torch.frombuffer(bytearray(mine), dtype=torch.uint8), dst,
                                    tag=TAG_DIGESTS))
        header = torch.empty(2, dtype=torch.int64)
        dist.recv(header, src, tag=TAG_SEAM)
        left_last, count = int(header[0]), int(header[1])
        hashes = torch.empty(8 * count, dtype=torch.uint8)
        if count:
            dist.recv(hashes, src, tag=TAG_DIGESTS)
        raw = hashes.numpy().tobytes()
        left = (left_last, {raw[i : i + 8] for i in range(0, len(raw), 8)}) if left_last >= 0 else None
        for req in sends:
            req.wait()
        if p == 0:
            pred, self._prev_batch_tail = self._prev_batch_tail, left
        else:
            pred = left
        out = msgs
        if msgs and pred is not None and first_b == pred[0] + 1:
            out = []
            for b, m in msgs:
                if b == first_b and _digest_hash(mk_digest(m)) in pred[1]:
                    self._local.metrics.messages_dropped_dup += 1
                    continue
                out.append((b, m))
        self._local.metrics.extra["seam_dedup_ms"] += (time.perf_counter() - t) * 1e3
        return out
