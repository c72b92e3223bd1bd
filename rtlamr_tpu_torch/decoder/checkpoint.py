"""Stream-position checkpoint / resume for long offline captures.

Port of the JAX package's ``decoder/checkpoint.py`` for the single-card
decoders. The reference keeps no decoder state worth checkpointing
(SURVEY.md §5.4); its decode state is at most BufferLength samples of
history. So a resume point is the byte offset of the next window, the
window and block counters, the carried samples and the dedup digest sets;
restoring it continues the decode bit-identically.

- :class:`~rtlamr_tpu_torch.decoder.WindowDecoder`: kind ``"window"``, the
  ``(halo_staged,)`` u16 staged tail in ``path.carry.bin``.
- :class:`~rtlamr_tpu_torch.parallel.MeshDecoder`: kind ``"window"`` with
  the JAX mesh decoder's ``(halo,)`` carry, the last ``halo`` samples of the
  stream (held on shard 0's device and fetched for the save), so either
  package's mesh decoder resumes it. A mesh checkpoint
  into a single-device decoder, or the reverse, is refused as a geometry
  mismatch, as the JAX package refuses it.
- :class:`~rtlamr_tpu_torch.parallel.WidebandDecoder`: kind ``"wideband"``,
  ``path.carry.npz`` holding the channelizer history ``wb_hist`` as (2, N, P)
  f32 DC-removed frames (zeros at the stream head) and the per-channel
  staged tails ``chan_tail`` (N, halo_staged) u16; the meta holds each
  channel's block counter and digest set and the cross-channel ghost-dedup
  rows.
- :class:`~rtlamr_tpu_torch.parallel.WidebandMeshDecoder`: kind
  ``"wideband"`` with the JAX wideband mesh's ``(N, halo)`` tails (the
  port's staged tails without the ``pad_shift`` samples no stencil reads),
  so either package's wideband mesh resumes it; into a single-card wideband
  decoder, or the reverse, it is refused as a geometry mismatch, as in the
  JAX package.
- :class:`~rtlamr_tpu_torch.parallel.distributed.MultiHostDecoder`: kind
  ``"multihost"``, one file set a process, ``path.pN.meta.json`` and
  ``path.pN.carry.bin`` (:class:`MultiHostCheckpoint`): the process's
  ``(n_local, halo)`` carry rows in the JAX package's layout (row 0 of
  process 0 is the stream tail, the only row either package reads; the
  port writes zeros in the others), its dedup state and the seam
  predecessor's digest hashes, with the topology it was saved for.

The files are the JAX package's, so a checkpoint written by either package
resumes in the other. The meta (``path.meta.json``) adds two keys, which the
JAX package does not read: ``carry_sha256``, the digest of the carry file,
and ``window``, the decoder's window in samples; the port checks both when
they are present. The multi-host decoder's per-process file sets,
:class:`MultiHostCheckpoint`, are read by their own ``load``.

A save is atomic: each file is written under a temporary name in the same
directory and moved into place with ``os.replace``, the carry first, then
the meta. Until the new meta is in place the previous carry stays reachable
as ``path.carry.*.prev``; a crash between the two moves leaves a carry that
does not match the meta, and :func:`load_checkpoint` then reads the previous
carry, whose digest does. So a crash leaves the previous complete checkpoint
or the new one, never a mix.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..parallel.distributed import MultiHostDecoder
from ..parallel.mesh import MeshDecoder
from ..parallel.wideband import WidebandDecoder
from ..parallel.wideband_mesh import WidebandMeshDecoder
from .pipeline import WindowDecoder


def _ser_digests(digests) -> List[List]:
    return [[d[0], d[1], d[2], d[3].hex()] for d in sorted(digests)]


def _de_digests(rows) -> List[Tuple]:
    return [(t, mt, mid, bytes.fromhex(ck)) for t, mt, mid, ck in rows]


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def _write_tmp(path: str, data: bytes) -> str:
    """``data`` written and synced to a new file beside ``path``; its name."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=os.path.basename(path) + ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        _remove(tmp)
        raise
    return tmp


def _read_pair(path: str, suffix: str) -> Tuple[dict, str, bytes]:
    """The meta, and the name and bytes of the carry file that matches it:
    ``path + suffix``, or after a crash between the two moves of a save the
    previous carry (module docstring)."""
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    want = meta.get("carry_sha256")
    carry_path = path + suffix
    for name in (carry_path, carry_path + ".prev"):
        if name != carry_path and (want is None or not os.path.exists(name)):
            continue
        with open(name, "rb") as f:
            data = f.read()
        if want is None or hashlib.sha256(data).hexdigest() == want:
            return meta, name, data
    raise ValueError(
        f"checkpoint {path}: {carry_path} does not match its meta "
        "(and no previous carry does)"
    )


def _save_pair(path: str, suffix: str, carry: bytes, meta: dict) -> None:
    """Atomic save of ``path.meta.json`` and ``path + suffix`` (module
    docstring)."""
    carry_path, meta_path = path + suffix, path + ".meta.json"
    prev = carry_path + ".prev"
    meta = dict(meta, carry_sha256=hashlib.sha256(carry).hexdigest())
    tmps: List[str] = []
    try:
        tmps.append(_write_tmp(carry_path, carry))
        tmps.append(_write_tmp(meta_path, json.dumps(meta).encode()))
        try:  # the carry file that matches the meta in place now, if any
            old = _read_pair(path, suffix)[1]
        except (OSError, ValueError):
            old = None
        if old == carry_path:
            _remove(prev)
            try:
                os.link(carry_path, prev)
            except OSError:  # a file system without hard links
                shutil.copyfile(carry_path, prev)
        os.replace(tmps[0], carry_path)
        try:
            os.replace(tmps[1], meta_path)
        except BaseException:
            if old is not None:
                os.replace(prev, carry_path)  # the previous pair, whole again
            raise
        dir_fd = os.open(os.path.dirname(os.path.abspath(meta_path)), os.O_RDONLY)
        try:
            os.fsync(dir_fd)  # make the two moves durable
        finally:
            os.close(dir_fd)
        _remove(prev)
    finally:
        for tmp in tmps:
            _remove(tmp)


@dataclass
class Checkpoint:
    """Exact resume point of a WindowDecoder stream."""

    byte_offset: int  # capture bytes fully consumed (window-granular)
    window_index: int
    last_block: int
    first: bool
    carry: np.ndarray  # (halo_staged,) u16 staged samples
    prev_digests: List[Tuple]  # Digest tuples
    #: the decoder's window in samples (None: a file without it)
    window: Optional[int] = None
    #: the last block the look-ahead emitted (None: none, or a file without
    #: it); written only when set
    lookahead_mark: Optional[int] = None

    def save(self, path: str) -> None:
        meta = {
            "kind": "window",
            "byte_offset": self.byte_offset,
            "window_index": self.window_index,
            "last_block": self.last_block,
            "first": self.first,
            "prev_digests": _ser_digests(self.prev_digests),
            "window": self.window,
        }
        if self.lookahead_mark is not None:
            meta["lookahead_mark"] = self.lookahead_mark
        carry = np.ascontiguousarray(self.carry, "<u2").tobytes()
        _save_pair(path, ".carry.bin", carry, meta)

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        meta, _, data = _read_pair(path, ".carry.bin")
        return cls(
            byte_offset=meta["byte_offset"],
            window_index=meta["window_index"],
            last_block=meta["last_block"],
            first=meta["first"],
            carry=np.frombuffer(data, "<u2").astype(np.uint16),
            prev_digests=_de_digests(meta["prev_digests"]),
            window=meta.get("window"),
            lookahead_mark=meta.get("lookahead_mark"),
        )


@dataclass
class WidebandCheckpoint:
    """Exact resume point of a WidebandDecoder stream."""

    byte_offset: int  # wideband bytes fully consumed (super-step-granular)
    window_index: int
    first: bool
    wb_hist: np.ndarray  # (2, N, history_frames) f32 channelizer history
    chan_tail: np.ndarray  # (N, halo_staged) u16 per-channel staged tails
    chan_last_block: List[int]
    chan_prev_digests: List[List[Tuple]]
    xchan_seen: List[Tuple]  # (digest, block, channel) ghost-dedup rows
    #: the per-channel window in samples (None: a file without it)
    window: Optional[int] = None

    def save(self, path: str) -> None:
        meta = {
            "kind": "wideband",
            "byte_offset": self.byte_offset,
            "window_index": self.window_index,
            "first": self.first,
            "chan_last_block": list(self.chan_last_block),
            "chan_prev_digests": [_ser_digests(d) for d in self.chan_prev_digests],
            "xchan_seen": [
                [t, mt, mid, ck.hex(), b, c]
                for (t, mt, mid, ck), b, c in sorted(self.xchan_seen)
            ],
            "window": self.window,
        }
        buf = io.BytesIO()
        np.savez(buf, wb_hist=self.wb_hist, chan_tail=self.chan_tail)
        _save_pair(path, ".carry.npz", buf.getvalue(), meta)

    @classmethod
    def load(cls, path: str) -> "WidebandCheckpoint":
        meta, _, data = _read_pair(path, ".carry.npz")
        arrs = np.load(io.BytesIO(data))
        return cls(
            byte_offset=meta["byte_offset"],
            window_index=meta["window_index"],
            first=meta["first"],
            wb_hist=arrs["wb_hist"],
            chan_tail=arrs["chan_tail"],
            chan_last_block=list(meta["chan_last_block"]),
            chan_prev_digests=[_de_digests(d) for d in meta["chan_prev_digests"]],
            xchan_seen=[
                ((t, mt, mid, bytes.fromhex(ck)), b, c)
                for t, mt, mid, ck, b, c in meta["xchan_seen"]
            ],
            window=meta.get("window"),
        )


@dataclass
class MultiHostCheckpoint:
    """Per-process resume point of a MultiHostDecoder stream, in the JAX
    package's ``MultiHostCheckpoint`` file format (module docstring)."""

    byte_offset: int  # GLOBAL capture bytes consumed (super-batch granular)
    window_index: int
    first: bool
    last_block: int
    carry_local: Optional[np.ndarray]  # (n_local, halo) u16; None at the stream head
    prev_digests: List[Tuple]
    #: (block, [8-byte digest hashes]) of process 0's seam predecessor: the
    #: last process's last block with messages in the previous super-batch
    prev_batch_tail: Optional[Tuple[int, List[bytes]]]
    num_processes: int
    process_id: int
    n_global: int
    scan_windows: int
    window: int

    def save(self, path: str) -> None:
        tail = self.prev_batch_tail
        meta = {
            "kind": "multihost",
            "byte_offset": self.byte_offset,
            "window_index": self.window_index,
            "first": self.first,
            "last_block": self.last_block,
            "prev_digests": _ser_digests(self.prev_digests),
            "prev_batch_tail": (
                None if tail is None else [tail[0], [h.hex() for h in sorted(tail[1])]]
            ),
            "num_processes": self.num_processes,
            "process_id": self.process_id,
            "n_global": self.n_global,
            "scan_windows": self.scan_windows,
            "window": self.window,
            "has_carry": self.carry_local is not None,
        }
        carry = b"" if self.carry_local is None else np.ascontiguousarray(
            self.carry_local, "<u2").tobytes()
        _save_pair(f"{path}.p{self.process_id}", ".carry.bin", carry, meta)

    @classmethod
    def load(cls, path: str, process_id: int) -> "MultiHostCheckpoint":
        base = f"{path}.p{process_id}"
        with open(base + ".meta.json") as f:
            meta = json.load(f)
        data = b""
        if meta.get("has_carry") or "carry_sha256" in meta:
            # (the JAX package writes no carry file at the stream head)
            meta, _, data = _read_pair(base, ".carry.bin")
        if meta.get("kind") != "multihost":
            raise ValueError(f"checkpoint {path}.p{process_id}: kind {meta.get('kind')!r}, "
                             "not a multi-host file set")
        tail = meta["prev_batch_tail"]
        return cls(
            byte_offset=meta["byte_offset"],
            window_index=meta["window_index"],
            first=meta["first"],
            last_block=meta["last_block"],
            carry_local=(np.frombuffer(data, "<u2").astype(np.uint16)
                         if meta["has_carry"] else None),
            prev_digests=_de_digests(meta["prev_digests"]),
            prev_batch_tail=(None if tail is None
                             else (tail[0], [bytes.fromhex(h) for h in tail[1]])),
            num_processes=meta["num_processes"],
            process_id=meta["process_id"],
            n_global=meta["n_global"],
            scan_windows=meta["scan_windows"],
            window=meta["window"],
        )


def checkpoint_exists(path: str) -> bool:
    """True when ``path`` names a checkpoint file set of any kind, the JAX
    package's per-process multi-host sets (``path.pN.meta.json``) included,
    which :func:`load_checkpoint` refuses."""
    return os.path.exists(path + ".meta.json") or bool(
        glob.glob(glob.escape(path) + ".p[0-9]*.meta.json")
    )


def remove_checkpoint(path: str, process_id: Optional[int] = None) -> None:
    """Delete the checkpoint file set at ``path``, if any: a single-card
    one, or with ``process_id`` that process's multi-host set."""
    if process_id is not None:
        path = f"{path}.p{process_id}"
    for suffix in (".meta.json", ".carry.bin", ".carry.npz"):
        _remove(path + suffix)
        _remove(path + suffix + ".prev")


def load_checkpoint(path: str):
    """Load whichever single-card checkpoint kind ``path`` holds."""
    multihost = ("a multi-host decoder's per-process file set: resume it with -coordinator "
                 "(MultiHostCheckpoint.load(path, process_id))")
    if not os.path.exists(path + ".meta.json") and checkpoint_exists(path):
        raise ValueError(f"checkpoint {path}: {multihost}")
    with open(path + ".meta.json") as f:
        kind = json.load(f).get("kind", "window")
    if kind == "wideband":
        return WidebandCheckpoint.load(path)
    if kind == "window":
        return Checkpoint.load(path)
    raise ValueError(f"checkpoint {path}: kind {kind!r}, "
                     + (multihost if kind == "multihost" else "unknown"))


def _require_boundary(dec) -> None:
    if dec._pending.size:
        raise ValueError(
            "checkpoint only at window boundaries: "
            f"{dec._pending.size} pending bytes"
        )
    if dec._inflight is not None:
        raise ValueError(
            "checkpoint with an undrained window in flight; call drain() "
            "and emit its messages first"
        )


def capture_checkpoint(dec, byte_offset: int):
    """Snapshot a decoder at a window boundary (no pending bytes, nothing
    in flight); ``byte_offset`` is the capture bytes it has consumed (for a
    multi-host decoder, the global stream's)."""
    if isinstance(dec, MultiHostDecoder):
        return _capture_multihost(dec, byte_offset)
    _require_boundary(dec)
    state = dec.export_state()
    if isinstance(dec, WidebandDecoder):
        chans = state["channels"]
        tail = state["chan_tail"]
        if isinstance(dec, WidebandMeshDecoder):
            tail = tail[:, dec.spec.pad_shift :]  # the JAX wideband mesh's (N, halo)
        return WidebandCheckpoint(
            byte_offset=byte_offset,
            window_index=state["window_index"],
            first=state["first"],
            wb_hist=state["wb_hist"],
            chan_tail=np.ascontiguousarray(tail),
            chan_last_block=[c["last_block"] for c in chans],
            chan_prev_digests=[[tuple(d) for d in c["dedup_prev"]] for c in chans],
            xchan_seen=state["xchan_seen"],
            window=dec.spec.window,
        )
    if isinstance(dec, WindowDecoder):
        return Checkpoint(
            byte_offset=byte_offset,
            window_index=state["window_index"],
            last_block=state["last_block"],
            first=state["first"],
            carry=state["carry"],  # a MeshDecoder's: the JAX mesh decoder's (halo,)
            prev_digests=[tuple(d) for d in state["dedup_prev"]],
            window=dec.spec.window,
            lookahead_mark=state.get("lookahead_mark"),
        )
    raise TypeError(f"capture_checkpoint: no checkpoint kind for {type(dec).__name__}")


def _capture_multihost(dec: MultiHostDecoder, byte_offset: int) -> MultiHostCheckpoint:
    state = dec.export_state()
    carry = None
    if not state["first"]:
        carry = np.zeros((dec.n_local, dec.spec.halo), np.uint16)
        if dec.process_id == 0:
            carry[0] = state["carry"][dec.spec.pad_shift :]  # the stream tail
    tail = state["prev_batch_tail"]
    return MultiHostCheckpoint(
        byte_offset=byte_offset,
        window_index=state["window_index"],
        first=state["first"],
        last_block=state["last_block"],
        carry_local=carry,
        prev_digests=[tuple(d) for d in state["dedup_prev"]],
        prev_batch_tail=None if tail is None else (tail[0], sorted(tail[1])),
        num_processes=dec.num_processes,
        process_id=dec.process_id,
        n_global=dec.n_global,
        scan_windows=dec.scan_windows,
        window=dec.spec.window,
    )


def _restore_multihost(dec: MultiHostDecoder, ckpt: MultiHostCheckpoint) -> None:
    got = (ckpt.num_processes, ckpt.n_global, ckpt.process_id, ckpt.scan_windows, ckpt.window)
    want = (dec.num_processes, dec.n_global, dec.process_id, dec.scan_windows, dec.spec.window)
    if got != want:
        raise ValueError(
            f"checkpoint topology mismatch: saved for {got[0]} procs x {got[1]} devices "
            f"(proc {got[2]}, K={got[3]}, window={got[4]}), decoder is {want[0]} x {want[1]} "
            f"(proc {want[2]}, K={want[3]}, window={want[4]})")
    halo, hs = dec.spec.halo, dec.spec.halo_staged
    # Row 0 is process 0's stream tail (other processes receive theirs);
    # the pad_shift samples before the halo are read by no stencil.
    carry = np.zeros(hs, np.uint16)
    if ckpt.carry_local is not None:
        rows = np.asarray(ckpt.carry_local, np.uint16)
        if rows.size != dec.n_local * halo:
            raise _geometry("carry", rows.shape, (dec.n_local, halo), "different message types?")
        if dec.process_id == 0:
            carry[hs - halo :] = rows.reshape(-1, halo)[0]
    dec.load_state({
        "window_index": ckpt.window_index,
        "first": ckpt.first,
        "carry": carry,
        "last_block": ckpt.last_block,
        "dedup_prev": ckpt.prev_digests,
        "prev_batch_tail": ckpt.prev_batch_tail,
    })


def _geometry(what: str, got, want, hint: str) -> ValueError:
    """The refusal of a carry of shape ``got`` where ``want`` is needed."""
    return ValueError(
        f"checkpoint geometry mismatch: {what} has {got}, decoder wants {want} ({hint})"
    )


def restore_checkpoint(dec, ckpt) -> None:
    """Restore a decoder to a checkpoint; decode continues bit-identically.
    Refuses a checkpoint of another kind, geometry or topology."""
    if isinstance(dec, MultiHostDecoder) != isinstance(ckpt, MultiHostCheckpoint):
        raise ValueError(f"checkpoint kind mismatch: {type(ckpt).__name__} cannot "
                         f"restore a {type(dec).__name__}")
    if isinstance(dec, MultiHostDecoder):
        _restore_multihost(dec, ckpt)
        return
    wide = isinstance(dec, WidebandDecoder)
    if not isinstance(dec, (WindowDecoder, WidebandDecoder)) or isinstance(
        ckpt, WidebandCheckpoint
    ) != wide or not isinstance(ckpt, (Checkpoint, WidebandCheckpoint)):
        raise ValueError(
            f"checkpoint kind mismatch: {type(ckpt).__name__} cannot "
            f"restore a {type(dec).__name__}"
        )
    if ckpt.window is not None and ckpt.window != dec.spec.window:
        raise ValueError(
            f"checkpoint geometry mismatch: saved at a window of {ckpt.window} "
            f"samples, decoder has {dec.spec.window} (different -windowblocks?)"
        )
    hs, halo = dec.spec.halo_staged, dec.spec.halo
    if not wide:
        carry = np.asarray(ckpt.carry, np.uint16)
        if isinstance(dec, MeshDecoder):
            if carry.shape != (halo,):
                hint = ("a single-device decoder's tail; resume it without -mesh"
                        if carry.shape == (hs,) else "different message types?")
                raise _geometry("carry", carry.shape, (halo,), hint)
        elif carry.shape != (hs,):
            hint = ("a mesh decoder's tail: resume it with -mesh, the multi-GPU "
                    "time-sharded decoder"
                    if carry.shape == (halo,) else "different message types?")
            raise _geometry("carry", carry.shape, (hs,), hint)
        dec.load_state({
            "carry": carry,
            "first": ckpt.first,
            "window_index": ckpt.window_index,
            "last_block": ckpt.last_block,
            "dedup_prev": ckpt.prev_digests,
            # next is rebuilt at every block start (decoder/dedup.py)
            "dedup_next": (),
            "lookahead_mark": ckpt.lookahead_mark,
        })
        return
    n, p = dec.n_channels, dec.chspec.history_frames
    tail = np.asarray(ckpt.chan_tail)
    if isinstance(dec, WidebandMeshDecoder):
        if tail.shape != (n, halo):
            hint = ("a single-card wideband decoder's tail; resume it without -mesh"
                    if tail.shape == (n, hs) else "different -channels or message types?")
            raise _geometry("chan_tail", tail.shape, (n, halo), hint)
        # The pad_shift samples before the halo are read by no stencil.
        tail = np.concatenate([np.zeros((n, hs - halo), np.uint16), tail], axis=1)
    elif tail.shape != (n, hs):
        hint = ("a wideband-mesh decoder's tail: resume it with -channels and -mesh"
                if tail.shape == (n, halo) else "different -channels or message types?")
        raise _geometry("chan_tail", tail.shape, (n, hs), hint)
    if len(ckpt.chan_last_block) != n or len(ckpt.chan_prev_digests) != n:
        raise ValueError(
            f"checkpoint geometry mismatch: {len(ckpt.chan_last_block)} channel "
            f"states, decoder has {n} channels"
        )
    hist = np.asarray(ckpt.wb_hist)
    if hist.shape != (2, n, p):
        raise ValueError(
            f"checkpoint geometry mismatch: channelizer history has {hist.shape}, "
            f"decoder wants {(2, n, p)} (different taps_per_branch?)"
        )
    dec.load_state({
        "wb_hist": hist,
        "chan_tail": tail,
        "first": ckpt.first,
        "window_index": ckpt.window_index,
        # The per-channel carry is unused on the wideband path (the tails
        # live in chan_tail); next is rebuilt at every block start.
        "channels": [
            {"carry": np.zeros(hs, np.uint16), "first": ckpt.first,
             "window_index": ckpt.window_index, "last_block": last,
             "dedup_prev": prev, "dedup_next": ()}
            for last, prev in zip(ckpt.chan_last_block, ckpt.chan_prev_digests)
        ],
        "xchan_seen": ckpt.xchan_seen,
    })
