"""Stream-position checkpoint / resume for long offline captures.

Port of the JAX package's ``decoder/checkpoint.py``. The reference keeps no
decoder state worth checkpointing (SURVEY.md §5.4); its decode state is at
most BufferLength samples of history. So a resume point is the byte offset
of the next window, the window and block counters, the carried samples and
the dedup digest sets; restoring it continues the decode bit-identically.
This module holds the files and the refusals; each decoder builds its own
kind (its ``checkpoint`` method) and restores it (``restore``). The kinds:

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


def require_boundary(pending_bytes: int, in_flight: bool) -> None:
    """Refuse a checkpoint off a window boundary: with ``pending_bytes``
    fed since the last whole window, or a window ``in_flight``."""
    if pending_bytes:
        raise ValueError(
            f"checkpoint only at window boundaries: {pending_bytes} pending bytes"
        )
    if in_flight:
        raise ValueError(
            "checkpoint with an undrained window in flight; call drain() "
            "and emit its messages first"
        )


def require_kind(ckpt, kind: type, dec) -> None:
    """Refuse a checkpoint that is no ``kind``, the kind ``dec`` writes."""
    if not isinstance(ckpt, kind):
        raise ValueError(f"checkpoint kind mismatch: {type(ckpt).__name__} cannot "
                         f"restore a {type(dec).__name__}")


def check_window(saved: Optional[int], window: int) -> None:
    """Refuse a checkpoint saved at another window (``saved`` None: a file
    without it)."""
    if saved is not None and saved != window:
        raise ValueError(f"checkpoint geometry mismatch: saved at a window of {saved} "
                         f"samples, decoder has {window} (different -windowblocks?)")


def geometry_mismatch(what: str, got, want, hint: str) -> ValueError:
    """The refusal of a carry of shape ``got`` where ``want`` is needed."""
    return ValueError(
        f"checkpoint geometry mismatch: {what} has {got}, decoder wants {want} ({hint})"
    )


def capture_checkpoint(dec, byte_offset: int):
    """Snapshot a decoder at a window boundary (no pending bytes, nothing
    in flight); ``byte_offset`` is the capture bytes it has consumed (for a
    multi-host decoder, the global stream's). The decoder builds its own
    kind (its ``checkpoint``)."""
    return dec.checkpoint(byte_offset)


def restore_checkpoint(dec, ckpt) -> None:
    """Restore a decoder to a checkpoint; decode continues bit-identically.
    The decoder (its ``restore``) refuses a checkpoint of another kind,
    geometry or topology."""
    dec.restore(ckpt)
