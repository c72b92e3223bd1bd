"""Native (C++) sample transport, bound with ctypes.

Port of the JAX package's ``native`` module. The reference's L1 transport is
the rtl_tcp client inside its Receiver (main.go:49-57, 156-205): a blocking
TCP reader feeding the decoder through a channel. Here it is a C++ shared
library (``src/ingest.cpp``, a copy of the JAX package's): a reader thread
drains the socket into a ring buffer without holding the GIL, Python pulls
whole reads or whole staged windows out of it, and a memory-mapped reader
serves capture files.

The library is built with g++ on first use into ``rtlamr_tpu_torch/_build/``
under a name keyed by a hash of the source and the flags (nothing is written
beside the source). :func:`available` says whether it built and
:func:`load_error` why not; the CLI's ``-ingest=auto`` then takes the Python
transport, ``-ingest=native`` exits.

``read_staged`` writes the decode-ready StagedGeometry layout
(``ops/spec.py``) straight from the ring or the mapped file into a numpy u16
array or a contiguous CPU ``torch.uint16`` tensor, pinned or not, so a
window reaches :meth:`~rtlamr_tpu_torch.decoder.WindowDecoder.process_host_staged`
with no host copy in between.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..io.capture import IQSource
from ..io.rtltcp import (
    CMD_SET_AGC_MODE,
    CMD_SET_BIAS_TEE,
    CMD_SET_DIRECT_SAMPLING,
    CMD_SET_FREQ,
    CMD_SET_FREQ_CORRECTION,
    CMD_SET_GAIN,
    CMD_SET_GAIN_BY_INDEX,
    CMD_SET_GAIN_MODE,
    CMD_SET_OFFSET_TUNING,
    CMD_SET_SAMPLE_RATE,
    DongleInfo,
)
from ..ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "ingest.cpp")
GXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-pthread")

#: a numpy u16 array or a CPU torch.uint16 tensor (pinned or not)
U16Buffer = Union[np.ndarray, torch.Tensor]

_lib: Optional[ctypes.CDLL] = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    with open(SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return str(BUILD_DIR / f"ingest-{key}.so")


def _build(target: str) -> Optional[str]:
    """Compile src/ingest.cpp into ``target``; an error string or None.

    g++ writes a per-pid temporary that ``os.replace`` moves into place, so
    two processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(tmp, target)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.rtlamr_ingest_connect.restype = c.c_int64
    lib.rtlamr_ingest_connect.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int64,
        c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
    ]
    lib.rtlamr_ingest_command.restype = c.c_int
    lib.rtlamr_ingest_command.argtypes = [c.c_int64, c.c_uint8, c.c_uint32]
    lib.rtlamr_ingest_read.restype = c.c_int64
    lib.rtlamr_ingest_read.argtypes = [
        c.c_int64, c.c_void_p, c.c_int64, c.c_int, c.POINTER(c.c_int),
    ]
    # staged and carry are u16 buffers passed by address
    lib.rtlamr_ingest_read_staged.restype = c.c_int64
    lib.rtlamr_ingest_read_staged.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int,
        c.POINTER(c.c_int),
    ]
    lib.rtlamr_file_read_staged.restype = c.c_int64
    lib.rtlamr_file_read_staged.argtypes = [
        c.c_int64, c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
    ]
    lib.rtlamr_ingest_stats.restype = c.c_int
    lib.rtlamr_ingest_stats.argtypes = [
        c.c_int64, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
        c.POINTER(c.c_uint64),
    ]
    lib.rtlamr_ingest_close.restype = c.c_int
    lib.rtlamr_ingest_close.argtypes = [c.c_int64]
    lib.rtlamr_file_open.restype = c.c_int64
    lib.rtlamr_file_open.argtypes = [c.c_char_p, c.POINTER(c.c_int64)]
    lib.rtlamr_file_read.restype = c.c_int64
    lib.rtlamr_file_read.argtypes = [c.c_int64, c.c_void_p, c.c_int64]
    lib.rtlamr_file_seek.restype = c.c_int
    lib.rtlamr_file_seek.argtypes = [c.c_int64, c.c_int64]
    lib.rtlamr_file_close.restype = c.c_int
    lib.rtlamr_file_close.argtypes = [c.c_int64]


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at first use; None when it does not build
    (:func:`load_error` says why)."""
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        target = library_path()
        if not os.path.exists(target):
            _lib_err = _build(target)
            if _lib_err is not None:
                return None
        try:
            lib = ctypes.CDLL(target)
            _bind(lib)
        except OSError as e:
            _lib_err = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def load_error() -> Optional[str]:
    load()
    return _lib_err


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise OSError(f"native ingest unavailable: {_lib_err}")
    return lib


def _u16_address(buf: U16Buffer, name: str) -> Tuple[int, int]:
    """(address, elements) of a writable contiguous 1-D u16 host buffer;
    raises on anything else."""
    if isinstance(buf, torch.Tensor):
        if buf.dtype != torch.uint16:
            raise TypeError(f"{name}: want torch.uint16, got {buf.dtype}")
        if buf.device.type != "cpu":
            raise ValueError(f"{name}: want a CPU tensor (pinned or not), got {buf.device}")
        if buf.dim() != 1 or not buf.is_contiguous():
            raise ValueError(f"{name}: want a contiguous 1-D tensor, got {tuple(buf.shape)}")
        return buf.data_ptr(), buf.numel()
    if isinstance(buf, np.ndarray):
        if buf.dtype != np.uint16:
            raise TypeError(f"{name}: want uint16, got {buf.dtype}")
        if buf.ndim != 1 or not buf.flags.c_contiguous or not buf.flags.writeable:
            raise ValueError(f"{name}: want a writable contiguous 1-D array, got {buf.shape}")
        return buf.ctypes.data, buf.size
    raise TypeError(f"{name}: want a numpy uint16 array or a torch.uint16 tensor, "
                    f"got {type(buf).__name__}")


def _staged_args(staged: U16Buffer, carry: U16Buffer, window: int) -> Tuple[int, int, int]:
    """(staged address, carry address, halo_staged) after checking that
    ``staged`` holds the carry and a window."""
    s_ptr, s_len = _u16_address(staged, "staged")
    c_ptr, hs = _u16_address(carry, "carry")
    if window <= 0 or s_len < hs + window:
        raise ValueError(f"read_staged: staged has {s_len} samples, carry {hs} + "
                         f"window {window} need more")
    return s_ptr, c_ptr, hs


class NativeRtlTcpClient:
    """rtl_tcp client backed by the native reader thread and ring buffer.

    Same surface as :class:`rtlamr_tpu_torch.io.rtltcp.RtlTcpClient`, so
    ``RtlTcpSource`` reads either (selected by the -ingest flag), plus
    :meth:`read_staged` and :meth:`stats` (what ``dropped_bytes`` reads).
    """

    #: default ring: ~27 s of IQ at the default 2.36 MS/s rate, deep enough
    #: that a multi-second stall of the decoder drops no live samples
    RING_BYTES = 128 << 20

    def __init__(self, server: str = "127.0.0.1:1234", ring_bytes: int = 0):
        host, _, port = server.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.ring_bytes = ring_bytes or self.RING_BYTES
        self._h: Optional[int] = None
        self.info: Optional[DongleInfo] = None

    def connect(self, timeout: float = 10.0) -> DongleInfo:
        lib = _require()
        tt = ctypes.c_uint32(0)
        gc = ctypes.c_uint32(0)
        h = lib.rtlamr_ingest_connect(
            self.host.encode(), self.port, int(timeout * 1000), self.ring_bytes,
            ctypes.byref(tt), ctypes.byref(gc),
        )
        if h < 0:
            raise IOError(f"rtl_tcp connect failed (native err {h})")
        self._h = h
        self.info = DongleInfo(b"RTL0", tt.value, gc.value)
        return self.info

    def close(self) -> None:
        if self._h is not None:
            _require().rtlamr_ingest_close(self._h)
            self._h = None

    def _handle(self) -> int:
        if self._h is None:
            raise IOError("rtl_tcp: not connected")
        return self._h

    # -- command channel -----------------------------------------------------

    def _command(self, cmd: int, arg: int) -> None:
        if _require().rtlamr_ingest_command(self._handle(), cmd, arg & 0xFFFFFFFF) != 0:
            raise IOError("rtl_tcp command send failed")

    def set_center_freq(self, hz: int) -> None:
        self._command(CMD_SET_FREQ, hz)

    def set_sample_rate(self, hz: int) -> None:
        self._command(CMD_SET_SAMPLE_RATE, hz)

    def set_gain_mode(self, manual: bool) -> None:
        # Reference semantics: SetGainMode(true) = auto (io/rtltcp.py).
        self._command(CMD_SET_GAIN_MODE, 0 if manual else 1)

    def set_tuner_gain(self, tenth_db: int) -> None:
        self._command(CMD_SET_GAIN, tenth_db)

    def set_freq_correction(self, ppm: int) -> None:
        self._command(CMD_SET_FREQ_CORRECTION, ppm)

    def set_agc_mode(self, on: bool) -> None:
        self._command(CMD_SET_AGC_MODE, 1 if on else 0)

    def set_gain_by_index(self, index: int) -> None:
        self._command(CMD_SET_GAIN_BY_INDEX, index)

    def set_direct_sampling(self, on: bool) -> None:
        self._command(CMD_SET_DIRECT_SAMPLING, 1 if on else 0)

    def set_offset_tuning(self, on: bool) -> None:
        self._command(CMD_SET_OFFSET_TUNING, 1 if on else 0)

    def set_bias_tee(self, on: bool) -> None:
        self._command(CMD_SET_BIAS_TEE, 1 if on else 0)

    # -- sample stream -------------------------------------------------------

    def read_samples(self, n_bytes: int, deadline: float = 5.0) -> np.ndarray:
        """Exactly ``n_bytes`` of u8 IQ within ``deadline`` seconds
        (main.go:168-186). Raises OSError on the deadline and EOFError when
        the connection closes first (a short tail at EOF is dropped, as the
        reference drops its partial final block, main.go:178-186)."""
        out = np.empty(n_bytes, np.uint8)
        timed_out = ctypes.c_int(0)
        got = _require().rtlamr_ingest_read(
            self._handle(), out.ctypes.data, n_bytes, int(deadline * 1000),
            ctypes.byref(timed_out),
        )
        if got < n_bytes:
            if timed_out.value:
                raise OSError("rtl_tcp read deadline exceeded")
            raise EOFError("rtl_tcp: connection closed")
        return out

    def read_staged(self, staged: U16Buffer, carry: U16Buffer, window: int,
                    deadline: float = 5.0) -> Tuple[int, bool]:
        """Fill a StagedGeometry u16 window buffer straight from the ring.

        ``staged`` is the (staged_samples,) u16 buffer, a numpy array or a
        CPU ``torch.uint16`` tensor (pinned or not), whose tail past
        ``len(carry) + window`` the caller keeps zeroed; ``carry`` is the
        (halo_staged,) u16 carry, updated in place on a full read. Returns
        (samples read, timed out); fewer than ``window`` samples means EOF
        or the deadline (the carry is then not updated, and the partial
        bytes sit at ``staged[len(carry):]``)."""
        s_ptr, c_ptr, hs = _staged_args(staged, carry, window)
        timed_out = ctypes.c_int(0)
        got = _require().rtlamr_ingest_read_staged(
            self._handle(), s_ptr, c_ptr, hs, window, int(deadline * 1000),
            ctypes.byref(timed_out),
        )
        if got < 0:
            raise IOError(f"rtl_tcp read_staged failed (native err {got})")
        return int(got), bool(timed_out.value)

    def stats(self) -> Tuple[int, int, int]:
        """(bytes received, bytes dropped, bytes buffered)."""
        t = ctypes.c_uint64(0)
        d = ctypes.c_uint64(0)
        b = ctypes.c_uint64(0)
        _require().rtlamr_ingest_stats(
            self._handle(), ctypes.byref(t), ctypes.byref(d), ctypes.byref(b)
        )
        return t.value, d.value, b.value


class NativeFileSource(IQSource):
    """mmap-backed capture file source (in place of ``io.capture.FileSource``)."""

    def __init__(self, path: str):
        lib = _require()
        size = ctypes.c_int64(0)
        h = lib.rtlamr_file_open(path.encode(), ctypes.byref(size))
        if h < 0:
            raise IOError(f"cannot open {path}")
        self._h: Optional[int] = h
        self.size = size.value
        self.path = path

    def _handle(self) -> int:
        if self._h is None:
            raise IOError(f"{self.path}: closed")
        return self._h

    def read(self, n_bytes: int) -> np.ndarray:
        out = np.empty(n_bytes, np.uint8)
        got = _require().rtlamr_file_read(self._handle(), out.ctypes.data, n_bytes)
        return out[: max(got, 0)]

    def read_staged(self, staged: U16Buffer, carry: U16Buffer, window: int) -> int:
        """Fill a StagedGeometry u16 window buffer from the mapped file: the
        contract of :meth:`NativeRtlTcpClient.read_staged` without the
        deadline. Returns samples read; fewer than ``window`` means the end
        of the capture."""
        s_ptr, c_ptr, hs = _staged_args(staged, carry, window)
        got = _require().rtlamr_file_read_staged(self._handle(), s_ptr, c_ptr, hs, window)
        if got < 0:
            raise IOError(f"{self.path}: read_staged failed (native err {got})")
        return int(got)

    def seek(self, pos: int) -> None:
        if _require().rtlamr_file_seek(self._handle(), pos) != 0:
            raise IOError(f"{self.path}: seek({pos}) failed")

    def close(self) -> None:
        if self._h is not None:
            _require().rtlamr_file_close(self._h)
            self._h = None
