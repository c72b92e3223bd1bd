"""The load generator's process: an rtl_tcp server on ``127.0.0.1`` at a
port the OS assigns, which feeds the receiver on its own clock and never
waits for it beyond what the socket imposes.

Each connection gets the 12-byte greeting; the client's 5-byte commands are
read and recorded between sends. The first connection (the warm-up) gets
its stream as fast as the socket takes it; the second gets one reference
block at a time on an absolute schedule: block k is sent at
``t0 + (k + 1) * block_seconds``, when a dongle would have its last sample,
whatever the receiver does. Each send's lateness against its due time is
recorded and reported.

It runs in a process of its own (``multiprocessing``, spawn), which imports
neither the receiver nor torch. CLOCK_MONOTONIC (``time.monotonic``) is
shared with the harness's process. A one-channel stream is handed to it as
an array (pickled into the process); a wideband one, a GiB or more, as
:class:`SharedBytes`, which the process maps without a copy.
"""

from __future__ import annotations

import mmap
import os
import socket
import struct
import time
from typing import List, Optional

import numpy as np

#: rtl_tcp greeting: magic, tuner type (R820T) and its gain count
GREETING = b"RTL0" + struct.pack(">II", 5, 29)
#: the paced stream's first block is due this long after the accept
START_DELAY_S = 0.2
#: the feeder sleeps until this long before a send is due, then spins
SPIN_S = 0.0015


class SharedBytes:
    """Bytes that the harness and the feeder map alike: an anonymous memory
    file (``memfd_create``), so nothing is written to disk or left at a
    path. ``SharedBytes(size)`` makes it; an argument of a spawned process,
    it arrives there as a map of the same memory (its descriptor is handed
    over while the process is spawned). ``array`` is its u8 view; the
    memory goes with the last view of it and the last process."""

    def __init__(self, size: int, fd: Optional[int] = None):
        self.size = size
        if fd is None:
            fd = os.memfd_create("gpubench-stream")
            os.ftruncate(fd, size)
        self.fd = fd
        self.array = np.frombuffer(mmap.mmap(fd, size), np.uint8)

    def __reduce__(self):
        from multiprocessing import reduction

        return _attach, (reduction.DupFd(self.fd), self.size)

    def __del__(self, _close=os.close):
        _close(self.fd)


def _attach(dup, size: int) -> SharedBytes:
    return SharedBytes(size, dup.detach())


def _u8(data) -> np.ndarray:
    return data.array if isinstance(data, SharedBytes) else np.ascontiguousarray(data)


def schedule(n_blocks: int, t0: float, block_seconds: float) -> np.ndarray:
    """Due times of blocks ``0 .. n_blocks - 1`` of a paced stream."""
    return t0 + (np.arange(n_blocks, dtype=np.float64) + 1.0) * block_seconds


def lateness_report(late_s: np.ndarray, own_s: np.ndarray, block_seconds: float) -> dict:
    """The paced sends' lateness against their due times, in ms: all of it
    (worst, 99th percentile), and the feeder's own, leaving out the time a
    previous send was held up by the receiver's back-pressure (that is the
    receiver's doing, and its latency keeps it)."""
    late_ms = np.asarray(late_s, np.float64) * 1e3
    own_ms = np.asarray(own_s, np.float64) * 1e3
    block_ms = block_seconds * 1e3
    if late_ms.size == 0:
        late_ms = own_ms = np.zeros(1)
    return {
        "blocks": int(late_ms.size),
        "late_ms_max": float(late_ms.max()),
        "late_ms_p99": float(np.percentile(late_ms, 99)),
        "own_late_ms_max": float(own_ms.max()),
        "own_late_over_one_block": int((own_ms > block_ms).sum()),
        "own_late_over_1ms": int((own_ms > 1.0).sum()),
        "held_over_one_block": int(((late_ms - own_ms) > block_ms).sum()),
        "block_ms": block_ms,
    }


def _commands(conn: socket.socket, seen: List[tuple], pending: bytearray) -> bool:
    """Read what the client sent without blocking; record each whole 5-byte
    command. False once the client has closed."""
    conn.setblocking(False)
    try:
        while True:
            data = conn.recv(1 << 16)
            if not data:
                return False
            pending.extend(data)
    except (BlockingIOError, InterruptedError):
        pass
    finally:
        conn.setblocking(True)
    while len(pending) >= 5:
        seen.append(struct.unpack(">BI", bytes(pending[:5])))
        del pending[:5]
    return True


def rtl_tcp_feeder(ctl, warm, stream, block_bytes: int, block_seconds: float,
                   warm_blocks: Optional[int] = None) -> None:
    """Open loop. ``warm`` and ``stream`` are arrays or :class:`SharedBytes`;
    the warm-up connection gets at most ``warm_blocks`` blocks of ``warm``
    (all of it by default). Reports on ``ctl``: ``("port", port)``; after
    the timed connection's accept ``("t0", t0, accept_time)``; at the end
    ``("done", report)``. A ``"stop"`` from the harness ends the paced
    stream early (a traced run, once its profile is taken)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    srv.settimeout(600)
    ctl.send(("port", srv.getsockname()[1]))
    report = {}
    try:
        for paced, data in ((False, warm), (True, stream)):
            conn, _ = srv.accept()
            accepted = time.monotonic()
            with conn:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.sendall(GREETING)
                seen: List[tuple] = []
                pending = bytearray()
                view = memoryview(_u8(data)).cast("B")
                n_blocks = len(view) // block_bytes
                if not paced and warm_blocks is not None:
                    n_blocks = min(n_blocks, warm_blocks)
                if not paced:
                    conn.sendall(view[: n_blocks * block_bytes])
                else:
                    t0 = accepted + START_DELAY_S
                    ctl.send(("t0", t0, accepted))
                    due = schedule(n_blocks, t0, block_seconds)
                    late = np.zeros(n_blocks)
                    own = np.zeros(n_blocks)
                    sent_until = 0.0
                    for k in range(n_blocks):
                        wait = due[k] - time.monotonic()
                        if wait > SPIN_S:
                            time.sleep(wait - SPIN_S)
                        while time.monotonic() < due[k]:
                            pass
                        start = time.monotonic()
                        late[k] = start - due[k]
                        # Late on its own account, not for a send that the
                        # receiver's back-pressure held up.
                        own[k] = start - max(due[k], sent_until)
                        conn.sendall(view[k * block_bytes : (k + 1) * block_bytes])
                        sent_until = time.monotonic()
                        if k % 64 == 0:
                            _commands(conn, seen, pending)
                            if ctl.poll() and ctl.recv() == "stop":
                                late, own = late[: k + 1], own[: k + 1]
                                break
                    report = lateness_report(late, own, block_seconds)
                    report["own_late_s"] = own.tolist()
                    report["t0"] = t0
                    report["accepted"] = accepted
                conn.shutdown(socket.SHUT_WR)
                deadline = time.monotonic() + 120
                while _commands(conn, seen, pending) and time.monotonic() < deadline:
                    time.sleep(0.01)
                if paced:
                    report["commands"] = seen
    except OSError as e:
        report["error"] = f"{type(e).__name__}: {e}"
    finally:
        srv.close()
        ctl.send(("done", report))
