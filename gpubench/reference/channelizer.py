"""The wideband polyphase channelizer (K2's function) in plain NumPy, from
raw stream bytes.

A wideband stream of N channels is sampled at N times the channel rate;
frame m is wideband samples ``m N .. m N + N - 1``. The analysis filter
bank is the receiver's definition of it:

- the prototype low-pass ``h``: a Hamming-windowed sinc of ``taps N``
  coefficients (``taps`` = 8 a branch), cutoff ``1 / (2 N)``, scaled to
  unity gain at DC, made in float64 and multiplied as float32;
- branch b of frame m: ``y_b[m] = sum_p h[p N + b] x[m N - p N - b]``, each
  product and each sum rounded to float32 on its own, p ascending from a
  zero accumulator;
- the DFT mix across the branches: for b ascending,
  ``cr = (cr + er[c, b] yr_b) - ei[c, b] yi_b`` and
  ``ci = (ci + er[c, b] yi_b) + ei[c, b] yr_b``, with
  ``er + j ei = exp(+2 pi j c b / N)`` as float32 tables; channel c is
  centred ``c / N`` of the wideband rate above the stream's centre (c past
  N / 2 lands below: ``((c + N / 2) mod N - N / 2)`` channel rates);
- the requantize back to u8 IQ: ``clip(round_half_even(v + 127.5), 0,
  255)`` a component, packed as u16 (I in the low byte);
- the carried history: a frame reads the ``taps`` frames before it; at the
  stream head they read as 0.0 (the DC-removed zero), not as bytes.

Input samples are DC-removed exactly (``byte - 127.5``). The branch sums
and the mix are computed in blocks of frames that fit a core's cache; every
value is the same operations on the same operands, so the blocks change no
byte. ``mix="bfloat16"`` rounds the mix's tables, operands, products and
sums to bfloat16 instead: the precision step below float32 that a faster
mix would tempt, and the control that the comparison has to reject.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

#: prototype taps a polyphase branch
TAPS = 8
#: frames a block of the computation takes (a few hundred KiB of float32
#: a plane at N = 12)
BLOCK_FRAMES = 4096


@functools.lru_cache(maxsize=None)
def prototype_lowpass(n: int, taps: int = TAPS) -> np.ndarray:
    """The float64 prototype of ``taps * n`` coefficients."""
    length = taps * n
    cutoff = 1.0 / (2 * n)
    t = np.arange(length) - (length - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.hamming(length)
    h /= h.sum()
    h.flags.writeable = False
    return h


@functools.lru_cache(maxsize=None)
def branch_taps(n: int, taps: int = TAPS) -> np.ndarray:
    """(taps, n) float32: ``[p, b] = h[p n + b]``."""
    out = prototype_lowpass(n, taps).reshape(taps, n).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def mix_tables(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(er, ei), each (n, n) float32: ``exp(+2 pi j c b / n)`` at [c, b]."""
    c = np.arange(n)[:, None]
    b = np.arange(n)[None, :]
    ang = 2 * np.pi * c * b / n
    er, ei = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    er.flags.writeable = False
    ei.flags.writeable = False
    return er, ei


def channel_offsets(n: int) -> np.ndarray:
    """Each channel's centre from the stream's centre, in channel rates."""
    c = np.arange(n)
    return ((c + n // 2) % n) - n // 2


def bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), as
    float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return r.view(np.float32)


def _planes(u16: np.ndarray, n: int) -> np.ndarray:
    """(F n,) u16 wideband samples -> (2, n, F) float32, DC removed."""
    v = np.asarray(u16, np.uint16).reshape(-1, n).T
    re = (v & 255).astype(np.float32) - np.float32(127.5)
    im = (v >> 8).astype(np.float32) - np.float32(127.5)
    return np.stack([re, im])


def _mix(er, ei, yr, yi, low: bool):
    """(cr, ci) of the mix; each product and sum is one float32 rounding
    (numpy fuses nothing), or with ``low`` one bfloat16 rounding too."""
    n = yr.shape[0]
    cr = np.zeros((n, yr.shape[1]), np.float32)
    ci = np.zeros_like(cr)
    if low:
        er, ei, yr, yi = bfloat16(er), bfloat16(ei), bfloat16(yr), bfloat16(yi)
        r = bfloat16
        for b in range(n):
            cr = r(r(cr + r(er[:, b : b + 1] * yr[b])) - r(ei[:, b : b + 1] * yi[b]))
            ci = r(r(ci + r(er[:, b : b + 1] * yi[b])) + r(ei[:, b : b + 1] * yr[b]))
        return cr, ci
    t = np.empty_like(cr)
    for b in range(n):
        a, s = er[:, b : b + 1], ei[:, b : b + 1]
        np.add(cr, np.multiply(a, yr[b], out=t), out=cr)
        np.subtract(cr, np.multiply(s, yi[b], out=t), out=cr)
        np.add(ci, np.multiply(a, yi[b], out=t), out=ci)
        np.add(ci, np.multiply(s, yr[b], out=t), out=ci)
    return cr, ci


def channelize(n: int, wide_u16: np.ndarray, history_u16: Optional[np.ndarray],
               mix: str = "float32", taps: int = TAPS) -> np.ndarray:
    """(n, F) u16 channel samples of F wideband frames.

    ``wide_u16`` is the (F n,) u16 view of the frames' interleaved bytes;
    ``history_u16`` the (taps n,) u16 samples of the ``taps`` frames before
    them, or None at the stream head (history 0.0)."""
    if mix not in ("float32", "bfloat16"):
        raise ValueError(f"mix {mix!r}: want float32 or bfloat16")
    frames = _planes(wide_u16, n)
    f = frames.shape[2]
    if history_u16 is None:
        hist = np.zeros((2, n, taps), np.float32)
    else:
        hist = _planes(history_u16, n)
        assert hist.shape[2] == taps, "history must be taps frames"
    full = np.concatenate([hist, frames], axis=2)  # frame k at taps + k
    h2 = branch_taps(n, taps)[:, None, :, None]
    er, ei = mix_tables(n)
    # Branch b reads plane (n - b) mod n, a frame late for b >= 1.
    planes = [0] + list(range(n - 1, 0, -1))
    delay = np.array([0] + [1] * (n - 1))
    out = np.empty((n, f), np.uint16)
    for m0 in range(0, f, BLOCK_FRAMES):
        m1 = min(m0 + BLOCK_FRAMES, f)
        # series[:, b, k]: plane of b at frame m0 - taps + 1 + k (delayed)
        sub = full[:, :, m0 : m1 + taps]
        series = np.stack([sub[:, planes[b], 1 - delay[b] : sub.shape[2] - delay[b]]
                           for b in range(n)], axis=1)
        acc = np.zeros((2, n, m1 - m0), np.float32)
        for p in range(taps):
            lo = taps - 1 - p
            acc = acc + h2[p] * series[:, :, lo : lo + m1 - m0]
        cr, ci = _mix(er, ei, acc[0], acc[1], mix == "bfloat16")
        i = np.clip(np.rint(cr + np.float32(127.5)), 0, 255).astype(np.uint16)
        q = np.clip(np.rint(ci + np.float32(127.5)), 0, 255).astype(np.uint16)
        out[:, m0:m1] = i | (q << np.uint16(8))
    return out


def channelize_span(n: int, samples_u16, f0: int, f1: int, mix: str = "float32") -> np.ndarray:
    """(n, f1 - f0) u16 channel samples of frames ``[f0, f1)`` of a stream
    whose wideband samples ``[lo, hi)`` ``samples_u16(lo, hi)`` returns;
    frames before the stream's first read as 0.0 history (a span starting
    at a negative frame has zero samples there, as a receiver's zeroed
    window halo does)."""
    out = np.zeros((n, f1 - f0), np.uint16)
    a = max(f0, 0)
    if f1 <= a:
        return out
    # Within ``TAPS`` frames of the head the history is partly 0.0: start there.
    start = 0 if a < TAPS else a
    hist = None if start == 0 else samples_u16((start - TAPS) * n, start * n)
    rows = channelize(n, samples_u16(start * n, f1 * n), hist, mix)
    out[:, a - f0 :] = rows[:, a - start :]
    return out
