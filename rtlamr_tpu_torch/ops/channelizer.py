"""Wideband polyphase channelizer — frequency-channel parallelism.

Port of the JAX package's ``ops/channelizer.py``. The reference tunes ONE
~2.4 MS/s slab of the 902-928 MHz ISM band (misc/modes.go:14-16: ERT
channel width 196,568 Hz); this module splits a wideband IQ stream sampled
at ``n_channels x (32768 * chip_length)`` into ``n_channels``
critically-sampled complex basebands, each exactly the sample rate the
decode program expects, so every slab of the band feeds the same window
program.

Design (classic analysis DFT filter bank):

- A windowed-sinc prototype lowpass ``h`` of length ``taps_per_branch * N``
  (unity DC gain) is decomposed into N polyphase branches.
- Branch signals ``y_b[m] = sum_p h[pN+b] * x[mN - pN - b]``.
- Channels are the N-point DFT across the branch axis:
  ``x_c[m] = sum_b e^{+j 2 pi c b / N} y_b[m]`` (derivation in
  :func:`channelize`).
- Requantization maps each channel back to the rtl-sdr u8 convention (DC
  offset 127.5, decode.go:212), packed as the staged u16 elements the
  decode program reads.

Rounding contract: every product and every sum is rounded to float32 on its
own, in the reference's order (taps ascending in p; branches ascending in b
with the +er then -ei term), so the CUDA kernel of
``ops/channelizer_fused.py`` can match this module bit for bit. No fused
multiply-add, ``addcmul``, ``matmul``, ``einsum`` or FFT is used here: each
would round differently. The taps and the mix coefficients are float32
values made in numpy (a float64 tap times a float32 array is a float32
product in the JAX reference, which runs without x64).

Streaming: the filter needs ``taps_per_branch`` frames of history; callers
carry that tail between chunks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: Largest supported filter-bank size (the JAX package's bound: the DFT mix
#: is an explicit chain of N^2 rounded multiply-adds per frame).
MAX_CHANNELS = 32


@dataclass(frozen=True)
class ChannelizerSpec:
    """Static configuration of the analysis filter bank."""

    n_channels: int
    #: prototype filter taps per polyphase branch (filter length / N).
    taps_per_branch: int = 8
    #: lowpass cutoff as a multiple of the channel Nyquist 1/(2N); >1 trades
    #: adjacent-channel rejection for sharper OOK chip edges.
    cutoff_scale: float = 1.0

    def __post_init__(self):
        if not 1 <= self.n_channels <= MAX_CHANNELS:
            raise ValueError(
                f"n_channels={self.n_channels} outside [1, {MAX_CHANNELS}] "
                "(the explicit DFT mix grows O(N^2) per frame; see "
                "ops/channelizer.MAX_CHANNELS)"
            )

    @property
    def length(self) -> int:
        return self.taps_per_branch * self.n_channels

    @property
    def history_frames(self) -> int:
        """Frames of history a streaming caller must carry
        (``taps_per_branch`` frames = one prototype-filter length)."""
        return self.taps_per_branch

    @property
    def history(self) -> int:
        """History in wideband samples (= length, for documentation)."""
        return self.length


def history_len(spec: ChannelizerSpec) -> int:
    return spec.history


@functools.lru_cache(maxsize=None)
def prototype_lowpass(spec: ChannelizerSpec) -> np.ndarray:
    """Hamming-windowed sinc, cutoff ``cutoff_scale/(2N)``, unity DC gain."""
    n = spec.length
    cutoff = spec.cutoff_scale / (2 * spec.n_channels)
    t = np.arange(n) - (n - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.hamming(n)
    h /= h.sum()
    h.flags.writeable = False
    return h


@functools.lru_cache(maxsize=None)
def _polyphase_taps(spec: ChannelizerSpec) -> np.ndarray:
    """h2[p, b] = h[p*N + b] — the per-branch tap matrix (float64)."""
    h = prototype_lowpass(spec)
    out = h.reshape(spec.taps_per_branch, spec.n_channels).copy()
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def _mix_matrix(spec: ChannelizerSpec):
    """E[c, b] = exp(+j 2 pi c b / N) as separate (re, im) f32 matrices."""
    n = spec.n_channels
    c = np.arange(n)[:, None]
    b = np.arange(n)[None, :]
    ang = 2 * np.pi * c * b / n
    re = np.cos(ang).astype(np.float32)
    im = np.sin(ang).astype(np.float32)
    re.flags.writeable = False
    im.flags.writeable = False
    return re, im


def taps_f32(spec: ChannelizerSpec) -> np.ndarray:
    """(P, N) float32 taps: the values the reference multiplies by."""
    return np.ascontiguousarray(_polyphase_taps(spec), dtype=np.float32)


def iq_bytes_to_planes_u16(spec: ChannelizerSpec, iq: torch.Tensor) -> torch.Tensor:
    """Interleaved wideband IQ -> (N, F) u16 position-major planes.

    ``iq`` is either the u16 view of the interleaved bytes (one element per
    (I, Q) pair, I in the low byte) or the u8 bytes themselves."""
    n = spec.n_channels
    if iq.dtype == torch.uint16:
        return iq.reshape(-1, n).T
    z = iq.reshape(-1, 2 * n).T.to(torch.int32)  # (2N, F)
    return (z[0::2] | (z[1::2] << 8)).to(torch.uint16)


def planes_u16_to_frames(spec: ChannelizerSpec, planes: torch.Tensor) -> torch.Tensor:
    """(N, F) u16 packed planes -> (2, N, F) f32 DC-removed frames (exact:
    plane values are u8-derived integers)."""
    v = planes.to(torch.int32)
    re = (v & 255).to(torch.float32) - 127.5
    im = (v >> 8).to(torch.float32) - 127.5
    return torch.stack([re, im], dim=0)


def iq_bytes_to_frames(spec: ChannelizerSpec, iq: torch.Tensor) -> torch.Tensor:
    """Interleaved wideband IQ -> (2, N, F) f32 position-major frames:
    frames[s, j, m] = component s of wideband sample m*N + j, DC removed."""
    return planes_u16_to_frames(spec, iq_bytes_to_planes_u16(spec, iq))


def ri_to_frames(spec: ChannelizerSpec, ri: torch.Tensor) -> torch.Tensor:
    """(2, T) f32 re/im sample planes -> (2, N, F) position-major frames
    (test/synthesis helper; T must be a whole number of frames)."""
    return ri.reshape(2, -1, spec.n_channels).permute(0, 2, 1)


def polyphase_branches(
    spec: ChannelizerSpec, hist: torch.Tensor, frames: torch.Tensor
) -> torch.Tensor:
    """Branch signals y[b, m] = sum_p h[pN+b] * x[mN - pN - b].

    ``frames`` is (2, N, F) position-major, ``hist`` is (2, N, P), the
    previous chunk's last ``history_frames`` frames (zeros at the stream
    head). Returns (2, N, F) f32.

    With x[kN + j] = frames[., j, k], branch b reads plane j_b = (N - b) mod
    N, delayed one frame for b >= 1. ``series`` holds, in row b, plane j_b
    shifted so that every branch reads its tap p at the same offset; each
    tap is then one rounded product and one rounded sum for all branches
    at once, taps ascending (the reference's order, element for element).
    """
    n = spec.n_channels
    p_taps = spec.taps_per_branch
    f = frames.shape[2]
    assert hist.shape[2] == p_taps, "history must be taps_per_branch frames"
    full = torch.cat([hist, frames], dim=2)  # (2, N, P+F); frame k at P+k
    rows = [full[:, 0:1, 1:]]  # b = 0: plane 0, no delay
    if n > 1:
        delayed = list(range(n - 1, 0, -1))  # b = 1..N-1 -> plane N-b
        rows.append(full[:, delayed, :-1])
    series = torch.cat(rows, dim=1)  # (2, N, P+F-1)
    h2 = torch.from_numpy(taps_f32(spec)).to(frames.device)[:, None, :, None]
    acc = torch.zeros((2, n, f), dtype=torch.float32, device=frames.device)
    for p in range(p_taps):
        lo = p_taps - 1 - p
        acc = acc + h2[p] * series[:, :, lo : lo + f]
    return acc


def mix_channels(
    spec: ChannelizerSpec,
    y: torch.Tensor,
    channel_start: int = 0,
    channel_count: Optional[int] = None,
) -> torch.Tensor:
    """x_c[m] = sum_b y[b, m] e^{+j 2 pi c b / N} for a channel block.

    ``y`` is (2, N, F) f32 from :func:`polyphase_branches`; returns
    (2, C_blk, F) f32 re/im planes. Each output row depends only on its own
    coefficients, so a block of rows equals the same rows of the full mix.
    Branches ascend; per branch the +er term is added before the -ei term
    (the reference's order).
    """
    n = spec.n_channels
    if channel_count is None:
        channel_count = n
    er_np, ei_np = _mix_matrix(spec)
    rows = slice(channel_start, channel_start + channel_count)
    er = torch.from_numpy(np.array(er_np[rows])).to(y.device)
    ei = torch.from_numpy(np.array(ei_np[rows])).to(y.device)
    yr, yi = y[0], y[1]  # (N, F)
    f_len = yr.shape[1]
    cr = torch.zeros((er.shape[0], f_len), dtype=torch.float32, device=y.device)
    ci = torch.zeros_like(cr)
    for b in range(n):
        cr = (cr + er[:, b : b + 1] * yr[b]) - ei[:, b : b + 1] * yi[b]
        ci = (ci + er[:, b : b + 1] * yi[b]) + ei[:, b : b + 1] * yr[b]
    return torch.stack([cr, ci], dim=0)


def channelize(
    spec: ChannelizerSpec, hist: torch.Tensor, frames: torch.Tensor
) -> torch.Tensor:
    """Split a wideband stream chunk into N critically-sampled channels.

    ``hist`` is (2, N, history_frames) f32, the previous chunk's last frames
    (zeros at the stream head); ``frames`` is (2, N, F) f32 position-major.
    Returns (2, N, F) f32: channel c frame m is the lowpass-decimated
    mix-down ``sum_k h[k] x[mN - k] e^{-j 2 pi c (mN - k) / N}``, i.e.
    channel c is centered ``c/N`` of the wideband rate above the capture
    center (aliased: c > N/2 lands below; see :func:`channel_offsets_hz`).

    Derivation: with k = pN + b, ``e^{-j2pi c(mN-k)/N} = e^{+j2pi c b/N}``
    (the mN and pN terms vanish mod N), so
    ``x_c[m] = sum_b e^{j2pi cb/N} y_b[m]``, a DFT across the branch axis.
    """
    return mix_channels(spec, polyphase_branches(spec, hist, frames))


def requantize_u16(channels: torch.Tensor) -> torch.Tensor:
    """(2, C, F) re/im channels -> (C, F) staged u16 (I low, Q high byte):
    clip(round-half-even(v + 127.5), 0, 255) per component."""
    i = torch.clamp(torch.round(channels[0] + 127.5), 0, 255).to(torch.int32)
    q = torch.clamp(torch.round(channels[1] + 127.5), 0, 255).to(torch.int32)
    return (i | (q << 8)).to(torch.uint16)


def requantize_u8(channels: torch.Tensor) -> torch.Tensor:
    """(2, C, F) channels -> (C, 2F) u8 interleaved IQ (for oracle replay)."""
    v = requantize_u16(channels).to(torch.int32)
    return torch.stack([v & 0xFF, v >> 8], dim=-1).reshape(v.shape[0], -1).to(torch.uint8)


def channel_offsets_hz(spec: ChannelizerSpec, channel_rate: int) -> np.ndarray:
    """Per-channel center-frequency offset from the wideband capture center:
    offsets[c] = ((c + N/2) mod N - N/2) * channel_rate."""
    n = spec.n_channels
    c = np.arange(n)
    return (((c + n // 2) % n) - n // 2) * channel_rate
