"""The fused channelizer: wideband u16 chunk -> (N, F) staged u16 channels.

A launch may write a block of the channel rows only, ``channel_start`` to
``channel_start + channel_count`` (the wideband mesh's channel shards, each
mixing its own rows): the same bytes as those rows of the full launch.

:func:`channelize_requantize_fused` is the entry point. On a CUDA tensor it
launches the hand-written kernel ``csrc/channelizer.cu`` (or raises); on a
CPU tensor it runs :func:`channelize_requantize_plain`, the same function in
plain PyTorch: ``requantize_u16(mix_channels(spec, polyphase_branches(spec,
hist, frames), c0, rows))`` of ``ops/channelizer.py``.

Inputs keep the stream where it lies, frame-major: ``wb`` is the u16 view of
F wideband frames (element m*N + j is frame m of plane j, one interleaved
(I, Q) byte pair, I in the low byte), and ``hist`` the previous chunk's last
``taps_per_branch`` frames in the same layout. At the stream head
(``first``) the history reads as 0.0, the DC-removed zero the JAX package's
jnp chain starts from. (The JAX Pallas path packs that zero history to u16
as round(127.5) = 128, which reads back as +0.5, so its first
``taps_per_branch`` frames differ slightly from the jnp reference; the port
follows the jnp reference.)
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .build import Library, load
from .channelizer import (
    MAX_CHANNELS,
    ChannelizerSpec,
    mix_channels,
    planes_u16_to_frames,
    polyphase_branches,
    requantize_u16,
    taps_f32,
)
from .channelizer_mix import channel_block, mix_header


def _frames_of(spec: ChannelizerSpec, u16: torch.Tensor) -> torch.Tensor:
    """Frame-major u16 elements -> (2, N, F) f32 DC-removed frames."""
    return planes_u16_to_frames(spec, u16.reshape(-1, spec.n_channels).T)


def channelize_requantize_plain(
    spec: ChannelizerSpec, hist: torch.Tensor, wb: torch.Tensor, first: bool,
    channel_start: int = 0, channel_count: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch K2: (F*N,) u16 chunk and (P*N,) u16 history -> (C, F)
    u16 samples of the channels ``[channel_start, channel_start + C)`` (C =
    ``channel_count``, all N by default)."""
    c0, rows = channel_block(spec.n_channels, channel_start, channel_count)
    frames = _frames_of(spec, wb)
    if first:
        n, p = spec.n_channels, spec.history_frames
        hist_f = torch.zeros((2, n, p), dtype=torch.float32, device=wb.device)
    else:
        hist_f = _frames_of(spec, hist)
    return requantize_u16(mix_channels(spec, polyphase_branches(spec, hist_f, frames), c0, rows))


#: the kernel's CTA size and the taps count it compiles in (csrc/channelizer.cu)
THREADS = 256
FIXED_TAPS = 8


@dataclass(frozen=True)
class ChannelizerPlan:
    """How ``csrc/channelizer.cu`` cuts F frames of N channels with P taps.

    CTA ``g`` of ``tiles`` owns output frames ``[g * tile, (g + 1) * tile)``
    and stages the span of frames ``[g * tile - P, (g + 1) * tile)`` clipped
    to F (stream elements ``[(g * tile - P) N, min((g + 1) * tile, F) N)``,
    the negative ones from the history) into shared memory; its thread t
    owns frames ``g * tile + per_thread * t + u``, u < per_thread. Span frame
    s of plane j lies at float2 ``j * per_thread * sub + (s % per_thread) *
    sub + s // per_thread``."""

    per_thread: int
    tile: int
    tiles: int
    sub: int
    smem_bytes: int
    fixed_taps: bool


def frames_per_thread(n: int) -> int:
    """Frames a thread of the kernel owns at N channels (its registers hold
    2 N of accumulators for each)."""
    return 2 if n <= 20 else 1


def channelizer_plan(n: int, p: int, frames: int) -> ChannelizerPlan:
    t = frames_per_thread(n)
    tile = THREADS * t
    sub = THREADS + -(-p // t)
    return ChannelizerPlan(t, tile, -(-frames // tile), sub, n * t * sub * 8, p == FIXED_TAPS)


class _Args(ctypes.Structure):
    """``ChannelizeArgs`` of csrc/channelizer.cu."""

    _fields_ = [
        ("frames", ctypes.c_longlong),
        ("out_stride", ctypes.c_longlong),
        ("n", ctypes.c_int),
        ("p", ctypes.c_int),
        ("first", ctypes.c_int),
        ("per_thread", ctypes.c_int),
        ("tile", ctypes.c_int),
        ("vec_in", ctypes.c_int),
        ("vec_out", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("taps", ctypes.c_float * (FIXED_TAPS * MAX_CHANNELS)),
    ]


@functools.lru_cache(maxsize=None)
def _tables(spec: ChannelizerSpec, device: torch.device) -> Tuple[_Args, torch.Tensor]:
    """What a launch of ``spec`` takes besides its tensors, made once per
    spec: the argument block, with the taps in it when P is the compiled-in
    count (the kernel reads them as constants; the DFT mix is compiled in,
    ops/channelizer_mix.py), and the (P, N) float32 taps on ``device`` for
    the runtime tap loop."""
    n, p = spec.n_channels, spec.history_frames
    taps = np.array(taps_f32(spec), np.float32)
    plan = channelizer_plan(n, p, 1)
    args = _Args(n=n, p=p, per_thread=plan.per_thread, tile=plan.tile)
    if plan.fixed_taps:
        args.taps[: p * n] = taps.ravel().tolist()
    return args, torch.from_numpy(taps).to(device)


def kernel_library(n: int, fixed_taps: bool, c0: int = 0, rows: Optional[int] = None) -> Library:
    """The library of ``channelize_kernel<n, rows, P>``, P = FIXED_TAPS
    with the taps compiled in or 0 for the runtime tap loop, with the mix of
    the channel rows ``[c0, c0 + rows)`` of ``n`` (all of them by default)
    as its generated header; built on first use, one ``nvcc``. The full
    block is ``channelizer.n<n>p<P>``, a part ``channelizer.n<n>c<c0>x<rows>p<P>``."""
    taps = FIXED_TAPS if fixed_taps else 0
    c0, rows = channel_block(n, c0, rows)
    flags = (f"-DRTLAMR_K2_N={n}", f"-DRTLAMR_K2_P={taps}")
    name = f"channelizer.n{n}p{taps}"
    if rows != n:
        flags += (f"-DRTLAMR_K2_C0={c0}", f"-DRTLAMR_K2_ROWS={rows}")
        name = f"channelizer.n{n}c{c0}x{rows}p{taps}"
    return Library(name, flags, ("channelizer_mix.cuh", mix_header(n, c0, rows)))


@functools.lru_cache(maxsize=None)
def _launch_fn(n: int, fixed_taps: bool, c0: int, rows: int):
    fn = load(kernel_library(n, fixed_taps, c0, rows)).rtlamr_channelize
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.POINTER(_Args), vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(spec: ChannelizerSpec, hist: torch.Tensor, wb: torch.Tensor, first: bool,
            out: torch.Tensor, fixed_taps: bool, c0: int = 0) -> None:
    """One launch on checked CUDA tensors, with the taps compiled in
    (``fixed_taps``, P = FIXED_TAPS only) or through the runtime tap loop,
    writing the ``out.shape[0]`` channel rows from ``c0``."""
    dev = wb.device
    rows = out.shape[0]
    fn = _launch_fn(spec.n_channels, fixed_taps, c0, rows)
    template, taps = _tables(spec, dev)
    args = _Args.from_buffer_copy(template)
    args.frames, args.out_stride, args.first = out.shape[1], out.stride(0), int(bool(first))
    args.rows = rows
    with torch.cuda.device(dev):
        rc = fn(
            wb.data_ptr(),
            hist.data_ptr(),
            out.data_ptr(),
            taps.data_ptr(),
            ctypes.byref(args),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"channelizer: CUDA error {rc} at launch")


def channelize_requantize_fused(
    spec: ChannelizerSpec,
    hist: torch.Tensor,
    wb: torch.Tensor,
    first: bool,
    out: Optional[torch.Tensor] = None,
    channel_start: int = 0,
    channel_count: Optional[int] = None,
) -> torch.Tensor:
    """K2 over a (F*N,) u16 chunk; returns the (C, F) u16 channels
    ``[channel_start, channel_start + C)``, C = ``channel_count`` (all N by
    default).

    ``out``, when given, is a (C, F) u16 view with unit column stride (for
    example the staged batch's columns behind each channel's halo); the
    result is written there and ``out`` is returned. A CPU tensor goes to
    :func:`channelize_requantize_plain`. A CUDA tensor launches the CUDA
    kernel on the current stream and counts the launch in
    ``channelize_requantize_fused.launches``; a build or launch failure, or
    a shape, type, device or layout the kernel does not take, raises.
    """
    n, p = spec.n_channels, spec.history_frames
    c0, rows = channel_block(n, channel_start, channel_count)
    if wb.dim() != 1 or wb.shape[0] % n:
        raise ValueError(f"channelizer: want a 1-D chunk of whole frames of {n}, got {tuple(wb.shape)}")
    frames = wb.shape[0] // n
    if out is not None and (
        tuple(out.shape) != (rows, frames) or out.dtype != torch.uint16 or out.stride(1) != 1
    ):
        raise ValueError(
            f"channelizer: out must be ({rows}, {frames}) uint16 with unit column "
            f"stride, got {tuple(out.shape)} {out.dtype} strides {out.stride()}"
        )
    if wb.device.type == "cpu":
        res = channelize_requantize_plain(spec, hist, wb, first, c0, rows)
        if out is None:
            return res
        out.copy_(res)
        return out
    if wb.device.type != "cuda":
        raise ValueError(f"channelizer: unsupported device {wb.device}")
    if wb.dtype != torch.uint16 or hist.dtype != torch.uint16:
        raise ValueError(f"channelizer: want uint16 chunk and history, got {wb.dtype}, {hist.dtype}")
    if not (wb.is_contiguous() and hist.is_contiguous()) or hist.shape != (p * n,):
        raise ValueError(
            f"channelizer: want contiguous ({frames * n},) chunk and ({p * n},) history, "
            f"got {tuple(wb.shape)}, {tuple(hist.shape)}"
        )
    dev = wb.device
    if hist.device != dev or (out is not None and out.device != dev):
        raise ValueError("channelizer: chunk, history and out must be on one device")
    if out is None:
        out = torch.empty((rows, frames), dtype=torch.uint16, device=dev)
    _launch(spec, hist, wb, first, out, fixed_taps=p == FIXED_TAPS, c0=c0)
    channelize_requantize_fused.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
channelize_requantize_fused.launches = 0
