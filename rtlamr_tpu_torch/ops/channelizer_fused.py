"""The fused channelizer: wideband u16 chunk -> (N, F) staged u16 channels.

:func:`channelize_requantize_fused` is the entry point. On a CUDA tensor it
launches the hand-written kernel ``csrc/channelizer.cu`` (or raises); on a
CPU tensor it runs :func:`channelize_requantize_plain`, the same function in
plain PyTorch: ``requantize_u16(channelize(spec, hist, frames))`` of
``ops/channelizer.py``.

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
from typing import Optional, Tuple

import numpy as np
import torch

from .channelizer import (
    ChannelizerSpec,
    _mix_matrix,
    channelize,
    planes_u16_to_frames,
    requantize_u16,
    taps_f32,
)


def _frames_of(spec: ChannelizerSpec, u16: torch.Tensor) -> torch.Tensor:
    """Frame-major u16 elements -> (2, N, F) f32 DC-removed frames."""
    return planes_u16_to_frames(spec, u16.reshape(-1, spec.n_channels).T)


def channelize_requantize_plain(
    spec: ChannelizerSpec, hist: torch.Tensor, wb: torch.Tensor, first: bool
) -> torch.Tensor:
    """Plain PyTorch K2: (F*N,) u16 chunk and (P*N,) u16 history -> (N, F)
    u16 channel samples."""
    frames = _frames_of(spec, wb)
    if first:
        n, p = spec.n_channels, spec.history_frames
        hist_f = torch.zeros((2, n, p), dtype=torch.float32, device=wb.device)
    else:
        hist_f = _frames_of(spec, hist)
    return requantize_u16(channelize(spec, hist_f, frames))


@functools.lru_cache(maxsize=None)
def _tables(spec: ChannelizerSpec, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The float32 (taps, er, ei) tables of ``spec`` on ``device``."""
    er, ei = _mix_matrix(spec)
    return tuple(
        torch.from_numpy(np.array(a, np.float32)).to(device) for a in (taps_f32(spec), er, ei)
    )


def _launch_fn():
    from .build import load

    fn = load("channelizer").rtlamr_channelize
    if fn.argtypes is None:
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 6 + [ci, ci, cll, cll, ci, vp]
        fn.restype = ci
    return fn


def channelize_requantize_fused(
    spec: ChannelizerSpec,
    hist: torch.Tensor,
    wb: torch.Tensor,
    first: bool,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2 over a (F*N,) u16 chunk; returns the (N, F) u16 channels.

    ``out``, when given, is an (N, F) u16 view with unit column stride (for
    example the staged batch's columns behind each channel's halo); the
    result is written there and ``out`` is returned. A CPU tensor goes to
    :func:`channelize_requantize_plain`. A CUDA tensor launches the CUDA
    kernel on the current stream and counts the launch in
    ``channelize_requantize_fused.launches``; a build or launch failure, or
    a shape, type, device or layout the kernel does not take, raises.
    """
    n, p = spec.n_channels, spec.history_frames
    if wb.dim() != 1 or wb.shape[0] % n:
        raise ValueError(f"channelizer: want a 1-D chunk of whole frames of {n}, got {tuple(wb.shape)}")
    frames = wb.shape[0] // n
    if out is not None and (
        tuple(out.shape) != (n, frames) or out.dtype != torch.uint16 or out.stride(1) != 1
    ):
        raise ValueError(
            f"channelizer: out must be ({n}, {frames}) uint16 with unit column "
            f"stride, got {tuple(out.shape)} {out.dtype} strides {out.stride()}"
        )
    if wb.device.type == "cpu":
        res = channelize_requantize_plain(spec, hist, wb, first)
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
        out = torch.empty((n, frames), dtype=torch.uint16, device=dev)
    fn = _launch_fn()
    taps, er, ei = _tables(spec, dev)
    with torch.cuda.device(dev):
        rc = fn(
            wb.data_ptr(),
            hist.data_ptr(),
            out.data_ptr(),
            taps.data_ptr(),
            er.data_ptr(),
            ei.data_ptr(),
            n,
            p,
            frames,
            out.stride(0),
            int(bool(first)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"channelizer: CUDA error {rc} at launch")
    channelize_requantize_fused.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
channelize_requantize_fused.launches = 0
