"""The fused decode stencil: staged u16 window -> (bits, q6, mask2d).

:func:`decode_stencil` is the entry point. On a CUDA tensor it launches the
hand-written kernel ``csrc/decode_stencil.cu`` (or raises); on a CPU tensor
it runs :func:`stencil_plain`, the same function in plain PyTorch. Outputs
keep the JAX package's layout (``ops/frontend.frontend_stage_staged``):

- bits: (lp,) u8, the window's slice of the padded Manchester bit stream;
- q6: (lq,) u8 R900 6-ary stream on the same index convention, or None
  when no group wants R900 symbols;
- mask2d: (window/128, 128) u8, bit g set where preamble group g matches.

:func:`lookahead_mask` is the preamble bank alone over the positions past
the window whose bits K1 wrote (the window program's look-ahead): a second
kernel of the same library, or :func:`masks_plain` on the CPU.

Exact integer arithmetic: the squared magnitude ``(255-2I)^2 + (255-2Q)^2``
is an integer (reference protocol/decode.go:209-225), and every matched
filter output is a difference of prefix sums. The plain version takes the
prefix sum in int64, which cannot wrap, so it gives the same bits as the
JAX package's int32 wrap-around argument without relying on it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .spec import LANES, FrontendSpec, lookahead_geometry, staged_geometry

StencilOut = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def stencil_plain(spec: FrontendSpec, staged: torch.Tensor, first: bool) -> StencilOut:
    """Plain PyTorch stencil over a (staged_samples,) u16 buffer."""
    cl = spec.chip_length
    sl = spec.symbol_length
    pl = spec.packet_length
    ps = spec.pad_shift
    geo = staged_geometry(spec)
    lp, lq = geo.lp, geo.lq
    n = staged.shape[0]
    assert ps + sl + lp <= n and ps + sl + 4 * cl + lq <= n

    # torch has no shifts or adds on uint16: widen first.
    v = staged.to(torch.int32)
    di = 255 - 2 * (v & 255)
    dq = 255 - 2 * (v >> 8)
    mag = di * di + dq * dq
    if first:  # the reference's history buffers start zeroed (decode.go:144)
        mag[: spec.halo_staged] = 0
    cs = torch.zeros(n + 1, dtype=torch.int64, device=staged.device)
    cs[1:] = torch.cumsum(mag, 0, dtype=torch.int64)

    # Manchester matched filter + 1-bit quantize (decode.go:229-245).
    f = 2 * cs[ps + cl : ps + cl + lp] - cs[ps : ps + lp] - cs[ps + sl : ps + sl + lp]
    bits = (f >= 0).to(torch.uint8)
    if first:  # the initial PacketLength zero bits of the stream
        bits[:pl] = 0

    q6 = None
    if spec.wants_r900:
        # R900 4-ary filter bank + 6-ary quantize (r900/r900.go:96-149).
        c = [cs[ps + sl + i * cl : ps + sl + i * cl + lq] for i in range(5)]
        a = torch.stack(
            [
                2 * c[2] - c[4] - c[0],  # 1100
                2 * c[1] - 2 * c[2] + 2 * c[3] - c[4] - c[0],  # 1010
                2 * c[1] - 2 * c[3] + c[4] - c[0],  # 1001
            ]
        )
        arg = torch.argmax(a.abs(), dim=0)  # first max == the strict-> chain
        chosen = torch.gather(a, 0, arg[None, :])[0]
        q6 = (arg + torch.where(chosen > 0, 3, 0)).to(torch.uint8)
    return bits, q6, masks_plain(spec, bits)


def masks_plain(spec: FrontendSpec, bits: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Preamble correlation bank (decode.go:255-348): mask bit g at q is set
    iff every preamble bit of group g matches ``bits`` at stride
    SymbolLength from q, for the first ``n`` positions (the window's when
    None), as (n / 128, 128)."""
    sl = spec.symbol_length
    w = spec.window if n is None else n
    mask = torch.zeros(w, dtype=torch.uint8, device=bits.device)
    for g, group in enumerate(spec.groups):
        assert (len(group.bits) - 1) * sl + w <= bits.shape[0]
        acc = torch.ones(w, dtype=torch.bool, device=bits.device)
        for k, bit in enumerate(group.bits):
            acc &= bits[k * sl : k * sl + w] == bit
        mask |= acc.to(torch.uint8) << g
    return mask.reshape(w // LANES, LANES)


#: Positions a CTA of the kernel handles per step of its strip; equal to
#: SUB_TILE in ``csrc/decode_stencil.cu``, which refuses any other value.
SUB_TILE = 4096
#: CTAs the kernel keeps resident per SM (its ``__launch_bounds__``).
CTAS_PER_SM = 2
#: Threads a CTA (THREADS in the .cu): bounds what one step can carry over.
THREADS = 512


class StencilPlan(NamedTuple):
    """How the kernel cuts one window into persistent strips.

    Strip k owns output positions ``[k * strip_len, (k + 1) * strip_len)``
    (cut at each output's length) and walks them in ``n_steps`` sub-tiles
    of ``sub_tile`` staged samples, starting at staged sample
    ``k * strip_len + pad_shift - shift`` (16-byte aligned). Step t has the
    samples ``[t * sub_tile, (t + 1) * sub_tile)`` of the strip and emits
    bits and q6 ``d_bits``, and mask ``d_mask``, positions behind them, so
    what a position reads has arrived by then; ``d_mask`` is the strip's
    halo. Step t keeps the prefix sums of its samples and of the
    ``lookback`` samples before them, and ``bit_words`` packed words of
    bits from position ``t * sub_tile - d_mask`` on; it hands the last
    ``lookback`` sums and ``(d_mask - d_bits) / 32`` words to step t + 1.
    """

    sub_tile: int
    n_strips: int
    strip_len: int  # multiple of 32: strips start on whole bit words
    n_steps: int
    shift: int  # pad_shift % 8: local sample of output position 0
    d_bits: int  # multiple of 32
    d_mask: int  # multiple of 32
    lookback: int  # multiple of 8
    bit_words: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def stencil_plan(spec: FrontendSpec, n_sm: int) -> StencilPlan:
    """The kernel's launch plan for ``spec`` on a card with ``n_sm`` SMs:
    CTAS_PER_SM strips per SM, fewer when the window is short."""
    geo = staged_geometry(spec)
    cl, sl, t = spec.chip_length, spec.symbol_length, SUB_TILE
    shift = spec.pad_shift % 8
    # The deepest sample a bit (SL) or R900 symbol (SL + 4 CL) reads.
    d_bits = _round_up(sl + (4 * cl if spec.wants_r900 else 0) + shift, 32)
    d_mask = d_bits + _round_up(geo.pre_reach, 32)
    # Prefix sums a step reads before its own samples: P[j] = I[j - 1].
    lookback = _round_up(d_bits - shift + 1, 8)
    if lookback > 4 * THREADS or (d_mask - d_bits) // 32 > THREADS:
        raise ValueError("decode_stencil: symbol or preamble too long for the kernel")
    # One strip per resident CTA, but at least one step's worth: a short
    # window gets fewer strips than the card has SMs.
    strip_len = max(_round_up(-(-geo.lp // (CTAS_PER_SM * n_sm)), 32), (t - d_mask) // 32 * 32)
    return StencilPlan(
        sub_tile=t,
        n_strips=-(-geo.lp // strip_len),
        strip_len=strip_len,
        n_steps=-(-(strip_len + d_mask) // t),
        shift=shift,
        d_bits=d_bits,
        d_mask=d_mask,
        lookback=lookback,
        bit_words=(d_mask - d_bits) // 32 + t // 32 + 1,
    )


def _launch_fn():
    from .build import load

    fn = load("decode_stencil").rtlamr_decode_stencil
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, vp, vp]
        fn.restype = ci
    return fn


class _Args(ctypes.Structure):
    """The kernel's scalar arguments (``StencilArgs`` in the .cu)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_staged", "lp", "lq", "window", "cl", "sl", "ps", "halo_staged",
        "packet_length", "sub_tile", "n_strips", "strip_len", "n_steps",
        "shift", "d_bits", "d_mask", "lookback", "bit_words", "n_groups",
        "max_len",
    )] + [("pre_len", ctypes.c_int * 8), ("pre_bits", ctypes.c_ulonglong * 8),
          ("order", ctypes.c_int * 8)]


@functools.lru_cache(maxsize=None)
def _args(spec: FrontendSpec, n_sm: int) -> _Args:
    geo = staged_geometry(spec)
    plan = stencil_plan(spec, n_sm)
    # Longest group first; order[g] is the mask bit of the g-th longest.
    order = sorted(range(len(spec.groups)), key=lambda g: -len(spec.groups[g].bits))
    groups = [spec.groups[g].bits for g in order]
    return _Args(
        geo.staged_samples, geo.lp, geo.lq, spec.window, spec.chip_length,
        spec.symbol_length, spec.pad_shift, spec.halo_staged,
        spec.packet_length, plan.sub_tile, plan.n_strips, plan.strip_len,
        plan.n_steps, plan.shift, plan.d_bits, plan.d_mask,
        plan.lookback, plan.bit_words, len(groups), len(groups[0]),
        (ctypes.c_int * 8)(*[len(b) for b in groups]),
        (ctypes.c_ulonglong * 8)(*[sum(x << k for k, x in enumerate(b)) for b in groups]),
        (ctypes.c_int * 8)(*order),
    )


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_stencil(spec: FrontendSpec, staged: torch.Tensor, first: bool) -> StencilOut:
    """The decode stencil over a (staged_samples,) u16 buffer.

    A CPU tensor goes to :func:`stencil_plain`. A CUDA tensor launches the
    CUDA kernel on the current stream and counts the launch in
    ``decode_stencil.launches``; a build or launch failure raises.
    """
    if staged.device.type == "cpu":
        return stencil_plain(spec, staged, first)
    if staged.device.type != "cuda":
        raise ValueError(f"decode_stencil: unsupported device {staged.device}")
    geo = staged_geometry(spec)
    if staged.dtype != torch.uint16 or staged.dim() != 1:
        raise ValueError(f"decode_stencil: want 1-D uint16, got {staged.dtype} {tuple(staged.shape)}")
    if staged.shape[0] != geo.staged_samples or not staged.is_contiguous():
        raise ValueError(
            f"decode_stencil: want {geo.staged_samples} contiguous samples, "
            f"got {staged.shape[0]} (contiguous={staged.is_contiguous()})"
        )
    if staged.data_ptr() % 16:
        raise ValueError("decode_stencil: the staged buffer must be 16-byte aligned")
    if len(spec.groups) > 8 or any(len(g.bits) > 64 for g in spec.groups):
        raise ValueError("decode_stencil: at most 8 groups of at most 64 preamble bits")
    dev = staged.device
    args = _args(spec, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    # Fresh allocations: the caching allocator aligns them to 512 bytes, as
    # the kernel's 16-byte stores need.
    bits = torch.empty(geo.lp, dtype=torch.uint8, device=dev)
    q6 = torch.empty(geo.lq, dtype=torch.uint8, device=dev) if spec.wants_r900 else None
    mask = torch.empty(spec.window, dtype=torch.uint8, device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        rc = fn(
            staged.data_ptr(),
            bits.data_ptr(),
            q6.data_ptr() if q6 is not None else None,
            mask.data_ptr(),
            int(bool(first)),
            ctypes.byref(args),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_stencil: CUDA error {rc} at launch")
    decode_stencil.launches += 1
    return bits, q6, mask.reshape(spec.window // LANES, LANES)


#: kernel launches since the last reset (plain-version calls do not count)
decode_stencil.launches = 0


def _mask_fn():
    from .build import load

    fn = load("decode_stencil").rtlamr_lookahead_mask
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, vp]
        fn.restype = ci
    return fn


def lookahead_mask(spec: FrontendSpec, bits: torch.Tensor) -> torch.Tensor:
    """The preamble mask of the look-ahead's positions ``[window, window +
    extent)`` (:func:`~.spec.lookahead_geometry`) from a window's bits (K1's
    output), as (extent / 128, 128) u8 with K1's mask bits.

    A CPU tensor goes to :func:`masks_plain` over the bits from ``window``
    on. A CUDA tensor launches the bank kernel of K1's library on the
    current stream, counted in ``lookahead_mask.launches`` (not in
    ``decode_stencil.launches``); a launch failure raises."""
    n = lookahead_geometry(spec).extent
    if n <= 0:
        raise ValueError("lookahead_mask: the spec has no look-ahead")
    if bits.device.type == "cpu":
        return masks_plain(spec, bits[spec.window:], n)
    geo = staged_geometry(spec)
    if bits.dtype != torch.uint8 or bits.shape != (geo.lp,) or not bits.is_contiguous():
        raise ValueError(f"lookahead_mask: want {geo.lp} contiguous u8 bits, "
                         f"got {bits.dtype} {tuple(bits.shape)}")
    dev = bits.device
    args = _args(spec, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    mask = torch.empty(n, dtype=torch.uint8, device=dev)
    fn = _mask_fn()
    with torch.cuda.device(dev):
        rc = fn(bits.data_ptr(), mask.data_ptr(), spec.window, n, ctypes.byref(args),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lookahead_mask: CUDA error {rc} at launch")
    lookahead_mask.launches += 1
    return mask.reshape(n // LANES, LANES)


#: kernel launches since the last reset, a CUDA graph's replays included
#: (ops/frontend.SearchGraph; plain-version calls do not count)
lookahead_mask.launches = 0
