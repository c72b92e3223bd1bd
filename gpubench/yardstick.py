"""The card's peaks and the work of K1 and K2, counted from the problem.

A roofline share (``metrics/k1_roofline.py``) divides such a bound by the
kernel's device time. The counts are of the work the function needs on the
timed shapes and data, whatever kernel computes it, so a change to the
program cannot move them: bytes read and written once at the HBM rate
against operations at the card's issue rate, the larger of the two. Copied
from the receiver's ``chip_smoke.py`` (``stencil_work``,
``channelizer_work``, ``card_rate``), which also documents each count; the
channelizer's mix is counted here from the reference's own tables.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np

#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer add, compare, logic, shift and multiply-add results per
#: clock per SM on Hopper (16 INT32 lanes in each of 4 partitions; CUDA C++
#: Programming Guide, throughput table, compute capability 9.0).
INT32_PER_CLOCK_PER_SM = 64
#: float32 add and multiply instructions per clock per SM on Hopper (32
#: FP32 lanes in each of 4 partitions, the same table), the SM's whole issue
#: width. The channelizer may fuse nothing, so each product and sum is one
#: such instruction, not half of a data-sheet FMA.
FP32_INSTR_PER_CLOCK_PER_SM = 128
#: Row width and tile cap of the receiver's staged window buffer
#: (``ops/spec.py`` LANES, and the tile_rows rule of make_frontend_spec).
LANES = 128
TILE_ROWS_MAX = 512


def card_clock(index: int = 0) -> Dict[str, float]:
    """{"sms", "clock_max_mhz"} of card ``index``: its SM count (torch) and
    the maximum SM clock that nvidia-smi reports."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"sms": torch.cuda.get_device_properties(index).multi_processor_count,
            "clock_max_mhz": float(mhz)}


def card_rate(per_clock_per_sm: int, clock: Dict[str, float]) -> float:
    """``per_clock_per_sm`` x SMs x the maximum SM clock: a rate a second."""
    return per_clock_per_sm * clock["sms"] * clock["clock_max_mhz"] * 1e6


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def staged_samples(geo) -> int:
    """Length of the receiver's staged u16 window buffer for a
    ``reference.stencil.WindowGeometry`` (the ``ops/spec.py``
    ``staged_geometry`` arithmetic): the halo and the window, and the tail
    that the TPU tile layout it keeps for equality reads past them."""
    sl, cl, w = geo.symbol_length, geo.chip_length, geo.window
    lp = geo.lp
    tile_rows = min(TILE_ROWS_MAX, _round_up(-(-(w + geo.packet_length) // LANES), 8))
    pre_reach = (max(len(g) for g in geo.groups) - 1) * sl
    r_out = min(tile_rows, _round_up(-(-lp // LANES), 8))
    n_tiles = -(-lp // (r_out * LANES))
    r_bits = r_out + -(-pre_reach // LANES) + 1
    need = max(r_bits * LANES + sl + geo.pad_shift, r_out * LANES + sl + 4 * cl + geo.pad_shift)
    r_in = _round_up(-(-need // LANES) + 1, 8)
    rows = max((n_tiles - 1) * r_out + r_in, -(-(geo.halo_staged + w) // LANES))
    return _round_up(rows, 8) * LANES


def stencil_work(geo, live_words, int_rate: float) -> dict:
    """K1's work on one window: the staged buffer read once and bits, q6 and
    mask written once; 32-bit integer operations in the cheapest form of
    each part: 2 a sample read (magnitude and running sum), 3 a bit, 19 an
    R900 symbol, and for the preamble bank one funnel shift a word and
    symbol while some group is alive in the word, and one xor-and for each
    group still alive (``live_words``: ``reference.stencil.live_words`` of
    the window's bits)."""
    r900 = geo.wants_r900
    n_bytes = 2 * staged_samples(geo) + geo.lp + (geo.lq if r900 else 0) + geo.window
    max_len = max(len(g) for g in geo.groups)
    n_words = live_words[0].shape[1]
    any_alive = np.zeros((max_len, n_words), bool)
    xor_ands = 0
    for live in live_words:
        xor_ands += int(live.sum())
        any_alive[: live.shape[0]] |= live
    bank = xor_ands + int(any_alive.sum())
    n_read = geo.lp + geo.symbol_length + (4 * geo.chip_length if r900 else 0)
    ops = 2 * n_read + 3 * geo.lp + bank + (19 * geo.lq if r900 else 0)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return {"bytes": n_bytes, "int_ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def mix_op_count(n: int):
    """(products, sums) a frame of the DFT mix of ``n`` channels in its
    cheapest exact form, from the float32 tables: for each branch two
    products (of its re and im input) for each distinct coefficient
    magnitude, none for 1 and nothing for 0; one sum for each nonzero
    coefficient's two accumulations, less the 2 n copies that start the
    accumulators (branch 0's coefficients are all 1 and 0)."""
    from .reference.channelizer import mix_tables

    er, ei = mix_tables(n)
    products = sums = 0
    for b in range(n):
        mags = {abs(float(v)) for v in np.concatenate([er[:, b], ei[:, b]])} - {0.0, 1.0}
        products += 2 * len(mags)
        sums += 2 * (np.count_nonzero(er[:, b]) + np.count_nonzero(ei[:, b]))
    return products, sums - 2 * n


def channelizer_work(n: int, taps: int, frames: int, rate: float = 0.0) -> dict:
    """K2's work on ``frames`` frames of ``n`` channels with ``taps`` taps a
    branch: the chunk and the history read once and the n channel rows
    written once (u16 a sample); float32 instructions, none fused, each
    part in its cheapest exact form: 4 n taps - 2 n a frame for the
    branches (a product and a sum a tap and component, each chain started
    by its first product), 6 n for the DC removal, 9 n for the requantize,
    and the mix of :func:`mix_op_count`. With ``rate`` (instructions a
    second), the bound: the larger of the bytes' time at the HBM rate and
    the instructions' time, in ms."""
    muls, adds = mix_op_count(n)
    n_bytes = 4 * n * frames + 2 * n * taps
    instr = frames * (4 * n * taps - 2 * n + 6 * n + 9 * n + muls + adds)
    out = {"bytes": n_bytes, "f32_instr": instr}
    if rate:
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_instr = instr / rate * 1e3
        out.update(bytes_ms=t_bytes, f32_instr_ms=t_instr, bound_ms=max(t_bytes, t_instr),
                   bound_by="bytes" if t_bytes >= t_instr else "operations")
    return out
