"""The card's peaks and the work of K1, counted from the problem.

The roofline share of ``metrics/k1_roofline.py`` divides this bound by the
kernel's device time. The counts are of the work the function needs on the window's
shapes and data, whatever kernel computes it, so a change to the program
cannot move them: bytes read and written once at the HBM rate against
operations at the card's issue rate, the larger of the two. Copied from the
receiver's ``chip_smoke.py`` (``stencil_work``, ``card_rate``), which also
documents each count.
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
