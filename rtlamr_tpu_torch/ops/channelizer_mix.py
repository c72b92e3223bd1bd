"""The channelizer's DFT mix as a straight-line program, in its cheapest
exact form.

The mix of ``ops/channelizer.py`` :func:`mix_channels` runs, for every
channel c and branch b ascending, ``cr = (cr + er[c,b] yr_b) - ei[c,b] yi_b``
and ``ci = (ci + er[c,b] yi_b) + ei[c,b] yr_b``, each product and sum rounded
on its own. The float32 tables ``_mix_matrix`` hold many coefficients of one
branch that are equal in magnitude, and the same chain gives the same bytes
with fewer operations:

- ``(-a) y`` equals ``-(a y)`` exactly, and ``cr + (-q)`` equals ``cr - q``,
  so a branch needs one product ``a y`` for each distinct magnitude ``a``,
  shared by every coefficient of that magnitude;
- a coefficient of exactly 1 in magnitude needs no product;
- a coefficient of exactly 0 needs neither its product nor its add;
- the first accumulation of each accumulator, ``0 + y``, is a copy: branch
  0's coefficients are all 1 (er) and 0 (ei), so every accumulator starts as
  yr_0 or yi_0.

The last two change a result only where the reference gets a zero: ``0 + x``
is x but for a zero's sign (0 + -0 is +0), a product or sum of zeros is a
zero, and a nonzero operand hides it; the requantize cannot see a zero's
sign (q(+0) = q(-0)). The kernel drops each branch's ``0 +`` the same way.

:func:`mix_program` derives that program from the numpy tables;
:func:`emulate_mix` runs it in numpy float32 (each operation rounded on its
own, as the card does); :func:`mix_header` writes it as the C++ that the
CUDA kernel ``csrc/channelizer.cu`` compiles for one N, with the
coefficients as exact float literals.

Each takes a block of channel rows ``[c0, c0 + rows)`` (all N by default),
as the wideband mesh's channel shards mix only their own rows
(``parallel/wideband_mesh.py``; the JAX package's ``mix_channels(spec, y,
channel_start, channel_count)``). A block keeps the accumulations of its
channels in the full program's order, and the products they use, with the
accumulators numbered from 0 at ``c0``; every row is the same operations on
the same values as in the full program, so a block's bytes are those rows'
bytes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from .channelizer import MAX_CHANNELS, ChannelizerSpec, _mix_matrix

#: one accumulation: (accumulator "cr" | "ci", channel, "=" | "+" | "-",
#: operand), "=" being the copy that starts the accumulator; the operand is
#: "yr", "yi" (a coefficient of magnitude 1) or ("pr" | "pi", k): product k
#: of the branch times yr or yi.
Op = Tuple[str, int, str, object]


@dataclass(frozen=True)
class MixBranch:
    """The work of one branch b: its distinct product magnitudes, and the
    accumulations in the reference's order for each accumulator."""

    products: Tuple[float, ...]
    ops: Tuple[Op, ...]


def _term(value: float, mags: Dict[float, int], plane: str):
    """(sign, operand) of ``value * y<plane>``, or None when value is 0."""
    a = abs(float(value))
    if a == 0.0:
        return None
    sign = "-" if value < 0 else "+"
    if a == 1.0:
        return sign, "y" + plane
    k = mags.setdefault(a, len(mags))
    return sign, ("p" + plane, k)


def _flip(sign: str) -> str:
    return "-" if sign == "+" else "+"


def channel_block(n: int, c0: int = 0, rows: Optional[int] = None) -> Tuple[int, int]:
    """``(c0, rows)`` of a block of the ``n`` channel rows; ``rows`` None is
    every row from ``c0``. Raises on a block outside ``[0, n)``."""
    rows = n - c0 if rows is None else rows
    if not (0 <= c0 and 1 <= rows and c0 + rows <= n):
        raise ValueError(f"channel block [{c0}, {c0 + rows}) is not inside [0, {n})")
    return c0, rows


@functools.lru_cache(maxsize=None)
def mix_program(n: int, c0: int = 0, rows: Optional[int] = None) -> Tuple[MixBranch, ...]:
    """The mix of channels ``[c0, c0 + rows)`` of ``n`` (all by default) as
    one :class:`MixBranch` per branch, accumulators numbered ``c - c0``."""
    c0, rows = channel_block(n, c0, rows)
    er, ei = _mix_matrix(ChannelizerSpec(n_channels=n))
    out = []
    for b in range(n):
        mags: Dict[float, int] = {}
        ops = []
        for c in range(c0, c0 + rows):
            # cr = (cr + er yr) - ei yi
            t = _term(er[c, b], mags, "r")
            if t:
                ops.append(("cr", c - c0, t[0], t[1]))
            t = _term(ei[c, b], mags, "i")
            if t:
                ops.append(("cr", c - c0, _flip(t[0]), t[1]))
            # ci = (ci + er yi) + ei yr
            t = _term(er[c, b], mags, "i")
            if t:
                ops.append(("ci", c - c0, t[0], t[1]))
            t = _term(ei[c, b], mags, "r")
            if t:
                ops.append(("ci", c - c0, t[0], t[1]))
        if b == 0:
            # Branch 0's coefficients are er = 1, ei = 0 in every row: each
            # accumulator of the block starts with one copy of yr_0 or yi_0.
            assert sorted((name, c, sign, operand) for name, c, sign, operand in ops) == sorted(
                (name, c, "+", "y" + name[1]) for name in ("cr", "ci") for c in range(rows))
            ops = [(name, c, "=", operand) for name, c, _, operand in ops]
        products = tuple(sorted(mags, key=mags.get))
        out.append(MixBranch(products=products, ops=tuple(ops)))
    return tuple(out)


def mix_op_count(n: int, c0: int = 0, rows: Optional[int] = None) -> Tuple[int, int]:
    """(products, sums) a frame of the cheapest exact mix of channels
    ``[c0, c0 + rows)`` of ``n``: two products (times yr and yi) for each
    distinct magnitude of a branch, one sum for each accumulation but the
    copies that start them."""
    prog = mix_program(n, c0, rows)
    return (sum(2 * len(br.products) for br in prog),
            sum(sign != "=" for br in prog for _, _, sign, _ in br.ops))


def emulate_mix(n: int, yr: np.ndarray, yi: np.ndarray, c0: int = 0,
                rows: Optional[int] = None) -> np.ndarray:
    """Run :func:`mix_program` in numpy float32 on (N, F) branch outputs;
    returns the (2, rows, F) channels ``[c0, c0 + rows)``, as
    ``mix_channels(spec, y, c0, rows)`` would."""
    c0, rows = channel_block(n, c0, rows)
    yr = np.asarray(yr, np.float32)
    yi = np.asarray(yi, np.float32)
    shape = (rows, yr.shape[1])
    acc = {"cr": np.empty(shape, np.float32), "ci": np.empty(shape, np.float32)}
    for b, br in enumerate(mix_program(n, c0, rows)):
        vals = {"yr": yr[b], "yi": yi[b]}
        for k, a in enumerate(br.products):
            vals[("pr", k)] = np.float32(a) * yr[b]
            vals[("pi", k)] = np.float32(a) * yi[b]
        for name, c, sign, operand in br.ops:
            v = vals[operand]
            if sign == "=":
                acc[name][c] = v
            else:
                acc[name][c] = acc[name][c] + v if sign == "+" else acc[name][c] - v
    return np.stack([acc["cr"], acc["ci"]])


def _operand_c(operand) -> str:
    return operand if isinstance(operand, str) else f"{operand[0]}{operand[1]}"


def _float_c(a: float) -> str:
    """An exact C++ float literal of a float32 value."""
    assert float(np.float32(a)) == a
    return float(a).hex() + "f"


#: the kernel's macro for each kind of accumulation (csrc/channelizer.cu)
MACROS = {"=": "MIX_SET", "+": "MIX_ADD", "-": "MIX_SUB"}


@functools.lru_cache(maxsize=None)
def mix_header(n: int, c0: int = 0, rows: Optional[int] = None) -> str:
    """C++ of ``Mix<n>::branch<T>(b, yr, yi, cr, ci)`` for the rows ``[c0,
    c0 + rows)`` (``Mix<n>::kStart`` and ``kRows``): branch b's products and
    accumulations over T frames. The kernel unrolls b, so the switch folds
    to one case. Uses the MIX_MUL, MIX_SET, MIX_ADD and MIX_SUB macros of
    ``csrc/channelizer.cu``."""
    c0, rows = channel_block(n, c0, rows)
    lines = [
        "// Generated by rtlamr_tpu_torch/ops/channelizer_mix.py mix_header from",
        "// the float32 tables of ops/channelizer.py _mix_matrix. Do not edit.",
        "template <int N> struct Mix;",
        f"template <> struct Mix<{n}> {{",
        f"  static constexpr int kStart = {c0}, kRows = {rows};",
        "  template <int T>",
        "  static __device__ __forceinline__ void branch(const int b, const float (&yr)[T],",
        f"      const float (&yi)[T], float (&cr)[{rows}][T], float (&ci)[{rows}][T]) {{",
        "    switch (b) {",
    ]
    for b, br in enumerate(mix_program(n, c0, rows)):
        lines.append(f"      case {b}: {{")
        for k, a in enumerate(br.products):
            lines.append(f"        float pr{k}[T], pi{k}[T];")
            lines.append(f"        MIX_MUL(pr{k}, {_float_c(a)}, yr); MIX_MUL(pi{k}, {_float_c(a)}, yi);")
        for name, c, sign, operand in br.ops:
            lines.append(f"        {MACROS[sign]}({name}[{c}], {_operand_c(operand)});")
        lines.append("      } break;")
    lines += ["      default: break;", "    }", "  }", "};"]
    return "\n".join(lines) + "\n"
