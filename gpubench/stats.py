"""Arithmetic of the end-to-end and device metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    closest ranks; a missing sample is ``inf`` and counts as over any
    limit."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        raise ValueError("percentile of no samples")
    pos = (v.size - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if v[hi] == math.inf:
        return math.inf
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def union_length(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    spans = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    total, end = 0.0, lo
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def innermost_segments(spans: Iterable[Tuple[float, float, str]], lo: float, hi: float,
                       none: str) -> List[Tuple[float, float, str]]:
    """Cut ``[lo, hi]`` into segments labelled by the innermost of the
    properly nested ``spans`` (start, end, label) open there, ``none`` where
    none is."""
    points = sorted({lo, hi} | {t for a, b, _ in spans for t in (a, b) if lo < t < hi})
    ordered = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(ordered) and ordered[i][0] <= a:
            stack.append(ordered[i])
            i += 1
        while stack and stack[-1][1] <= a:
            stack.pop()
        live = [s for s in stack if s[1] > a]
        stack = live
        out.append((a, b, live[-1][2] if live else none))
    return out


def overlap_by_label(gaps: Sequence[Tuple[float, float]],
                     segments: Sequence[Tuple[float, float, str]]) -> dict:
    """Seconds of ``gaps`` that fall in each label's segments (both sorted
    and each without overlaps of its own)."""
    out: dict = {}
    j = 0
    for a, b in gaps:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s0, s1, label = segments[k]
            d = min(b, s1) - max(a, s0)
            if d > 0:
                out[label] = out.get(label, 0.0) + d
            k += 1
    return out
