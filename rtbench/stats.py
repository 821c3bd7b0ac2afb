"""The benchmark's arithmetic: percentiles over frames and the union of
device intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(ordered)), 1)
    return ordered[rank - 1]


def frame_times(done) -> list:
    """Each frame's time: the interval between its completion and the
    previous frame's (the window's opening for the first)."""
    return [b - a for a, b in zip([0.0] + list(done[:-1]), done)]


def union_length(intervals) -> float:
    """Total length covered by the (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers,
    longest first."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])

