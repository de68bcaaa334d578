"""Percentiles."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of ``values``, interpolated
    linearly between the order statistics at rank q / 100 * (n - 1)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q / 100 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values, q: float) -> int:
    """How many values lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)

