"""Quantiles as the end-to-end metrics take them."""

from __future__ import annotations

import math


def quantile(values: list[float], q: float) -> float:
    """Linear interpolation between the closest ranks (numpy's
    default); an infinite value (a request that never finished) ranks
    last. 0.0 for no values."""
    v = sorted(values)
    if not v:
        return 0.0
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    frac = pos - lo
    if frac == 0.0 or v[lo] == v[hi]:
        return v[lo]
    return v[lo] + (v[hi] - v[lo]) * frac
