"""The arithmetic of a window: rates over the whole window, percentiles over
every request."""
from __future__ import annotations

import math
from typing import Sequence


def rate(items: float, seconds: float) -> float:
    """Items per second over the whole window: every item over all of its
    time, never a median of chunks."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return items / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: Sequence[float]):
    return sum(values) / len(values) if values else None
