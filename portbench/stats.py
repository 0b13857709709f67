"""The arithmetic of the end-to-end metrics and of a spread."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def nearest_rank(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile by nearest rank: the smallest value with at
    least ``pct`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100 * len(ordered)) - 1)]


def rate(work: int, seconds: float) -> float:
    """Work over all the time it took."""
    return work / seconds


def iqr_share(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles``, n=4) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed_range_share(values: Sequence[float]) -> float:
    """The range of the values as a share of their median, less the value
    farthest from the median where that narrows it."""
    med = statistics.median(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    span = max(values) - min(values)
    if len(rest) >= 2:
        span = min(span, max(rest) - min(rest))
    return span / med
