"""The window's arithmetic: a rate over all the work and all the time, and
a percentile over all the jobs."""

from __future__ import annotations

import math
from typing import Sequence


def rate(amounts: Sequence[float], starts: Sequence[float],
         ends: Sequence[float]) -> float:
    """Sum of `amounts` over the time from the first start to the last
    end."""
    if not amounts:
        raise ValueError("no job completed")
    span = max(ends) - min(starts)
    if span <= 0:
        raise ValueError("the jobs took no time")
    return sum(amounts) / span


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q % of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]

