"""Percentiles, windowed rates and busy intervals over the run's records."""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics); None of no values."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def round_window(stamps: Sequence[float], start: float, end: float
                 ) -> Optional[Tuple[float, float]]:
    """The span between the first round end at or after ``start`` and the
    last at or before ``end``: a window of whole rounds, so that no round is
    counted in part."""
    inside = [t for t in stamps if start <= t <= end]
    if len(inside) < 2:
        return None
    return inside[0], inside[-1]


def count_in(events: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Sum of the amounts of the (time, amount) events with lo < time <= hi."""
    return sum(a for t, a in events if lo < t <= hi)


def merge_intervals(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) spans, as sorted disjoint spans."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
