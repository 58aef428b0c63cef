"""Order statistics of a run."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over every value (q in (0, 100]): the
    smallest value with at least q % of the values at or below it. A
    failed request enters as ``math.inf``."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles``' default method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
