"""The statistics the benchmark reports and the spreads its bounds come
from."""

from __future__ import annotations

import statistics


def step_ms(window_s: float, steps: int) -> float:
    """The whole window over the steps completed in it, in ms."""
    if steps < 1:
        raise ValueError("no step completed in the window")
    return 1e3 * window_s / steps


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    between the two nearest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles``, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
