"""Statistics of a measured window: all the work over all the time, the
window ended at the last unit completed in it, and tails over every
request."""

from __future__ import annotations

import statistics

import numpy as np


def rate(units, t_start, t_last_done):
    """Units a second over the window from ``t_start`` to the end of the last
    completed unit."""
    span = t_last_done - t_start
    if units <= 0 or span <= 0:
        raise ValueError(f"no completed work in the window ({units} units over {span} s)")
    return units / span


def percentile(values, q):
    """The ``q``-th percentile of every value (linear between order
    statistics)."""
    if not len(values):
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values):
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
