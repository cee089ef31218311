"""The arithmetic of the metrics: tails, rates and the union of device
intervals.  Plain Python, tested on made-up numbers."""

import math


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q % of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100 * len(ordered))) - 1]


def rate(count, seconds):
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return count / seconds


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def union_length(intervals):
    """The length covered by at least one interval."""
    return sum(end - start for start, end in merged(intervals))


def gaps(intervals, start, end):
    """The (start, end) stretches of [start, end] that no interval
    covers."""
    out, t = [], start
    for a, b in merged(intervals):
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]
