"""The verdict that decides ``correct``, the same for every family.

A family's ``compare`` gives, for one batch, its numbers by name (its
module docstring lists them): each a float, the worst over the batch's
instances, or an int, a count.  ``merge`` combines batches and ``decide``
holds the result to the cell's limits (``limits/<workload>.json``).  In a
cell of several ranks the harness adds ``rank_diff``, the largest
difference of any rank's outputs from rank 0's.
"""

import math


def merge(a, b):
    """The worst of two batches' numbers: a count (an int) adds, any other
    number takes the larger."""
    if a is None:
        return dict(b)
    return {key: (a[key] + b[key] if isinstance(a[key], int)
                  else max(a[key], b[key])) for key in a}


def decide(numbers, limits):
    """(correct, [(name, number, limit)]) over the numbers that ``limits``
    holds: each at or below its limit (a number never read is +inf)."""
    rows = [(name, numbers.get(name, math.inf), lim)
            for name, lim in limits.items()]
    return all(value <= lim for _, value, lim in rows), rows
