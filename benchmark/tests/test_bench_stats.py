"""The tail, rate and idle-union arithmetic on made-up numbers."""

import pytest

from benchmark import stats, trace


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))          # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    # 20 values: the 19th smallest is the 95th percentile
    assert stats.percentile([float(v) for v in range(20, 0, -1)], 95) == 19.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(1_000_000, 2.0) == 500_000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_of_overlapping_and_nested_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (30, 31)]
    assert stats.merged(iv) == [(0, 15), (20, 31)]
    assert stats.union_length(iv) == 15 + 11
    assert stats.union_length([]) == 0


def test_gaps_within_a_window():
    iv = [(10, 20), (15, 30), (40, 50)]
    assert stats.gaps(iv, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert stats.gaps(iv, 12, 45) == [(30, 40)]
    assert stats.gaps([], 0, 5) == [(0, 5)]
    # busy + idle = the window
    busy = stats.union_length(iv)
    idle = sum(b - a for a, b in stats.gaps(iv, 0, 60))
    assert busy + idle == 60


def test_idle_share_of_a_slice():
    s = trace.Slice(calls=2, window_s=1e-6,
                    ops=[("k", 0, 300), ("k", 200, 500), ("m", 700, 800)])
    assert s.busy_s() == pytest.approx(600e-9)
    assert trace.top_ops(s.ops) == [["k", 600e-9], ["m", 100e-9]]


def test_innermost_host_op():
    rows = sorted([("outer", 0, 100), ("a", 10, 20), ("b", 30, 90),
                   ("c", 40, 50)], key=lambda r: r[1])
    starts = [r[1] for r in rows]
    assert trace._innermost(rows, starts, 45) == "c"
    assert trace._innermost(rows, starts, 60) == "b"
    assert trace._innermost(rows, starts, 25) == "outer"
    assert trace._innermost(rows, starts, 150) == "(host between ops)"
