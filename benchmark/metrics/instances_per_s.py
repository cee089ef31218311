"""Instances returned per second over the whole window (host clock): every
call's instances, over the wall time from the first issue to the last
``synchronize()``."""

from benchmark import stats


def read(run):
    w = run.window
    return stats.rate(w.calls * run.B, w.wall_s)
