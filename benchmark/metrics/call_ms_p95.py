"""The 95th percentile (nearest rank) over every call of the window of a
call's latency in ms, from a CUDA event recorded as it is issued (the
stream is empty then) to one recorded as it returns, on the device's
clock."""

from benchmark import stats


def read(run):
    lat = run.window.latencies_ms
    return stats.percentile(lat, 95) if lat else None
