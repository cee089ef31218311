"""Traced slices of steady calls, read from ``torch.profiler``'s raw
events.

``device_slice`` traces device activity alone (as a kernel run through
CUPTI sees it) over a fixed number of calls: the device ops with their
names and intervals, the host-clock window from the first issue to the
last ``synchronize()``, and the program's counters over the slice.
``host_slice`` traces host ops beside the device over fewer calls, for
the breakdown of the device's idle gaps by what the host was doing.
Nothing is written to disk.
"""

import bisect
import collections
import time
from dataclasses import dataclass, field

from . import stats

CALL_SPAN = "benchmark.call"


@dataclass
class Slice:
    calls: int
    window_s: float
    ops: list                    # (name, start_ns, end_ns) on the device
    counters: dict = field(default_factory=dict)
    batches: list = field(default_factory=list)   # pool index of each call

    def busy_s(self):
        return stats.union_length([(a, b) for _, a, b in self.ops]) / 1e9


def _events(prof):
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for evt in prof.profiler.kineto_results.events():
        start, dur = evt.start_ns(), evt.duration_ns()
        row = (evt.name(), start, start + dur)
        if evt.device_type() != cuda:
            host.append(row)
        elif not (getattr(evt, "is_user_annotation", bool)()
                  or row[0] == CALL_SPAN):
            # a host span is mirrored on the device's timeline as one
            # annotation from its first kernel to its last: not an op
            dev.append(row)
    return dev, host


def device_activities(device):
    """The profiler's activities that record ``device``'s ops: the card's,
    and none off it, where the harness takes no traced slice."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA] if device.type == "cuda" else []


def device_slice(call, calls, pool, sync, counters, activities):
    """Trace the device (``activities``) over ``calls`` calls of ``call(i)``
    (batch i of the pool, cycling), each ending in ``sync()``;
    ``counters()`` reads the program's counters before and after."""
    from torch.profiler import profile

    before = counters()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            call(i % pool)
            sync()
        window = time.perf_counter() - t0
    after = counters()
    dev, _ = _events(prof)
    return Slice(calls=calls, window_s=window, ops=dev,
                 counters={k: after[k] - before[k] for k in after},
                 batches=[i % pool for i in range(calls)])


def host_slice(call, calls, pool, sync, activities, top=10):
    """Trace host and device (``activities``) over ``calls`` calls and
    return the longest idle gaps of the device, summed by the innermost host
    op running at each gap's middle: [[name, seconds], ...], at most
    ``top``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities={ProfilerActivity.CPU, *activities}) as prof:
        for i in range(calls):
            with record_function(CALL_SPAN):
                call(i % pool)
                sync()
    dev, host = _events(prof)
    spans = [(a, b) for name, a, b in host if name == CALL_SPAN]
    if not dev or not spans:
        return []
    start = min(a for a, _ in spans)
    end = max(b for _, b in spans)
    inner = sorted((row for row in host if row[0] != CALL_SPAN),
                   key=lambda row: row[1])
    starts = [row[1] for row in inner]
    by_name = collections.Counter()
    for a, b in stats.gaps([(s, e) for _, s, e in dev], start, end):
        by_name[_innermost(inner, starts, (a + b) / 2)] += (b - a) / 1e9
    return [[name, sec] for name, sec in by_name.most_common(top)]


def _innermost(rows, starts, t, reach=512):
    """The name of the latest-starting host op of ``rows`` (sorted by
    start) that covers time t, looking back at most ``reach`` ops; else
    the host was between ops."""
    i = bisect.bisect_right(starts, t)
    for row in reversed(rows[max(0, i - reach):i]):
        if row[2] >= t:
            return row[0]
    return "(host between ops)"


def top_ops(ops, top=10):
    """The device ops that took most time, summed by name: [[name,
    seconds], ...]."""
    by_name = collections.Counter()
    for name, a, b in ops:
        by_name[name] += (b - a) / 1e9
    return [[name, sec] for name, sec in by_name.most_common(top)]
