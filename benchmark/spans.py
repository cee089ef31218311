"""The program's own spans (``cvx.*``) in a traced slice, for the
per-layer metrics that read them.

``read(run)`` traces ``breakdown_calls`` calls of the cell's mix on a model
of its own (made through ``run.program``, so that the ranks of a cell of
several take the same steps), host and device, each call inside
``trace.CALL_SPAN`` and ending in ``synchronize()``, once per run (cached
on ``run``).  ``attribute`` then links each device op to its launch (the
runtime call with the same correlation id) and from there to the ``cvx.*``
spans that cover the launch, and splits the device's idle time inside the
calls by the innermost ``cvx.*`` span the host was in.  A program without
spans yields an attribution with none, and each metric then gives no value.
What it read is printed to the run's log.

The profiler's device timestamps do not keep to the host's clock: on an
H100 with torch 2.11 kernels were stamped up to 1.24 ms before the
runtime call that launched them, the offset moving by up to 0.5 % of the
time elapsed.  So before the idle time is split, the device's timeline is put
back on the host's clock through the links: in each stretch of
``WINDOW_NS`` of launches, the op that started soonest after its launch is
taken to have started at its launch (a launch's own latency, a few us, is
taken as 0), and the stretch's ops move with it.  ``early`` counts the ops
stamped before their launch, the check on the clock that the profiler
itself gives.
"""

import bisect
import collections
from dataclasses import dataclass, field

from . import stats, trace

PREFIX = "cvx."
LAUNCH_SPAN = "cvx.kernel.launch"
NONE = "(no cvx span)"
WINDOW_NS = 1_000_000
# the host side of a device op is the CUDA API call that queued it
# (cudaLaunchKernel, cuLaunchKernel, cudaMemsetAsync, ...), found by name:
# the events of some torch versions carry no activity type
LAUNCH_PREFIX = "cu"


@dataclass
class Attribution:
    calls: int
    call_ns: list = field(default_factory=list)       # each call's span
    span_ns: dict = field(default_factory=dict)       # name -> summed ns
    span_count: dict = field(default_factory=dict)    # name -> count
    device_ns: dict = field(default_factory=dict)     # name -> ops' ns
    ops: int = 0
    unlinked: int = 0         # device ops with no launch in the trace
    early: int = 0            # linked ops stamped before their launch
    offsets_ns: list = field(default_factory=list)    # device - host clock
    idle_ns: int = 0          # device idle inside the calls
    idle_in_program_ns: int = 0
    idle_by_span: dict = field(default_factory=dict)  # innermost -> ns

    def summed(self, prefix):
        """The summed ns of the spans whose names start with ``prefix``,
        and how many there were."""
        names = [n for n in self.span_ns if n.startswith(prefix)]
        return (sum(self.span_ns[n] for n in names),
                sum(self.span_count[n] for n in names))


def _covering(spans, t):
    """The spans of ``spans`` (one call's, sorted by start) that cover time
    t, outermost first (ranges nest)."""
    return [s for s in spans if s[1] <= t <= s[2]]


def attribute(host, device, launches):
    """The attribution of a traced slice.  ``host``: (name, start, end)
    host ranges, the calls (``trace.CALL_SPAN``) and the program's spans;
    ``device``: (name, start, end, correlation id) device ops; ``launches``:
    correlation id -> start of the host call that queued the op."""
    calls = sorted((a, b) for name, a, b in host if name == trace.CALL_SPAN)
    spans = sorted((row for row in host if row[0].startswith(PREFIX)),
                   key=lambda row: row[1])
    out = Attribution(calls=len(calls))
    out.call_ns = [b - a for a, b in calls]
    for name, a, b in spans:
        out.span_ns[name] = out.span_ns.get(name, 0) + (b - a)
        out.span_count[name] = out.span_count.get(name, 0) + 1
    starts = [s[1] for s in spans]
    in_call = [spans[bisect.bisect_left(starts, ca):
                     bisect.bisect_right(starts, cb)] for ca, cb in calls]
    call_starts = [ca for ca, _ in calls]
    device_ns = collections.Counter()
    for _, a, b, corr in device:
        out.ops += 1
        launch = launches.get(corr)
        if launch is None:
            out.unlinked += 1
            continue
        if a < launch:
            out.early += 1
        k = bisect.bisect_right(call_starts, launch) - 1
        for name in {s[0] for s in _covering(in_call[k] if k >= 0 else [],
                                             launch)}:
            device_ns[name] += b - a
    out.device_ns = dict(device_ns)

    ops, out.offsets_ns = _on_host_clock(device, launches)
    op_starts = [a for a, _ in ops]
    idle_by = collections.Counter()
    for (ca, cb), mine in zip(calls, in_call):
        inside = ops[bisect.bisect_left(op_starts, ca):
                     bisect.bisect_right(op_starts, cb)]
        cuts = sorted({t for _, a, b in mine for t in (a, b)})
        for ga, gb in stats.gaps(inside, ca, cb):
            edges = [ga] + [t for t in cuts if ga < t < gb] + [gb]
            for pa, pb in zip(edges, edges[1:]):
                over = _covering(mine, (pa + pb) / 2)
                idle_by[over[-1][0] if over else NONE] += pb - pa
                if over:
                    out.idle_in_program_ns += pb - pa
            out.idle_ns += gb - ga
    out.idle_by_span = dict(idle_by)
    return out


def _on_host_clock(device, launches):
    """The linked device ops' (start, end) moved onto the host's clock, in
    order, and the offset taken in each stretch of ``WINDOW_NS``."""
    linked = sorted((launches[c], a, b) for _, a, b, c in device
                    if c in launches)
    ops, offsets, i = [], [], 0
    while i < len(linked):
        j = i
        while j < len(linked) and linked[j][0] - linked[i][0] <= WINDOW_NS:
            j += 1
        off = min(a - launch for launch, a, _ in linked[i:j])
        offsets.append(off)
        ops += [(a - off, b - off) for _, a, b in linked[i:j]]
        i = j
    return sorted(ops), offsets


def _raw(prof):
    """(host, device, launches) of a profile, as ``attribute`` takes them;
    the device ops are those ``trace`` counts."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, device, launches = [], [], {}
    for evt in prof.profiler.kineto_results.events():
        name, start = evt.name(), evt.start_ns()
        row = (name, start, start + evt.duration_ns())
        if evt.device_type() == cuda:
            if not (evt.is_user_annotation() or name == trace.CALL_SPAN):
                device.append(row + (evt.correlation_id(),))
        elif name.startswith(LAUNCH_PREFIX):
            launches[evt.correlation_id()] = start
        elif name == trace.CALL_SPAN or name.startswith(PREFIX):
            host.append(row)
    return host, device, launches


def _trace(run):
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    call = run.program.make()
    pool = len(run.pool)
    for b in range(pool):           # the new model's first calls
        call(b)
    run.sync()
    with profile(activities={ProfilerActivity.CPU,
                             *trace.device_activities(run.device)}) as prof:
        for i in range(run.cell.mix["breakdown_calls"]):
            with record_function(trace.CALL_SPAN):
                call(i % pool)
                run.sync()
    return attribute(*_raw(prof))


def _report(got, log):
    ms = sorted(ns / 1e6 for ns in got.call_ns)
    print(f"spans: {got.calls} calls traced, host and device; the call "
          f"span under the profiler, ms: mean "
          f"{sum(ms) / max(len(ms), 1):.4f}, median "
          f"{ms[len(ms) // 2] if ms else float('nan'):.4f}", file=log)
    for name in sorted(got.span_ns):
        print(f"  {name}: {got.span_count[name]} spans, "
              f"{got.span_ns[name] / 1e6 / max(got.calls, 1):.4f} ms a call "
              f"host, {got.device_ns.get(name, 0) / 1e6 / max(got.calls, 1):.4f}"
              f" ms a call device (ops launched inside)", file=log)
    off = sorted(got.offsets_ns) or [0]
    print(f"spans: {got.ops} device ops, {got.unlinked} not linked to a "
          f"launch, {got.early} linked ones stamped before their launch; "
          f"device clock - host clock by the links, us: {off[0] / 1e3:.1f} "
          f"to {off[-1] / 1e3:.1f} over {len(got.offsets_ns)} stretches",
          file=log)
    share = 100.0 * got.idle_in_program_ns / got.idle_ns if got.idle_ns \
        else float("nan")
    print(f"spans: device idle inside the calls {got.idle_ns / 1e9:.6f} s, "
          f"{share:.2f} % of it with the host in a cvx span; by innermost "
          f"span, s: " + ", ".join(
              f"{name} {ns / 1e9:.6f}" for name, ns in sorted(
                  got.idle_by_span.items(), key=lambda kv: -kv[1])),
          file=log)


def read(run):
    """The attribution of this run's traced slice of the program's spans,
    made once and kept on ``run``; None where nothing ran on a card."""
    if not hasattr(run, "spans"):
        run.spans = None
        if trace.device_activities(run.device):
            run.spans = _trace(run)
            _report(run.spans, run.log)
    return run.spans
