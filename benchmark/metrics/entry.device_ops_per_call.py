"""Device ops per call in a traced slice (kernels, copies and sets as the
profiler records them), cross-checked against the program's launch
counters: each counter's kernels, found by name in the trace, should
number what the counter counted over the slice.  Where one does not, the
trace has dropped or misnamed events, and the metric gives no value."""


def read(run):
    tr = run.trace
    if not tr.ops:
        return None
    names = run.cell.family.KERNEL_NAMES
    agree = True
    for counter, delta in tr.counters.items():
        seen = sum(any(part in op for part in names[counter])
                   for op, _, _ in tr.ops)
        if delta or seen:
            print(f"cross-check {counter}: counter {delta}, trace {seen} "
                  f"over {tr.calls} calls"
                  f"{'' if delta == seen else ' (DIFFER: no value)'}",
                  file=run.log)
        agree = agree and delta == seen
    return len(tr.ops) / tr.calls if agree else None
