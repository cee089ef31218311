"""The device's idle share of a traced slice of steady calls, in %: one
minus the union of the device ops' intervals over the slice's host-clock
window, from the first issue to the last ``synchronize()``."""


def read(run):
    tr = run.trace
    if not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
