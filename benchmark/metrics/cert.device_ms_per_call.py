"""Device ms per call of every op other than K3 (``kl_barrier_fused``) in
a traced slice of the primal route: the certificate ``kl_dual_gap`` and the
route's own small ops around the kernel."""


def read(run):
    tr = run.trace
    k3 = run.cell.family.KERNEL_NAMES["kl_barrier_fused"]
    other = [(a, b) for name, a, b in tr.ops
             if not any(part in name for part in k3)]
    if not tr.ops or len(other) == len(tr.ops):
        return None
    return sum(b - a for a, b in other) / 1e6 / tr.calls
