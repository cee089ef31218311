"""K2's share of its roofline in %: the least time K2's work takes at the
card's published peaks (``benchmark/work/kl_dual.py``, from the shapes),
over K2's device time per launch in a traced slice."""

from benchmark.work import kl_dual


def read(run):
    names = run.cell.family.KERNEL_NAMES["kl_dual_fused_cert"]
    k2 = [b - a for name, a, b in run.trace.ops
          if any(part in name for part in names)]
    if not k2:
        return None
    k, n = run.H.shape
    least, _ = kl_dual.k2_least_seconds(run.B, n, k)
    return 100.0 * least / (sum(k2) / 1e9 / len(k2))
