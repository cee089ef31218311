"""K3's share of its roofline in %: the least time K3's work on each traced
call's batch takes at the card's published peaks
(``benchmark/work/kl_barrier.py``, with the line-search candidates these
inputs need, counted by replaying the algorithm), over K3's device time in
the traced slice."""

from benchmark.work import kl_barrier


def read(run):
    tr = run.trace
    names = run.cell.family.KERNEL_NAMES["kl_barrier_fused"]
    k3 = [b - a for name, a, b in tr.ops
          if any(part in name for part in names)]
    if not k3 or len(k3) != tr.calls:
        return None
    least = {}
    for b in set(tr.batches):
        batch = run.pool[b]
        least[b] = kl_barrier.k3_least_seconds(
            run.H, batch["u"], batch["x0"], run.cell.mix["pars"])[0]
    return 100.0 * sum(least[b] for b in tr.batches) / (sum(k3) / 1e9)
