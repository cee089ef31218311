"""The KL projection fleet: batches of instances that share their rows and
differ in their probability bounds.

A configuration gives n, the batch, the dtype and its rows: each row is the
indicator of a range of coordinates with a bound drawn per instance,
P(range) >= p (stored as -indicator . x <= -p) or P(range) <= p, p ~ U(low,
high).  The recipe is frozen from ``bench_family`` and ``feasible_points``
in ``cvx_tpu_torch/_bench.py`` at commit
61015afd76d76d8ead80eef8352088353340c2cc (bench.py's family: P(A) >= pA
with |A| = 3, P(B) <= pB with B the second half), drawn here on the device
from a ``torch.Generator`` instead of NumPy.

The program is reached only through ``make_model``, ``call`` and
``counters``; everything else is the benchmark's own.

``compare`` returns ``x_err``, ``obj_err``, ``gap_err``, ``dual_err``,
``res_err`` (floats, the worst over a batch) and ``stall_diff`` (a count):
``reference.kl_projection.compare`` says what each is.
"""

import torch

from ..reference import kl_projection
from ..reference.certificate import kl_gap_certificate

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make_inputs(config, mix, seed, device):
    """H (k, n) and a pool of ``mix["pool"]`` batches, each a dict with
    the bounds u (B, k) and, where the mix's call takes them, strictly
    feasible starts x0 (B, n), all made on the device from the seed."""
    if config["prior"] != "uniform":
        raise ValueError("kl_bounds: the reference and the routes here take "
                         "the uniform prior only")
    dtype = DTYPES[config["dtype"]]
    n, B, rows = config["n"], config["batch"], config["rows"]
    P = mix["pool"]
    H = torch.zeros((len(rows), n), dtype=dtype, device=device)
    for j, row in enumerate(rows):
        H[j, row["start"]:row["stop"]] = -1.0 if row["sense"] == ">=" else 1.0
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draw = torch.rand((P, B, len(rows)), generator=gen, dtype=dtype,
                      device=device)
    low = torch.tensor([r["low"] for r in rows], dtype=dtype, device=device)
    high = torch.tensor([r["high"] for r in rows], dtype=dtype,
                        device=device)
    sign = torch.tensor([-1.0 if r["sense"] == ">=" else 1.0 for r in rows],
                        dtype=dtype, device=device)
    U = sign * (low + (high - low) * draw)
    pool = [{"u": U[i]} for i in range(P)]
    if "x0" in mix["inputs"]:
        for batch in pool:
            batch["x0"] = feasible_points(config, H, batch["u"])
    return H, pool


def feasible_points(config, H, u):
    """bench.py's strictly feasible start: weight p + margin on the range
    of the first ">=" row, spread evenly, the rest spread evenly over the
    other coordinates.  Raises if a start is not strictly feasible."""
    j = next(i for i, r in enumerate(config["rows"]) if r["sense"] == ">=")
    row = config["rows"][j]
    n = H.shape[1]
    inside = torch.zeros(n, dtype=H.dtype, device=H.device)
    inside[row["start"]:row["stop"]] = 1.0
    m = row["stop"] - row["start"]
    w = -u[:, j:j + 1] + config["start_margin"]
    x0 = (w / m) * inside + ((1 - w) / (n - m)) * (1 - inside)
    if not bool(((x0 > 0).all() & (x0 @ H.T < u).all())):
        raise ValueError("the start recipe is not strictly feasible for "
                         "this configuration's rows")
    return x0


def make_model(config, H):
    """The program's model of the shared rows (per-instance bounds are the
    calls' arguments)."""
    from cvx_tpu_torch import DistKL

    return DistKL.create(config["n"], H=H, u=torch.zeros_like(H[:, 0]),
                         device=H.device)


def call(model, mix, batch):
    """One call of the mix's entry point on one batch of the pool."""
    from cvx_tpu_torch import SolverParams

    kwargs = dict(mix.get("kwargs", {}))
    if "pars" in mix:
        kwargs["pars"] = SolverParams(**mix["pars"])
    return getattr(model, mix["call"])(*(batch[a] for a in mix["inputs"]),
                                       **kwargs)


def outputs(sol):
    """What the comparison judges of a returned Solution."""
    return dict(x=sol.x, gap=sol.duality_gap, lam=sol.lam, nu=sol.nu,
                ineq=sol.ineq_res, eq=sol.eq_gap, stalled=sol.stalled)


def failed(out):
    """The call's instances that failed: those it flagged as stalled."""
    return out["stalled"]


def counters():
    """The program's launch counters, by kernel wrapper."""
    from cvx_tpu_torch.ops.chol import cholesky_batched_cuda
    from cvx_tpu_torch.ops.kl_barrier import kl_barrier_fused
    from cvx_tpu_torch.ops.kl_dual import kl_dual_fused, kl_dual_fused_cert
    from cvx_tpu_torch.ops.kl_gap import kl_gap_fused

    return {f.__name__: f.launches for f in (
        kl_dual_fused, kl_dual_fused_cert, kl_barrier_fused,
        cholesky_batched_cuda, kl_gap_fused)}


# the device kernels each counter counts, by a part of their names
KERNEL_NAMES = {"kl_dual_fused": ("kl_dual_kernel", "kl_dual_group_kernel"),
                "kl_dual_fused_cert": ("kl_dual_cert",),
                "kl_barrier_fused": ("kl_barrier",),
                "cholesky_batched_cuda": ("chol_held", "chol_panel"),
                "kl_gap_fused": ("kl_gap_polish",)}


def reference(H, batch):
    """The reference's optimum of one batch, in f64."""
    return kl_projection.solve(H, batch["u"])


def compare(H, batch, out, ref, mix):
    """The numbers of one batch's outputs against its reference."""
    return kl_projection.compare(H, batch["u"], out, ref, mix["contract"])


def control(H, batch, mix, precision):
    """The reference in the program's place, in ``precision``."""
    return kl_projection.control(H, batch["u"], mix["contract"], precision)


def reference_certificate(H, batch, ref):
    """The frozen f64 certificate's largest |gap| at the reference's own
    optimum: how far the reference is from exact."""
    c = kl_gap_certificate(ref["x"].cpu().numpy(), H.cpu().numpy(),
                           batch["u"].double().cpu().numpy())
    return float(abs(c).max())
