"""The comparison that decides ``correct``: a route's outputs against the
reference's optimum of the same instances, in f64.

Numbers, each the worst over every instance compared:

* ``x_err``: max |x - x*|.
* ``obj_err``: max |f(x) - p*|, f measured in f64 at the returned x.
* ``gap_err``: max |reported gap - the gap measured in f64 at the returned
  (x, lam, nu)|: the certificate the route reports is the one it earned.
* ``dual_err``: max over lam and nu of |z - z*| / (1 + |z*|).
* ``res_err``: max |reported residual - the residual measured in f64|,
  over the inequality and the equality residual.
* ``stall_diff``: instances whose ``stalled`` flag differs from the
  route's contract applied to the f64 measurement (an exact count).

A non-finite number reads +inf.
"""

import math

import torch

from .kl_projection import measure, stalled

NUMBERS = ("x_err", "obj_err", "gap_err", "dual_err", "res_err",
           "stall_diff")


def _worst(t):
    t = torch.nan_to_num(t.to(torch.float64), nan=math.inf)
    return float(t.max()) if t.numel() else 0.0


def compare(H, u, out, ref, contract):
    """The numbers for one batch.  ``out``: the route's x (B, n), gap,
    lam (B, >= k; the first k are the rows' multipliers), nu (B, >= 1;
    the first is the sum-to-one row's), ineq, eq and stalled; ``ref``:
    ``kl_projection.solve`` in f64 on the same H and u."""
    f64 = torch.float64
    k = H.shape[0]
    x = out["x"].to(f64)
    lam, nu = out["lam"][:, :k].to(f64), out["nu"][:, 0].to(f64)
    m = measure(H, u, x, lam, nu[:, None])
    verdict = stalled(x, m, contract)
    dlam = ((lam - ref["lam"]).abs() / (1 + ref["lam"].abs())).amax(-1)
    nu_ref = ref["nu"][:, 0]
    dnu = (nu - nu_ref).abs() / (1 + nu_ref.abs())
    return dict(
        x_err=_worst((x - ref["x"]).abs().amax(-1)),
        obj_err=_worst((m["f"] - ref["f"]).abs()),
        gap_err=_worst((out["gap"].to(f64) - m["gap"]).abs()),
        dual_err=_worst(torch.maximum(dlam, dnu)),
        res_err=_worst(torch.maximum((out["ineq"].to(f64) - m["ineq"]).abs(),
                                     (out["eq"].to(f64) - m["eq"]).abs())),
        stall_diff=int((out["stalled"].bool() != verdict).sum()))


def merge(a, b):
    """The worst of two batches' numbers (counts add)."""
    if a is None:
        return dict(b)
    return {key: (a[key] + b[key] if key == "stall_diff"
                  else max(a[key], b[key])) for key in a}


def decide(numbers, limits):
    """(correct, [(name, number, limit)]) over the numbers that ``limits``
    holds: each at or below its limit (a number never read is +inf)."""
    rows = [(name, numbers.get(name, math.inf), lim)
            for name, lim in limits.items()]
    return all(value <= lim for _, value, lim in rows), rows
