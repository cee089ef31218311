"""Plain reference for the KL projection family, in plain PyTorch.

Each instance i is

    x*_i = argmin_x  sum_j x_j log(x_j / p_j)   s.t.  H x <= u_i,  1'x = 1,

with p uniform over n coordinates and H (k, n) shared by the batch.  Its
dual, with the sum-to-one row eliminated, is

    phi(lam) = u.lam + log sum_j p_j exp(-(H'lam)_j),   lam >= 0,

and x*(lam) = softmax(log p - H'lam), nu = log sum_j p_j exp(-(H'lam)_j) - 1
and p* = -phi(lam*).  ``solve`` finds lam* by enumerating the active sets:
for each subset S of the rows it minimises phi over lam_S (the others at 0)
by damped Newton (full steps once the decrease is below phi's rounding,
until every instance is there); every candidate with lam_S >= 0 is a feasible point, and
the optimum is the feasible candidate of least phi.  In f64 this is exact
to rounding.

The same code in a lower precision is the control: ``"f32"`` is f32
arithmetic throughout, ``"tf32"`` is f32 with the operands of every matrix
product rounded to TF32 (10 explicit mantissa bits, as the tensor cores
take them), accumulated in f32.  Nothing here imports the program.
"""

import itertools
import math

import torch

PRECISIONS = {"f64": (torch.float64, False), "f32": (torch.float32, False),
              "tf32": (torch.float32, True)}


def round_tf32(t):
    """f32 values rounded to the nearest TF32 value (ties to even), kept as
    f32."""
    i = t.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & -0x2000).view(torch.float32)


class Arith:
    """The dtype of a computation and how it takes a matrix product."""

    def __init__(self, precision):
        self.dtype, self.tf32 = PRECISIONS[precision]

    def mm(self, a, b):
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b


def _phi(ar, H, u, lam, logp):
    """phi at lam (..., k) for bounds u broadcast against it."""
    return (u * lam).sum(-1) + torch.logsumexp(logp - ar.mm(lam, H), dim=-1)


def _newton(ar, H, u, mask, logp, iters, n_t=30):
    """Damped Newton on phi over the rows in ``mask`` (k,), the others held
    at 0; backtracking over t = 2^-i, i < n_t, all evaluated at once."""
    B, k = u.shape
    dt = ar.dtype
    lam = torch.zeros((B, k), dtype=dt, device=u.device)
    free = mask.to(dt)
    fixed = torch.diag_embed((1 - free).expand(B, k))
    ts = 0.5 ** torch.arange(n_t, dtype=dt, device=u.device)
    eps = torch.finfo(dt).eps
    for _ in range(iters):
        x = torch.softmax(logp - ar.mm(lam, H), dim=-1)
        hx = ar.mm(x, H.T)                                   # (B, k)
        g = (u - hx) * free
        hess = (ar.mm(x[:, None, :] * H, H.T) - hx[:, :, None] * hx[:, None, :])
        hess = hess * free[:, None] * free[None, :] + fixed
        # a ridge at rounding keeps a system whose x has underflowed off a
        # row's support solvable; such a step is judged by phi alone
        ridge = torch.finfo(dt).eps * (1 + hess.diagonal(0, 1, 2).sum(-1))
        hess = hess + ridge[:, None, None] * torch.eye(k, dtype=dt,
                                                      device=u.device)
        d = -torch.linalg.solve_ex(hess, g[..., None])[0][..., 0] * free
        d = torch.where(torch.isfinite(d), d, 0.0)
        f0 = _phi(ar, H, u, lam, logp)
        cand = lam[:, None, :] + ts[None, :, None] * d[:, None, :]
        fc = _phi(ar, H, u[:, None, :], cand, logp)
        ok = torch.isfinite(fc) & (fc <= f0[:, None]
                                   + 1e-4 * ts[None, :] * (g * d).sum(-1,
                                                                     True))
        first = torch.where(ok, torch.arange(n_t, device=u.device),
                            n_t).amin(dim=1)
        t = torch.where(first < n_t, ts[first.clamp_max(n_t - 1)], 0.0)
        # where the decrease is below phi's rounding no candidate can show
        # it, and the full step converges quadratically
        flat = -(g * d).sum(-1) <= 64 * eps * (1 + f0.abs())
        t = torch.where(flat, 1.0, t)
        lam = lam + t[:, None] * d
        if bool(flat.all()):
            break
    return lam


def solve(H, u, precision="f64", iters=60):
    """The projection of the uniform prior for each row of u (B, k) under
    the shared rows H (k, n).  Returns a dict of x (B, n), lam (B, k), nu
    (B, 1) and f (B,), the optimal value, in the precision's dtype."""
    ar = Arith(precision)
    H, u = H.to(ar.dtype), u.to(ar.dtype)
    B, k = u.shape
    n = H.shape[1]
    logp = torch.full((n,), -math.log(n), dtype=ar.dtype, device=u.device)
    best = torch.full((B,), math.inf, dtype=ar.dtype, device=u.device)
    lam_best = torch.zeros((B, k), dtype=ar.dtype, device=u.device)
    for S in itertools.product((False, True), repeat=k):
        mask = torch.tensor(S, device=u.device)
        lam = _newton(ar, H, u, mask, logp, iters)
        phi = _phi(ar, H, u, lam, logp)
        take = (lam >= 0).all(-1) & torch.isfinite(phi) & (phi < best)
        best = torch.where(take, phi, best)
        lam_best = torch.where(take[:, None], lam, lam_best)
    e = logp - ar.mm(lam_best, H)
    lse = torch.logsumexp(e, dim=-1)
    return dict(x=torch.exp(e - lse[:, None]), lam=lam_best,
                nu=(lse - 1.0)[:, None], f=-best)


def measure(H, u, x, lam, nu, precision="f64"):
    """The measured certificate of iterates x (B, n) with duals lam (B, k)
    and nu (B, 1): f(x), g(lam, nu) = -(u.lam + nu + sum_j (p_j / e)
    exp(-(H'lam)_j - nu)), the gap f - g, the inequality residual
    max(Hx - u, -x)_+ and the equality residual |1'x - 1|."""
    ar = Arith(precision)
    dt = ar.dtype
    H, u, x, lam = (t.to(dt) for t in (H, u, x, lam))
    nu = nu.to(dt)[:, 0]
    n = H.shape[1]
    xs = torch.clamp_min(x, 1e-30)
    f = (x * (torch.log(xs) + math.log(n))).sum(-1)
    g = -((u * lam).sum(-1) + nu
          + torch.exp(-ar.mm(lam, H) - nu[:, None] - 1.0).sum(-1) / n)
    ineq = torch.maximum((ar.mm(x, H.T) - u).amax(-1), (-x).amax(-1))
    return dict(f=f, gap=f - g, ineq=torch.clamp_min(ineq, 0.0),
                eq=torch.abs(x.sum(-1) - 1.0))


def stalled(x, m, contract):
    """The route's verdict: not (|gap| <= gap_tol and ineq <= feas_tol [and
    eq <= feas_tol]), or a non-finite x."""
    ok = (m["gap"].abs() <= contract["gap_tol"]) & (m["ineq"]
                                                    <= contract["feas_tol"])
    if contract["eq_in_rule"]:
        ok = ok & (m["eq"] <= contract["feas_tol"])
    return ~torch.isfinite(x).all(-1) | ~ok


def control(H, u, contract, precision):
    """The reference in the program's place, computed in ``precision``:
    the route's outputs (x, gap, lam, nu, ineq, eq, stalled)."""
    s = solve(H, u, precision)
    m = measure(H, u, s["x"], s["lam"], s["nu"], precision)
    return dict(x=s["x"], gap=m["gap"], lam=s["lam"], nu=s["nu"],
                ineq=m["ineq"], eq=m["eq"],
                stalled=stalled(s["x"], m, contract))


# the numbers of the comparison that decides ``correct`` in a KL cell
NUMBERS = ("x_err", "obj_err", "gap_err", "dual_err", "res_err",
           "stall_diff")


def _worst(t):
    t = torch.nan_to_num(t.to(torch.float64), nan=math.inf)
    return float(t.max()) if t.numel() else 0.0


def compare(H, u, out, ref, contract):
    """The numbers for one batch, each the worst over its instances.
    ``out``: the route's x (B, n), gap, lam (B, >= k; the first k are the
    rows' multipliers), nu (B, >= 1; the first is the sum-to-one row's),
    ineq, eq and stalled; ``ref``: ``solve`` in f64 on the same H and u.

    * ``x_err``: max |x - x*|.
    * ``obj_err``: max |f(x) - p*|, f measured in f64 at the returned x.
    * ``gap_err``: max |reported gap - the gap measured in f64 at the
      returned (x, lam, nu)|: the certificate the route reports is the one
      it earned.
    * ``dual_err``: max over lam and nu of |z - z*| / (1 + |z*|).
    * ``res_err``: max |reported residual - the residual measured in f64|,
      over the inequality and the equality residual.
    * ``stall_diff``: instances whose ``stalled`` flag differs from the
      route's contract applied to the f64 measurement (an exact count).

    A non-finite number reads +inf."""
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
