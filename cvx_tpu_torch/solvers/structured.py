"""Structure-exploiting barrier solver (BR_fast), batched: diagonal Hessian
plus a few dense inequality rows.

Counterpart of ``cvx_tpu/solvers/structured.py``.  The barrier Hessian of

    min f(x)  s.t.  U x <= ub,  x > 0,  A x = b     (f'' diagonal)

is diag(t f'' + 1/x^2) + U^T diag(1/d^2) U, so a Newton step is a Woodbury
solve with a k x k core plus a p x p Schur complement on the equalities:
O(n (k + p)^2) per step instead of O(n^3).

The reference runs one instance in two nested ``lax.while_loop``s and is
vmapped over a batch.  Here the batch is a leading axis and the two loops
are masked loops over it: an instance whose loop has ended keeps its
state, and a loop runs while any instance is still in it.  Each instance
so gets exactly the results, iteration counts and flags of its own
unbatched run.  The shared rows U (k, n) and A (p, n) are one matrix for
the whole batch; ub (B, k), b (B, p) and x0 (B, n) are per instance.
"""

from __future__ import annotations

import contextlib
import math

import torch

from ..ops.cholesky import _chol_nan, default_delta
from ..tree import exact_f32
from .barrier import initial_t
from .types import Solution, SolverParams


_stage_logs: list[list] = []


@contextlib.contextmanager
def record_stages():
    """Within the block, each call of ``barrier_solve_structured`` appends
    to the yielded list the steps of its masked inner loop, one count per
    outer stage (the batch's largest inner count in that stage)."""
    log: list = []
    _stage_logs.append(log)
    try:
        yield log
    finally:
        _stage_logs.remove(log)


def _woodbury_solver(h, U, w, delta):
    """Return solve_h(r) for H = diag(h) + U^T diag(w) U (w > 0), per
    instance: h (B, n), U (k, n) shared, w (B, k); r (B, n) or (B, n, q).
    M = diag(1/w) + U D^-1 U^T (B, k, k) is factored once."""
    k = U.shape[0]
    inv_h = 1.0 / h

    def scale(r):
        return inv_h * r if r.dim() == 2 else inv_h[:, :, None] * r

    if k == 0:
        return scale
    UD = U * inv_h[:, None, :]                     # (B, k, n) = U D^-1
    M = torch.diag_embed(1.0 / w) + UD @ U.T
    # scale-relative shift (an absolute one would swamp M when H ~ t grows)
    s = torch.abs(torch.diagonal(M, dim1=1, dim2=2)).mean(dim=1)
    M = M + (delta * s)[:, None, None] * torch.eye(k, dtype=h.dtype,
                                                   device=h.device)
    L = _chol_nan(M)

    def solve_h(r):
        vec = r.dim() == 2
        rr = r[:, :, None] if vec else r
        y = torch.cholesky_solve(UD @ rr, L)
        out = scale(rr) - UD.transpose(1, 2) @ y
        return out[:, :, 0] if vec else out

    return solve_h


@exact_f32
def barrier_solve_structured(obj, U, ub, A, b, x0,
                             pars: SolverParams | None = None,
                             t0: float | torch.Tensor = 1.0) -> Solution:
    """Barrier method for a batch of  min f(x)  s.t.  U x <= ub,  x > 0,
    A x = b.

    ``obj`` exposes value/grad and the DIAGONAL hess_diag of f at (B, n)
    points (values (B,)); the inequality rows U (k, n) are few and shared;
    positivity of x is built in.  x0 (B, n) must be strictly feasible.
    ``t0``, the first barrier parameter, is a number or one per instance
    (B,).
    Returns a batched Solution (one entry per instance in every leaf).
    """
    pars = pars or SolverParams()
    dtype, dev = x0.dtype, x0.device
    Bt, n = x0.shape
    k, p = U.shape[0], A.shape[0]
    ub = ub.expand(Bt, k)
    b = b.expand(Bt, p)
    m = k + n  # inequality count incl. positivity
    eps = torch.finfo(dtype).eps
    tol = max(pars.tol, 50.0 * eps)
    eq_tol = max(pars.tol, 100.0 * eps)
    delta = pars.chol_delta if pars.chol_delta is not None else \
        default_delta(dtype)
    t_max = 10.0 * pars.mu * m / pars.tol
    # the feasible step range is in closed form (every constraint is linear
    # in s), so a few Armijo candidates below s_max suffice
    n_ls = min(pars.ls_max_steps, 12)
    ls_ts = pars.beta ** torch.arange(n_ls, device=dev).to(dtype)
    hard_stall_gap = math.sqrt(tol)

    def barrier_val(t, x, d):
        return (t * obj.value(x) - torch.log(d).sum(dim=-1)
                - torch.log(x).sum(dim=-1))

    def newton_step(t, x):
        """One step for every instance; returns (x_new, dec, stalled)."""
        d = ub - x @ U.T                            # (B, k) margins
        inv_d = 1.0 / d
        g = t[:, None] * obj.grad(x) + inv_d @ U - 1.0 / x
        h = t[:, None] * obj.hess_diag(x) + 1.0 / (x * x)
        solve_h = _woodbury_solver(h, U, inv_d * inv_d, delta)

        # KKT with equalities: Schur on the p-level, no shift on S (a
        # consistent Schur solve preserves A dx = rhs exactly)
        HiAt = solve_h(A.T.expand(Bt, n, p))        # (B, n, p)
        Hig = solve_h(g)
        S = A @ HiAt                                # (B, p, p)
        S = 0.5 * (S + S.transpose(1, 2))
        Ls = _chol_nan(S)
        rhs_eq = b - x @ A.T
        zr = -(rhs_eq + Hig @ A.T)
        wv = torch.cholesky_solve(zr[:, :, None], Ls)
        dx = -(Hig + (HiAt @ wv)[:, :, 0])
        # the reference relies on this solve keeping A dx = rhs_eq exactly;
        # in floating point dx cancels two terms of size |H^-1 g| ~ t, so
        # A dx misses rhs_eq by ~eps t (6e-5 at t = 5e11 on the n = 12 LP).
        # One correction on the p equality rows, with the same factor,
        # restores A dx = rhs_eq to rounding.  The reference takes no such
        # step, so the two trajectories part at rounding level (the LP's
        # exit then holds sum(x) = 1 to 2e-16 where the reference's drifts
        # to 1e-7); it costs one (p, p) solve a step
        r_eq = rhs_eq - dx @ A.T
        dx = dx + (HiAt @ torch.cholesky_solve(r_eq[:, :, None], Ls))[:, :, 0]

        q = (dx * g).sum(dim=1)
        dec = -q / 2.0

        # closed-form largest feasible step: x + s dx > 0, d - s U dx > 0
        Udx = dx @ U.T
        sx = torch.where(dx < 0, -x / dx, math.inf).amin(dim=1)
        if k > 0:
            sd = torch.where(Udx > 0, d / Udx, math.inf).amin(dim=1)
        else:
            sd = torch.full_like(sx, math.inf)
        s_max = 0.99 * torch.clamp(torch.minimum(sx, sd), max=1.0 / 0.99)
        f0 = barrier_val(t, x, d)

        ss = s_max[:, None] * ls_ts                 # (B, n_ls)
        xs = x[:, None, :] + ss[:, :, None] * dx[:, None, :]
        dss = d[:, None, :] - ss[:, :, None] * Udx[:, None, :]
        ok = torch.all(xs > 0, dim=2) & torch.all(dss > 0, dim=2)
        fs = torch.where(ok, barrier_val(t[:, None], xs, dss), math.inf)
        acc = ok & (fs <= f0[:, None] + pars.alpha * ss * q[:, None])
        any_acc = acc.any(dim=1)
        first = torch.argmax(acc.to(torch.int8), dim=1)
        s = torch.where(any_acc, s_max * ls_ts[first], 0.0)
        # true select + finiteness guard: a blend (0 * NaN) would poison
        # the frozen iterate
        take = (dec > tol) & any_acc & torch.all(torch.isfinite(dx), dim=1)
        x_new = torch.where(take[:, None], x + s[:, None] * dx, x)
        return x_new, dec, (dec > tol) & ~take

    x = x0.clone()
    t = initial_t(t0, Bt, dtype, dev)
    outer_it = torch.zeros(Bt, dtype=torch.long, device=dev)
    n_newton = torch.zeros(Bt, dtype=torch.long, device=dev)
    hard = torch.zeros(Bt, dtype=torch.bool, device=dev)

    def outer_go(x, t, outer_it):
        gap = m / (t / pars.mu)
        eq_err = torch.linalg.vector_norm(b - x @ A.T, dim=1)
        done = (gap < pars.tol) & (eq_err < eq_tol)
        return ~done & (outer_it < pars.outer_max_iter) & (t <= t_max)

    go = outer_go(x, t, outer_it)
    stage_steps = []
    while bool(go.any()):
        # the inner Newton loop, for the instances still in the outer one
        xi = x
        dec = torch.full((Bt,), math.inf, dtype=dtype, device=dev)
        it = torch.zeros(Bt, dtype=torch.long, device=dev)
        stalled = torch.zeros(Bt, dtype=torch.bool, device=dev)
        hard_i = torch.zeros(Bt, dtype=torch.bool, device=dev)
        inner = go & (dec > tol) & (it < pars.max_iter) & ~stalled
        stage_steps.append(0)
        while bool(inner.any()):
            xn, decn, stn = newton_step(t, xi)
            xi = torch.where(inner[:, None], xn, xi)
            dec = torch.where(inner, decn, dec)
            stalled = torch.where(inner, stn, stalled)
            hard_i = hard_i | (inner & stn & (m / t > hard_stall_gap))
            it = it + inner.to(torch.long)
            inner = inner & (dec > tol) & (it < pars.max_iter) & ~stalled
            stage_steps[-1] += 1
        x = torch.where(go[:, None], xi, x)
        n_newton = n_newton + torch.where(go, it, 0)
        hard = hard | (go & hard_i)
        t = torch.where(go, pars.mu * t, t)
        outer_it = outer_it + go.to(torch.long)
        go = go & outer_go(x, t, outer_it)
    for log in _stage_logs:
        log.append(stage_steps)

    # exit-state sanity: active margins at the final t are ~1/(t lam) and
    # legitimately round to ~0 through ub - U x, so allow rounding slack
    d_exit = ub - x @ U.T
    slack = 100.0 * eps * (1.0 + torch.abs(ub))
    healthy = (torch.all(torch.isfinite(x), dim=1)
               & torch.all(torch.isfinite(d_exit), dim=1)
               & torch.all(d_exit > -slack, dim=1)
               & torch.all(x > 0, dim=1))
    t_solved = t / pars.mu
    lam = torch.cat([1.0 / (t_solved[:, None] * d_exit),
                     1.0 / (t_solved[:, None] * x)], dim=1)
    nan = torch.full((Bt,), math.nan, dtype=dtype, device=dev)
    return Solution(
        x=x, lam=lam, nu=torch.full((Bt, p), math.nan, dtype=dtype,
                                    device=dev),
        newton_decrement=nan,
        # the continuation bound m/t is meaningless for an unhealthy exit
        duality_gap=torch.where(healthy, m / t_solved, math.nan),
        eq_gap=torch.linalg.vector_norm(b - x @ A.T, dim=1), norm_grad=nan,
        norm_dual_residual=nan, iters=n_newton,
        maxed_out=outer_it >= pars.outer_max_iter,
        stalled=hard | ~healthy)
