"""Infeasible-start primal-dual interior-point solver, batched.

Counterpart of ``cvx_tpu/solvers/primal_dual.py`` (cvx/PrimalDualSolver.
scala:18-728, Boyd-Vandenberghe 11.7).  One masked loop over the instance
axis carries (x, lambda, nu); each iteration:

  residuals:  r_dual = grad f + Dg^T lambda (+ A^T nu)
              r_cent = -diag(lambda) f(x) - (1/t) 1      (f = g - ub < 0)
              r_pri  = A x - b
  reduced KKT (11.56):  H_pd = hess f + sum_i lambda_i hess g_i
                               + Dg^T diag(-lambda/f) Dg
  rhs (11.55):  H_pd dx + A^T dnu = -grad f - A^T nu + (1/t) Dg^T (1/f),
                A dx = -r_pri
  dlambda_i = (-lambda_i (Dg dx)_i + r_cent_i) / f_i
  step: s = 0.99 min(1, min_{dl<0} -l/dl), then every backtracking
  candidate at once, kept where strictly feasible and ||r_t|| fell by
  (1 - alpha s);  t = mu m / eta,  eta = -f(x).lambda.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops._batch import mv
from ..ops.kkt import kkt_solve, sym_solve
from ..problem.constraint_set import ConstraintSet, gtwg
from ..problem.equality import EqualityConstraint
from ..tree import exact_f32
from .barrier import promote_points
from .newton import ls_steps
from .types import OptState, Solution, SolverParams


@exact_f32
def primal_dual_solve(obj, cnts: ConstraintSet, x0,
                      pars: SolverParams | None = None,
                      eqs: EqualityConstraint | None = None,
                      criterion: Callable | None = None) -> Solution:
    """Minimize ``obj`` s.t. ``cnts`` (and ``A x = b``) from strictly
    feasible points ``x0`` (B, n).  Default termination
    (PrimalDualSolver.scala:630-631): surrogate gap and dual-residual norm
    below max(tol, 50 eps) and max(tol, 1e3 eps), and the equality gap
    below the square root of the first, where equalities exist."""
    pars = pars or SolverParams()
    m = cnts.m
    x0 = promote_points(x0, cnts.dtype)
    dtype, dev = x0.dtype, x0.device
    B = x0.shape[0]
    has_eqs = eqs is not None
    p = eqs.p if has_eqs else 0
    # backtracking candidates down to beta^k < 1e-13
    # (PrimalDualSolver.scala:354)
    ls_max = int(-30.0 / math.log(pars.beta)) + 1
    eps = torch.finfo(dtype).eps
    if criterion is None:
        gap_tol = max(pars.tol, 50.0 * eps)
        res_tol = max(pars.tol, 1e3 * eps)

        def criterion(s: OptState):
            ok = (s.duality_gap < gap_tol) & (s.norm_dual_residual < res_tol)
            if has_eqs:
                ok = ok & (s.eq_gap < math.sqrt(gap_tol))
            return ok

    def residual(t, x, lam, nu):
        """The full residual vector r_t = (r_dual, r_cent[, r_pri])."""
        f = cnts.residual(x)
        r_dual = obj.grad(x) + mv(cnts.jac(x).mT, lam)
        if has_eqs:
            r_dual = r_dual + mv(eqs.A.mT, nu)
        parts = [r_dual, -lam * f - 1.0 / t]
        if has_eqs:
            parts.append(eqs.residual(x))
        return torch.cat(parts, dim=-1)

    def surrogate_gap(x, lam):
        return -(cnts.residual(x) * lam).sum(dim=-1)

    nan = torch.full((B,), math.nan, dtype=dtype, device=dev)
    x = x0
    lam = cnts.lambda_init(x0)      # -1/f_i (ConstraintSet.scala:116-120)
    nu = torch.zeros((B, p), dtype=dtype, device=dev)
    gap = surrogate_gap(x0, lam)
    ndr = torch.full((B,), math.inf, dtype=dtype, device=dev)
    eq_gap = torch.full((B,), math.inf, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.long, device=dev)
    stalled = torch.zeros(B, dtype=torch.bool, device=dev)
    kk = ls_steps(pars, ls_max, dtype, dev)

    def cond(x, gap, ndr, eq_gap, it, stalled):
        state = OptState(norm_grad=nan, newton_decrement=nan,
                         duality_gap=gap, eq_gap=eq_gap,
                         obj_value=obj.value(x), norm_dual_residual=ndr)
        return (~criterion(state) & (it < 2 * pars.outer_max_iter)
                & ~stalled)

    go = cond(x, gap, ndr, eq_gap, it, stalled)
    while bool(go.any()):
        eta = surrogate_gap(x, lam)
        t = pars.mu * m / eta
        f = cnts.residual(x)
        G = cnts.jac(x)
        inv_f = 1.0 / f
        # reduced KKT matrix H_pd (11.56)
        H_pd = obj.hess(x) + cnts.whess(x, lam) + gtwg(G, -lam * inv_f)
        rhs_top = -obj.grad(x) + (1.0 / t)[:, None] * mv(G.mT, inv_f)
        if has_eqs:
            rhs_top = rhs_top - mv(eqs.A.mT, nu)
            dx, dnu, _ = kkt_solve(H_pd, eqs.A, -rhs_top, -eqs.residual(x),
                                   method=pars.kkt_method,
                                   refine=pars.kkt_refine,
                                   delta=pars.chol_delta,
                                   tol=pars.tol_eq_solve)
        else:
            dx, _ = sym_solve(H_pd, rhs_top, method=pars.kkt_method,
                              refine=pars.kkt_refine, delta=pars.chol_delta,
                              tol=pars.tol_eq_solve)
            dnu = torch.zeros_like(nu)
        r_cent = -lam * f - (1.0 / t)[:, None]
        dlam = (-lam * mv(G, dx) + r_cent) * inv_f
        # the largest s keeping lambda > 0, then every candidate at once
        ratios = torch.where(dlam < 0, -lam / dlam, math.inf)
        s0 = pars.pd_step_frac * torch.clamp_max(ratios.amin(dim=-1), 1.0)
        norm_rt = torch.linalg.vector_norm(residual(t[:, None], x, lam, nu),
                                           dim=-1)
        ss = s0[:, None] * kk                                   # (B, L)
        xs = x[:, None] + ss[..., None] * dx[:, None]
        lams = lam[:, None] + ss[..., None] * dlam[:, None]
        nus = nu[:, None] + ss[..., None] * dnu[:, None]
        feas = cnts.satisfied_strictly(xs)
        dec = (torch.linalg.vector_norm(
            residual(t[:, None, None], xs, lams, nus), dim=-1)
            <= (1.0 - pars.alpha * ss) * norm_rt[:, None])
        accepts = feas & dec
        # true select + finiteness guard (0 * inf would poison x)
        ok = (accepts.any(dim=1) & torch.all(torch.isfinite(dx), dim=-1)
              & torch.all(torch.isfinite(dlam), dim=-1))
        idx = torch.argmax(accepts.to(torch.int8), dim=1, keepdim=True)
        s = torch.where(ok, ss.gather(1, idx)[:, 0], 0.0)
        move = go & ok
        x = torch.where(move[:, None], x + s[:, None] * dx, x)
        lam = torch.where(move[:, None], lam + s[:, None] * dlam, lam)
        nu = torch.where(move[:, None], nu + s[:, None] * dnu, nu)
        gap = torch.where(go, surrogate_gap(x, lam), gap)
        r_dual = obj.grad(x) + mv(cnts.jac(x).mT, lam)
        if has_eqs:
            r_dual = r_dual + mv(eqs.A.mT, nu)
            eq_gap = torch.where(go, eqs.error(x), eq_gap)
        else:
            eq_gap = torch.where(go, 0.0, eq_gap)
        ndr = torch.where(go, torch.linalg.vector_norm(r_dual, dim=-1), ndr)
        stalled = torch.where(go, ~ok, stalled)
        it = it + go.to(torch.long)
        go = go & cond(x, gap, ndr, eq_gap, it, stalled)
    return Solution(
        x=x, lam=lam, nu=nu, newton_decrement=nan, duality_gap=gap,
        eq_gap=eq_gap, norm_grad=nan, norm_dual_residual=ndr, iters=it,
        maxed_out=it >= 2 * pars.outer_max_iter, stalled=stalled)
