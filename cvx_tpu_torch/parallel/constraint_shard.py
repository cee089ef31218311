"""Constraint-axis sharded barrier and primal-dual solvers (the SP/CP
analogue).

Counterpart of ``cvx_tpu/parallel/constraint_shard.py``.  The barrier
gradient and Hessian are reductions over the m constraints
(cvx/BarrierSolver.scala:303-315):

    grad = t g0 + sum_i  G_i / d_i
    hess = t H0 + sum_i [G_i G_i^T / d_i^2]          (linear constraints)

For m >> n the constraint data dominates memory and the reduction
dominates the work, so the rows (G, c, ub) -- and in the primal-dual
method lambda -- are split over the ranks of a ``Mesh``.  Each Newton
iteration:

  1. computes its partial margins / gradient / Hessian on its rows,
  2. all-reduces the (n,) gradient and the (n, n) Hessian (one buffer
     with the barrier's log sum),
  3. solves the replicated (n + p) KKT system identically on every rank,
  4. line-searches with one all-reduced (2, n_ls) buffer: the candidates'
     log sums and infeasible counts.

Every loop exit is taken from all-reduced values and agreed over the mesh
(``Mesh.agree``), so the ranks run the same iterations.

One instance: x0 is (n,), replicated.  The whole constraint data is given
on every rank (the reference's global arrays); a rank keeps its rows.
The returned ``lam`` is gathered whole on every rank.

  * ``barrier_solve_msharded``       -- raw linear rows (G, c, ub), the
                                        line search's margins updated
                                        incrementally;
  * ``barrier_solve_msharded_cnts``  -- a GENERIC ConstraintSet (linear
                                        and quadratic blocks), every block
                                        row-sharded;
  * ``primal_dual_solve_msharded``   -- the reduced-Hessian reduction
                                        sum_i [lam_i hess g_i - (grad g_i)
                                        (grad g_i)' lam_i / f_i]
                                        (PrimalDualSolver.scala:216-240)
                                        all-reduced, lambda sharded with
                                        the rows.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..ops.kkt import kkt_solve, sym_solve
from ..problem.constraint_set import ConstraintSet
from ..problem.constraints import LinearBlock, NonlinearBlock, QuadBlock
from ..problem.sets import _always_true
from ..solvers.newton import ls_steps
from ..solvers.types import Solution, SolverParams
from ..tree import exact_f32
from .mesh import Mesh


def _solve(pars, H, g, x, A_, b_, has_eqs):
    """The replicated Newton-KKT system: H dx + A' w = -g, A dx = b - A x."""
    if has_eqs:
        dx, _, _ = kkt_solve(H, A_, g, b_ - A_ @ x, method=pars.kkt_method,
                             refine=pars.kkt_refine, delta=pars.chol_delta,
                             tol=pars.tol_eq_solve)
    else:
        dx, _ = sym_solve(H, -g, method=pars.kkt_method,
                          refine=pars.kkt_refine, delta=pars.chol_delta,
                          tol=pars.tol_eq_solve)
    return dx


def _reduced_pieces(mesh, obj, t, x, logsum, grad_rows, hess_rows):
    """The barrier value, gradient and Hessian from this rank's row sums
    (sum log d, G' (1/d), G' diag(1/d^2) G [+ the quadratic rows' part]),
    all-reduced in one collective."""
    n = x.shape[-1]
    tot = mesh.sum(torch.cat([logsum.reshape(1), grad_rows,
                              hess_rows.reshape(-1)]))
    return (t * obj.value(x) - tot[0], t * obj.grad(x) + tot[1:n + 1],
            t * obj.hess(x) + tot[n + 1:].reshape(n, n))


def _run_msharded_barrier(obj, pars, x0, t0, *, mesh, m, has_eqs, A_, b_,
                          fgh, ls_margins, exit_margins, exit_scale):
    """The m-sharded barrier continuation, shared by the raw-rows and the
    ConstraintSet front ends (they differ only in how margins are
    evaluated).  Callbacks, all over this rank's rows:

      * ``fgh(t, x) -> (val, grad, hess)``, all-reduced barrier pieces;
      * ``ls_margins(x, dx, ls_ts) -> (n_ls, m_loc)`` candidate margins;
      * ``exit_margins(x) -> (m_loc,)`` margins at the exit iterate;
      * ``exit_scale``: (m_loc,) scale (|ub|) of the exit health band.

    Returns ``(x, lam_loc, gap, eq_gap, n_newton, maxed, stalled)``.
    """
    dtype, dev = x0.dtype, x0.device
    eps = torch.finfo(dtype).eps
    tol = max(pars.tol, 50.0 * eps)
    eq_tol = max(pars.tol, 100.0 * eps)
    t_max = 10.0 * pars.mu * m / pars.tol
    ls_ts = ls_steps(pars, pars.ls_max_steps, dtype, dev)
    sqrt_tol = hard_stall_gap = math.sqrt(tol)

    def newton_step(t, x):
        val, g, H = fgh(t, x)
        dx = _solve(pars, H, g, x, A_, b_, has_eqs)
        q = dx @ g
        dec = -q / 2.0
        # every candidate at once: one all-reduce for the log sums and the
        # feasibility counts
        ds = ls_margins(x, dx, ls_ts)              # (n_ls, m_loc)
        bad, logs = mesh.sum(torch.stack([
            (~torch.all(ds > 0, dim=1)).to(dtype),
            torch.log(torch.where(ds > 0, ds, 1.0)).sum(dim=1)]))
        ok = bad == 0
        fs = t * obj.value(x + ls_ts[:, None] * dx) - logs
        fs = torch.where(ok, fs, math.inf)
        acc = ok & (fs <= val + pars.alpha * ls_ts * q)
        # Newton's last step.  From dec <= sqrt(tol) a full step reaches
        # dec ~ dec^2 <= tol, the loop's own exit, and Armijo holds at s = 1
        # in exact arithmetic (a self-concordant barrier); when it fails
        # there, it fails by rounding: at t ~ 1e10-1e13 the value's noise
        # (~1e-4-1e-2) exceeds alpha |q|.  So a feasible full step is taken
        # and the stage ends; otherwise null steps (a change below val's
        # rounding) pass ``fs <= val + alpha s q`` and the last stage runs
        # at dec's rounding floor (~5e-7 > tol) until a search fails by
        # chance, hundreds of steps
        last = (dec <= sqrt_tol) & ok[0] & ~acc[0]
        any_acc = acc.any() | last
        s = torch.where(last, 1.0, torch.where(
            any_acc, ls_ts[torch.argmax(acc.to(torch.int8))], 0.0))
        take = (dec > tol) & any_acc & torch.all(torch.isfinite(dx))
        x_new = torch.where(take, x + s * dx, x)
        return x_new, dec, (dec > tol) & ~take, last & take

    def inner(t, x):
        dec = torch.tensor(math.inf, dtype=dtype, device=dev)
        it, stalled = 0, torch.tensor(False, device=dev)
        hard = ended = torch.tensor(False, device=dev)
        while it < pars.max_iter and mesh.agree((dec > tol) & ~stalled
                                                & ~ended):
            x, dec, stalled, ended = newton_step(t, x)
            hard = hard | (stalled & (m / t > hard_stall_gap))
            it += 1
        return x, it, hard

    def eq_ok(x):
        if not has_eqs:
            return True
        return bool(torch.linalg.vector_norm(b_ - A_ @ x) < eq_tol)

    x = x0
    t = float(torch.tensor(t0, dtype=dtype))
    t_active = t
    outer_it, n_newton = 0, 0
    hard = torch.tensor(False, device=dev)
    while mesh.agree(not (m / (t / pars.mu) < pars.tol and eq_ok(x))
                     and outer_it < pars.outer_max_iter and t <= t_max):
        x_new, inner_it, hard_i = inner(t, x)
        # the last t at which the iterate moved: the dual estimate must use
        # the t that x tracks (as solvers/barrier.py's t_active)
        if mesh.agree(bool(torch.any(x_new != x))):
            t_active = t
        x = x_new
        t = float(torch.tensor(pars.mu * t, dtype=dtype))
        outer_it += 1
        n_newton += inner_it
        hard = hard | hard_i

    t_solved = t / pars.mu
    d_exit = exit_margins(x)
    lam = 1.0 / (t_active * d_exit)           # this rank's duals
    bad_exit = mesh.sum((~(torch.all(torch.isfinite(d_exit))
                           & torch.all(d_exit > -100.0 * eps * (
                               1.0 + torch.abs(exit_scale))))).to(dtype))
    healthy = torch.all(torch.isfinite(x)) & (bad_exit == 0)
    # the bound in the iterate's dtype (two Python floats would make a
    # tensor of the default dtype, f32)
    gap = torch.where(healthy, torch.tensor(m / t_solved, dtype=dtype,
                                            device=dev), math.nan)
    eq_gap = (torch.linalg.vector_norm(b_ - A_ @ x) if has_eqs
              else torch.zeros((), dtype=dtype, device=dev))
    return (x, lam, gap, eq_gap, n_newton, outer_it >= pars.outer_max_iter,
            hard | ~healthy)


def _msharded_solution(mesh, out, p, dtype):
    x, lam, gap, eq_gap, iters, maxed, stalled = out
    dev = x.device
    nan = torch.tensor(math.nan, dtype=dtype, device=dev)
    return Solution(
        x=x, lam=mesh.gather(lam),
        nu=torch.full((p,), math.nan, dtype=dtype, device=dev),
        newton_decrement=nan, duality_gap=gap, eq_gap=eq_gap,
        norm_grad=nan, norm_dual_residual=nan,
        iters=torch.tensor(iters, device=dev),
        maxed_out=torch.tensor(maxed, device=dev), stalled=stalled)


def _equalities(A, b, x0):
    if A is not None:
        return True, A.shape[0], A, b
    # a zero-row equality block keeps one code path
    return (False, 0, x0.new_zeros((0, x0.shape[0])), x0.new_zeros((0,)))


@exact_f32
def barrier_solve_msharded(obj: Any, G, c, ub, x0,
                           pars: SolverParams | None = None, A=None, b=None,
                           *, mesh: Mesh, axis: str = "m",
                           t0: float = 1.0) -> Solution:
    """Barrier method for  min f(x)  s.t.  c + G x <= ub  (+ A x = b), with
    the m constraint rows split over ``mesh``.

    ``x0`` (n,) must be strictly feasible; m must divide by the mesh size.
    Returns a Solution whose ``lam`` is the (m,) barrier dual estimate.
    """
    pars = pars or SolverParams()
    mesh.check_axis(axis)
    m = G.shape[0]
    rows = mesh.local_rows(m, "constraint rows")
    G, cc, ub = G[rows], c[rows], ub[rows]
    has_eqs, p, A_, b_ = _equalities(A, b, x0)

    def margins(x):
        return ub - cc - G @ x

    def fgh(t, x):
        d = margins(x)
        inv_d = 1.0 / d
        # partial barrier pieces on this rank's rows, all-reduced: the
        # m-sharded BarrierSolver.scala:303-315
        return _reduced_pieces(mesh, obj, t, x, torch.log(d).sum(),
                               G.T @ inv_d, (G.T * (inv_d * inv_d)) @ G)

    def ls_margins(x, dx, ls_ts):
        # linear rows: d - s G dx, no re-evaluation
        return margins(x)[None, :] - ls_ts[:, None] * (G @ dx)[None, :]

    out = _run_msharded_barrier(
        obj, pars, x0, t0, mesh=mesh, m=m, has_eqs=has_eqs, A_=A_, b_=b_,
        fgh=fgh, ls_margins=ls_margins, exit_margins=margins,
        exit_scale=ub)
    return _msharded_solution(mesh, out, p, x0.dtype)


def _check_shardable(cnts: ConstraintSet, n_dev: int):
    """Every block's rows must divide by the mesh size; a NonlinearBlock
    (one callable returning all its rows) cannot be split by rows."""
    for blk in cnts.blocks:
        if isinstance(blk, NonlinearBlock):
            raise ValueError(
                "m-sharding needs array-backed blocks (Linear/Quad); a "
                "NonlinearBlock's callable produces all rows at once")
        if blk.m % n_dev != 0:
            raise ValueError(
                f"block with m={blk.m} rows not divisible by mesh axis size "
                f"{n_dev}")
    if cnts.domain.fn is not _always_true:
        # the sharded line searches test only constraint margins, so a
        # nontrivial domain's membership test would be skipped
        raise ValueError(
            "m-sharding supports only the trivial whole-space domain: the "
            "sharded line searches check constraint margins only, so a "
            "nontrivial domain membership test cannot be enforced")


def _margins_each(cl: ConstraintSet, xs):
    """Margins at each point of a stack (L, n), one point at a time: a
    quadratic block given the stack would broadcast its (m, n, n) rows
    over it."""
    return torch.stack([cl.margins(x) for x in xs])


def _local_cnts(cnts: ConstraintSet, mesh: Mesh) -> ConstraintSet:
    """This rank's rows of every block."""
    blocks = []
    for blk in cnts.blocks:
        r = mesh.local_rows(blk.m, "constraint rows")
        if isinstance(blk, LinearBlock):
            blocks.append(LinearBlock(G=blk.G[r], c=blk.c[r], ub=blk.ub[r],
                                      label=blk.label))
        elif isinstance(blk, QuadBlock):
            blocks.append(QuadBlock(P=blk.P[r], a=blk.a[r], r=blk.r[r],
                                    ub=blk.ub[r], label=blk.label))
        else:
            raise ValueError(f"m-sharding: unsupported block {type(blk)}")
    return ConstraintSet(blocks=tuple(blocks), domain=cnts.domain)


@exact_f32
def barrier_solve_msharded_cnts(obj: Any, cnts: ConstraintSet, x0,
                                pars: SolverParams | None = None, eqs=None,
                                *, mesh: Mesh, axis: str = "m",
                                t0: float = 1.0) -> Solution:
    """Constraint-axis sharded barrier for a GENERIC ``ConstraintSet``
    (linear and quadratic blocks): each rank holds its rows of every
    block; the barrier value/gradient/Hessian reductions are all-reduced,
    the replicated KKT system is solved identically on every rank, and the
    line search re-evaluates this rank's margins per candidate (quadratic
    rows are not linear in the step).

    ``x0`` (n,) must be strictly feasible; every block's row count must
    divide by the mesh size.  Returns the whole (m,) ``lam``.
    """
    pars = pars or SolverParams()
    mesh.check_axis(axis)
    _check_shardable(cnts, mesh.size)
    m = cnts.m
    cl = _local_cnts(cnts, mesh)
    has_eqs, p, A_, b_ = _equalities(
        None if eqs is None else eqs.A, None if eqs is None else eqs.b, x0)

    def fgh(t, x):
        d = cl.margins(x)
        inv_d = 1.0 / d
        G = cl.jac(x)
        return _reduced_pieces(mesh, obj, t, x, torch.log(d).sum(),
                               G.T @ inv_d, (G.T * (inv_d * inv_d)) @ G
                               + cl.whess(x, inv_d))

    def ls_margins(x, dx, ls_ts):
        return _margins_each(cl, x + ls_ts[:, None] * dx)

    out = _run_msharded_barrier(
        obj, pars, x0, t0, mesh=mesh, m=m, has_eqs=has_eqs, A_=A_, b_=b_,
        fgh=fgh, ls_margins=ls_margins, exit_margins=cl.margins,
        exit_scale=cl.ub)
    return _msharded_solution(mesh, out, p, x0.dtype)


@exact_f32
def primal_dual_solve_msharded(obj: Any, cnts: ConstraintSet, x0,
                               pars: SolverParams | None = None, eqs=None,
                               *, mesh: Mesh, axis: str = "m") -> Solution:
    """Constraint-axis sharded infeasible-start primal-dual method.

    The reduced-Hessian reduction over constraints
    H_pd = hess f + sum_i [lam_i hess g_i - (grad g_i grad g_i') lam_i/f_i]
    (PrimalDualSolver.scala:216-240) is sharded like the barrier's: each
    rank holds its rows of every block AND the matching part of lambda;
    per iteration it all-reduces the (n, n) partial Hessian, the (n,)
    dual-residual and rhs contributions, the surrogate gap -f.lam, the
    smallest dual step ratio, the line search's feasibility count and the
    residual norms.  The replicated KKT system is solved identically on
    every rank.  Returns the whole (m,) ``lam``.
    """
    pars = pars or SolverParams()
    mesh.check_axis(axis)
    _check_shardable(cnts, mesh.size)
    m = cnts.m
    cl = _local_cnts(cnts, mesh)
    dtype, dev = x0.dtype, x0.device
    nan = torch.tensor(math.nan, dtype=dtype, device=dev)
    has_eqs, p, A_, b_ = _equalities(
        None if eqs is None else eqs.A, None if eqs is None else eqs.b, x0)
    ls_max = int(-30.0 / math.log(pars.beta)) + 1
    eps = torch.finfo(dtype).eps
    gap_tol = max(pars.tol, 50.0 * eps)
    res_tol = max(pars.tol, 1e3 * eps)

    def res_norm2(t, x, lam, nu):
        """||r_t||^2 = ||r_dual||^2 + sum over ranks ||r_cent||^2 +
        ||r_pri||^2, per candidate (leading axes of x)."""
        f = cl.residual(x)
        G = cl.jac(x)
        r_dual = obj.grad(x) + mesh.sum((G.mT @ lam[..., None])[..., 0])
        if has_eqs:
            r_dual = r_dual + nu @ A_
        r_cent = -lam * f - 1.0 / t
        n2 = (r_dual * r_dual).sum(dim=-1) + mesh.sum(
            (r_cent * r_cent).sum(dim=-1))
        if has_eqs:
            r_pri = x @ A_.T - b_
            n2 = n2 + (r_pri * r_pri).sum(dim=-1)
        return n2

    def surrogate_gap(x, lam):
        return -mesh.sum(cl.residual(x) @ lam)

    x, lam = x0, cl.lambda_init(x0)
    nu = torch.zeros((p,), dtype=dtype, device=dev)
    gap = surrogate_gap(x0, lam)
    ndr = torch.tensor(math.inf, dtype=dtype, device=dev)
    eq_gap = torch.tensor(math.inf, dtype=dtype, device=dev)
    it, stalled = 0, torch.tensor(False, device=dev)
    kk = ls_steps(pars, ls_max, dtype, dev)

    def go(gap, ndr, eq_gap, stalled):
        ok = (gap < gap_tol) & (ndr < res_tol)
        if has_eqs:
            ok = ok & (eq_gap < math.sqrt(gap_tol))
        return ~ok & ~stalled

    while it < 2 * pars.outer_max_iter and mesh.agree(
            go(gap, ndr, eq_gap, stalled)):
        eta = surrogate_gap(x, lam)
        t = pars.mu * m / eta
        f = cl.residual(x)
        G = cl.jac(x)
        inv_f = 1.0 / f
        H_pd = obj.hess(x) + mesh.sum(cl.whess(x, lam)
                                      + (G.T * (-lam * inv_f)) @ G)
        rhs_top = -obj.grad(x) + (1.0 / t) * mesh.sum(G.T @ inv_f)
        if has_eqs:
            rhs_top = rhs_top - A_.T @ nu
            dx, dnu, _ = kkt_solve(H_pd, A_, -rhs_top, -(A_ @ x - b_),
                                   method=pars.kkt_method,
                                   refine=pars.kkt_refine,
                                   delta=pars.chol_delta,
                                   tol=pars.tol_eq_solve)
        else:
            dx, _ = sym_solve(H_pd, rhs_top, method=pars.kkt_method,
                              refine=pars.kkt_refine, delta=pars.chol_delta,
                              tol=pars.tol_eq_solve)
            dnu = torch.zeros_like(nu)
        r_cent = -lam * f - 1.0 / t
        dlam = (-lam * (G @ dx) + r_cent) * inv_f
        ratios = torch.where(dlam < 0, -lam / dlam, math.inf)
        s0 = pars.pd_step_frac * torch.clamp_max(mesh.min(ratios.min()), 1.0)
        norm2_rt = res_norm2(t, x, lam, nu)
        ss = s0 * kk                                          # (L,)
        xs = x + ss[:, None] * dx
        lams = lam + ss[:, None] * dlam
        nus = nu + ss[:, None] * dnu
        feas = mesh.sum((~torch.all(_margins_each(cl, xs) > 0.0, dim=-1))
                        .to(dtype)) == 0
        dec = (torch.sqrt(res_norm2(t, xs, lams, nus))
               <= (1.0 - pars.alpha * ss) * torch.sqrt(norm2_rt))
        accepts = feas & dec
        ok = (accepts.any() & torch.all(torch.isfinite(dx))
              & mesh.all(torch.all(torch.isfinite(dlam))))
        stalled = ~ok
        s = torch.where(ok, ss[torch.argmax(accepts.to(torch.int8))], 0.0)
        x = torch.where(ok, x + s * dx, x)
        lam = torch.where(ok, lam + s * dlam, lam)
        nu = torch.where(ok, nu + s * dnu, nu)
        gap = surrogate_gap(x, lam)
        r_dual = obj.grad(x) + mesh.sum(cl.jac(x).T @ lam)
        if has_eqs:
            r_dual = r_dual + A_.T @ nu
            eq_gap = torch.linalg.vector_norm(A_ @ x - b_)
        else:
            eq_gap = torch.zeros((), dtype=dtype, device=dev)
        ndr = torch.linalg.vector_norm(r_dual)
        it += 1
    return Solution(
        x=x, lam=mesh.gather(lam), nu=nu, newton_decrement=nan,
        duality_gap=gap, eq_gap=eq_gap, norm_grad=nan,
        norm_dual_residual=ndr, iters=torch.tensor(it, device=dev),
        maxed_out=torch.tensor(it >= 2 * pars.outer_max_iter, device=dev),
        stalled=stalled)
