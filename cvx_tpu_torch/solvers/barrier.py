"""Log-barrier interior-point solver, batched.

Counterpart of ``cvx_tpu/solvers/barrier.py`` (cvx/BarrierSolver.scala:
22-317): the outer continuation over the barrier parameter t (t <- mu t,
duality gap m/t) runs a full inner Newton solve of phi(t, x) = t f(x) -
sum_i log(u_i - g_i(x)) at each stage, with the fused assembly of
``ConstraintSet.barrier_value_grad_hess``.  Both loops are masked loops
over the instance axis (see ``solvers/newton.py``): every instance has its
own t, stage count and flags, those of its unbatched run.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..problem.constraint_set import ConstraintSet
from ..problem.equality import EqualityConstraint
from ..tree import exact_f32
from .newton import NewtonProblem, _no_stop, _run
from .types import OptState, Solution, SolverParams


def promote_points(x0, *others):
    """x0 in the joint floating dtype of itself and ``others`` (mixed
    f32/f64 inputs promote as in the reference, barrier.py:49-52)."""
    dtype = x0.dtype
    for o in others:
        dtype = torch.promote_types(dtype, o)
    return x0.to(dtype)


def initial_t(t0, B, dtype, device):
    """The first barrier parameter of each of B instances: ``t0`` a number
    or a (B,) tensor."""
    if isinstance(t0, torch.Tensor):
        return t0.to(dtype=dtype, device=device).expand(B).clone()
    return torch.full((B,), float(t0), dtype=dtype, device=device)


@exact_f32
def barrier_solve(obj, cnts: ConstraintSet, x0, pars: SolverParams | None = None,
                  eqs: EqualityConstraint | None = None,
                  criterion: Callable | None = None,
                  stop_inner: Callable | None = None,
                  t0: float | torch.Tensor = 1.0) -> Solution:
    """Minimize ``obj`` s.t. ``cnts`` (and ``A x = b``) from STRICTLY
    FEASIBLE points ``x0`` (B, n) by the barrier method.

    ``criterion(OptState) -> bool (B,)`` is the outer termination test
    (BarrierSolver.scala:87,144); default: duality gap m/t < tol and
    equality gap < max(tol, 100 eps).  ``stop_inner(x) -> bool (B,)`` ends
    the inner Newton solves early (phase-I).  ``t0``, the first barrier
    parameter, is a number or one per instance (B,) (a resumed batch).
    Inner stalls do not abort the continuation; a stall while the gap
    bound m/t is still above sqrt(max(tol, 50 eps)) marks the instance
    stalled.
    """
    pars = pars or SolverParams()
    m = cnts.m
    x0 = promote_points(x0, cnts.dtype)
    dtype, dev = x0.dtype, x0.device
    B = x0.shape[0]
    eps = torch.finfo(dtype).eps
    # ||Ax-b|| floors at ~eps * scale: an absolute 1e-8 never fires in f32
    eq_tol = max(pars.tol, 100.0 * eps)
    if criterion is None:
        def criterion(s: OptState):
            return (s.duality_gap < pars.tol) & (s.eq_gap < eq_tol)
    # no point growing t beyond the gap target (plus one decade of margin)
    t_max = 10.0 * pars.mu * m / pars.tol
    hard_stall_gap = math.sqrt(max(pars.tol, 50.0 * eps))

    def full(v, dt=dtype):
        return torch.full((B,), v, dtype=dt, device=dev)

    nan = full(math.nan)
    x = x0
    t = initial_t(t0, B, dtype, dev)
    gap, eq_gap, fval = full(math.inf), full(math.inf), full(math.inf)
    it = full(0, torch.long)
    n_newton = full(0, torch.long)
    hard = full(False, torch.bool)
    t_active = t.clone()

    def cond(gap, eq_gap, fval, it, t):
        done = criterion(OptState(norm_grad=nan, newton_decrement=nan,
                                  duality_gap=gap, eq_gap=eq_gap,
                                  obj_value=fval, norm_dual_residual=nan))
        return ~done & (it < pars.outer_max_iter) & (t <= t_max)

    def stage(c, o, e, tt):
        """The inner problem at barrier parameters tt (one per instance)."""
        return NewtonProblem(
            fgh=lambda x_: c.barrier_value_grad_hess(o, tt, x_),
            in_set=c.satisfied_strictly,
            value_fn=lambda xs: c.barrier_value(o, tt[:, None], xs),
            stop_fn=stop_inner or _no_stop,
            A=None if e is None else e.A, b=None if e is None else e.b)

    go = cond(gap, eq_gap, fval, it, t)
    while bool(go.any()):
        tt = t

        def restrict(idx):
            try:
                return stage(cnts.take(idx), obj.take(idx),
                             None if eqs is None else eqs.take(idx), tt[idx])
            except (AttributeError, NotImplementedError):
                return None

        res = _run(stage(cnts, obj, eqs, tt), x, pars, go, restrict,
                   eq=eqs is not None)
        eq_gap_n = res.eq_gap if eqs is not None else torch.zeros_like(t)
        gap_n = m / t
        hard = hard | (go & res.stalled & (gap_n > hard_stall_gap))
        # the last t at which the iterate moved: at high t in low
        # precision x freezes, and the dual estimate must use the t it
        # actually tracks
        moved = go & torch.any(res.x != x, dim=-1)
        t_active = torch.where(moved, t, t_active)
        x = res.x
        fval = torch.where(go, obj.value(x), fval)
        gap = torch.where(go, gap_n, gap)
        eq_gap = torch.where(go, eq_gap_n, eq_gap)
        n_newton = n_newton + torch.where(go, res.iters, 0)
        t = torch.where(go, pars.mu * t, t)
        it = it + go.to(torch.long)
        go = go & cond(gap, eq_gap, fval, it, t)

    # dual estimate lambda_i = 1 / (t d_i) from the last tracked subproblem
    # (Boyd-Vandenberghe 11.2.2)
    d_exit = cnts.margins(x)
    lam = 1.0 / (t_active[:, None] * d_exit)
    # exit-state sanity: active margins legitimately round to ~0 at the
    # final t, so allow rounding-scale slack
    slack = 100.0 * eps * (1.0 + torch.abs(cnts.ub))
    healthy = (torch.all(torch.isfinite(x), dim=-1)
               & torch.all(torch.isfinite(d_exit), dim=-1)
               & torch.all(d_exit > -slack, dim=-1))
    p = eqs.p if eqs is not None else 0
    return Solution(
        x=x, lam=lam,
        nu=torch.full((B, p), math.nan, dtype=dtype, device=dev),
        newton_decrement=nan, duality_gap=torch.where(healthy, gap, nan),
        eq_gap=eq_gap, norm_grad=nan, norm_dual_residual=nan,
        iters=n_newton, maxed_out=it >= pars.outer_max_iter,
        stalled=hard | ~healthy)
