"""Problem-level API.

Counterpart of ``cvx_tpu/api.py`` (cvx/OptimizationProblem.scala:14-199):
build a problem from an objective, an inequality ConstraintSet and
optional equality constraints; run phase-I when no strictly feasible
point is given; solve with method "BR" (log-barrier), "PD" (primal-dual)
or "BR_fast" (the structured Woodbury barrier).

Points are (B, n), one instance each against the problem's shared or
per-instance leaves, or (n,) for one instance (the Solution then has no
batch axis).  The problem is moved to ``device``, by default the card.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from . import tree
from .problem.constraint_set import ConstraintSet, _cat_last
from .problem.constraints import LinearBlock
from .problem.equality import EqualityConstraint
from .solvers.barrier import barrier_solve
from .solvers.newton import newton_minimize, newton_minimize_eq
from .solvers.phase1 import find_feasible_point
from .solvers.primal_dual import primal_dual_solve
from .solvers.structured import barrier_solve_structured
from .solvers.types import Solution, SolverParams


def minimize(
    objective: Any,
    constraints: ConstraintSet | None = None,
    equalities: EqualityConstraint | None = None,
    *,
    x0=None,
    feasible_point=None,
    method: str = "BR",
    pars: SolverParams | None = None,
    phase1_method: str = "auto",
    device=None,
) -> Solution:
    """Solve  min f(x)  s.t.  g_i(x) <= u_i,  A x = b.

    ``x0``: points where all constraints are DEFINED (phase-I starts
    there when no ``feasible_point`` is given, OptimizationProblem.scala:
    174-196).  ``feasible_point``: strictly feasible starts (no phase-I,
    OptimizationProblem.scala:133-157).  ``device`` (default: the card,
    ``"cuda"``) is where the problem and the points are moved and solved;
    pass ``device="cpu"`` for the CPU.
    """
    pars = pars or SolverParams()
    if method not in ("BR", "PD", "BR_fast"):
        raise ValueError(f"unknown solver method: {method!r} "
                         "(use 'BR'/'PD'/'BR_fast')")
    dev = torch.device("cuda" if device is None else device)
    objective, constraints, equalities = tree.to(
        (objective, constraints, equalities), dev)
    start = feasible_point if feasible_point is not None else x0
    if start is None:
        raise ValueError("x0 (or feasible_point) required")
    single = torch.as_tensor(start).dim() == 1

    def points(x):
        x = torch.as_tensor(x).to(dev)
        return x[None] if x.dim() == 1 else x

    if constraints is None:
        # unconstrained (possibly equality-constrained) Newton
        # (OptimizationProblem.scala:101-115)
        x0 = points(start)

        def fgh(x):
            return objective.value(x), objective.grad(x), objective.hess(x)

        def free(x):
            return torch.ones(x.shape[:-1], dtype=torch.bool,
                              device=x.device)

        if equalities is None:
            res = newton_minimize(fgh, free, x0, pars,
                                  value_fn=objective.value)
        else:
            res = newton_minimize_eq(fgh, free, x0, equalities.A,
                                     equalities.b, pars,
                                     value_fn=objective.value)
        B, dtype = x0.shape[0], res.x.dtype
        nan = torch.full((B,), math.nan, dtype=dtype, device=dev)
        p = equalities.p if equalities is not None else 0
        sol = Solution(
            x=res.x, lam=torch.zeros((B, 0), dtype=dtype, device=dev),
            nu=torch.full((B, p), math.nan, dtype=dtype, device=dev),
            newton_decrement=res.newton_decrement, duality_gap=nan,
            eq_gap=res.eq_gap, norm_grad=res.norm_grad,
            norm_dual_residual=nan, iters=res.iters,
            maxed_out=res.maxed_out, stalled=res.stalled)
        return tree.instance(sol) if single else sol

    if feasible_point is None:
        feasible_point = find_feasible_point(
            constraints, points(x0), pars, equalities, method=phase1_method)
    xf = points(feasible_point)

    if method == "BR_fast":
        # structured Woodbury barrier: a diagonal-Hessian objective
        # (hess_diag), all-linear constraints and an explicit positivity
        # block (the structured barrier bakes x > 0 in); a Newton step
        # then costs O(n (k+p)^2) with no (n, n) intermediates
        U, ub = _extract_structured_rows(constraints)
        if not hasattr(objective, "hess_diag"):
            raise ValueError(
                "BR_fast needs an objective with hess_diag (diagonal "
                "Hessian); use method='BR' for dense Hessians")
        if equalities is not None:
            A_, b_ = equalities.A, equalities.b
        else:
            A_ = xf.new_zeros((0, xf.shape[-1]))
            b_ = xf.new_zeros((0,))
        sol = barrier_solve_structured(objective, U, ub, A_, b_, xf, pars)
    elif method == "BR":
        sol = barrier_solve(objective, constraints, xf, pars,
                            eqs=equalities)
    else:
        sol = primal_dual_solve(objective, constraints, xf, pars,
                                eqs=equalities)
    return tree.instance(sol) if single else sol


def _extract_structured_rows(constraints: ConstraintSet):
    """Split a DiagQP-shaped ConstraintSet into (U, ub) dense rows for the
    structured barrier, which handles positivity x > 0 itself.

    Requires: every block linear with shared rows, and exactly one block
    that IS the positivity block -x <= 0 (as built by
    ``problem.constraints.positivity``).  Offsets c are folded into ub (c
    + Gx <= ub  <=>  Gx <= ub - c); ub may be per instance.  Raises
    ValueError when the set is not structured-solvable: use method='BR'.
    """
    n = constraints.dim
    rows, ubs = [], []
    saw_positivity = False
    for blk in constraints.blocks:
        if not isinstance(blk, LinearBlock):
            raise ValueError(
                "BR_fast needs all-linear constraints; found "
                f"{type(blk).__name__} (use method='BR')")
        if blk.G.dim() != 2:
            raise ValueError(
                "BR_fast needs rows shared by the batch; found per-"
                "instance rows (use method='BR')")
        # recognize the positivity block (-I) x <= 0 on the host without
        # a dense identity: n nonzeros, all on the diagonal and equal -1
        G_np = blk.G.detach().cpu().numpy()
        if (blk.m == n and np.count_nonzero(G_np) == n
                and bool(np.all(np.diagonal(G_np) == -1.0))
                and not bool(torch.any(blk.ub - blk.c != 0))):
            saw_positivity = True
            continue
        rows.append(blk.G)
        ubs.append(blk.ub - blk.c)
    if not saw_positivity:
        raise ValueError(
            "BR_fast's structured barrier bakes in x > 0: the constraint "
            "set must contain the positivity block (-I) x <= 0 "
            "(problem.constraints.positivity); use method='BR' otherwise")
    if rows:
        return torch.cat(rows, dim=0), _cat_last(ubs, 1)
    return constraints.ub.new_zeros((0, n)), constraints.ub.new_zeros((0,))
