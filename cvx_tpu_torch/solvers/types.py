"""Solver configuration and result records.

Counterpart of ``cvx_tpu/solvers/types.py``, which re-designs
cvx/SolverParams.scala (:24-46), cvx/Solution.scala (:32-60) and
cvx/OptimizationState.scala (:22-39).  Records are dataclasses of
tensors with one entry per instance; "missing" diagnostics are NaN, and
per-instance failure modes are boolean flags carried as data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar

import torch


@dataclass(frozen=True)
class SolverParams:
    """Tolerances and line-search parameters.

    Defaults = the reference's standardParams {maxIter 1000, alpha 0.04,
    beta 0.8, tolSolver 1e-8, tolEqSolve 1e-1, tolFeas 1e-7, delta 1e-6}
    (SolverParams.scala:35-46).
    """

    max_iter: int = 1000          # Newton iteration cap per inner solve
    alpha: float = 0.04           # Armijo slope fraction
    beta: float = 0.8             # backtracking factor
    tol: float = 1e-8             # duality-gap / Newton-decrement tolerance
    tol_eq_solve: float = 1e-1    # acceptable KKT relative residual
    tol_feas: float = 1e-7        # inequality feasibility tolerance
    delta: float = 1e-6           # regularization scale (pos-semidef H)
    mu: float = 10.0              # barrier parameter multiplier
    pd_step_frac: float = 0.99    # primal-dual max-step fraction
    phase1_eq_tol: float = 1e-6   # equalities-as-inequalities tolerance
    dual_start: float = 1e-3      # dual problem feasible start value
    ls_max_steps: int = 64        # line-search candidates
    outer_max_iter: int = 100     # barrier/PD outer cap
    kkt_method: str = "aug"
    phase1_kkt_method: str = "aug"
    kkt_refine: int = 2
    chol_delta: float | None = None


@dataclass
class Solution:
    """Final solver result (Solution.scala:32-60).

    Batched routes carry one entry per instance in every leaf: a failing
    instance raises its own ``stalled``/``maxed_out`` flag instead of an
    exception, and ``status`` summarizes the flags as an integer code.
    """

    x: torch.Tensor
    lam: torch.Tensor             # inequality duals
    nu: torch.Tensor              # equality duals (sum-to-one first)
    newton_decrement: torch.Tensor
    duality_gap: torch.Tensor
    eq_gap: torch.Tensor
    norm_grad: torch.Tensor
    norm_dual_residual: torch.Tensor
    iters: torch.Tensor
    maxed_out: torch.Tensor
    stalled: torch.Tensor         # bool: not certified / line search stuck
    # MEASURED max inequality violation max(Hx - u, -x)_+ of the returned
    # iterate: the dual routes renormalize x, so a tiny gap can mask a
    # small constraint violation
    ineq_res: torch.Tensor | None = None

    STATUS_OK: ClassVar[int] = 0
    STATUS_MAXED_OUT: ClassVar[int] = 1
    STATUS_STALLED: ClassVar[int] = 2

    @property
    def status(self) -> torch.Tensor:
        """0 = ok, 1 = hit the iteration cap, 2 = stalled (the reference's
        LineSearchFailedException, as data)."""
        return torch.where(
            self.stalled, self.STATUS_STALLED,
            torch.where(self.maxed_out, self.STATUS_MAXED_OUT,
                        self.STATUS_OK))


@dataclass
class NewtonResult:
    """Result of one inner Newton solve, per instance."""

    x: torch.Tensor
    newton_decrement: torch.Tensor
    norm_grad: torch.Tensor
    eq_gap: torch.Tensor          # ||A x - b|| (NaN when no equalities)
    iters: torch.Tensor
    maxed_out: torch.Tensor       # bool: hit max_iter
    stalled: torch.Tensor         # bool: line search exhausted


@dataclass
class OptState:
    """Snapshot fed to termination criteria (OptimizationState.scala:
    22-39), per instance."""

    norm_grad: torch.Tensor
    newton_decrement: torch.Tensor
    duality_gap: torch.Tensor
    eq_gap: torch.Tensor
    obj_value: torch.Tensor
    norm_dual_residual: torch.Tensor


def standard_criterion(pars: SolverParams):
    """Terminate when duality gap and equality gap are below tol
    (CvxUtils.scala:61-70)."""

    def crit(s: OptState):
        return (s.duality_gap < pars.tol) & (s.eq_gap < pars.tol)

    return crit


def phase1_criterion(pars: SolverParams):
    """Terminate as soon as the objective (max slack) is negative and the
    equality gap is small (CvxUtils.scala:78-87)."""

    def crit(s: OptState):
        return (s.obj_value < 0.0) & (s.eq_gap < 1e-6)

    return crit
