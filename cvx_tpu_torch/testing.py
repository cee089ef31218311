"""Test oracles and problem fixtures.

Counterpart of ``cvx_tpu/testing.py``: ``KnownMinimizer``
(cvx/KnownMinimizer.scala:9-74: a closed-form solution attached to a
problem, and a solver result accepted when |f(x) - f*| < tol), the probAB
constraint fixture (cvx/ConstraintSets.scala:39-60) and random constraint
sets feasible by construction (cvx/ConstraintSets.scala:67-89,
Constraints.scala:158-214), drawn from a ``torch.Generator``.  Points are
(n,) or (B, n).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .ops.testmat import random_spd
from .problem.constraint_set import ConstraintSet
from .problem.constraints import LinearBlock, QuadBlock, positivity


@dataclass(frozen=True)
class KnownMinimizer:
    """Oracle: a known minimizer and the objective it minimizes."""

    x_star: Any
    objective: Any

    def _value(self, x):
        return self.objective.value(torch.as_tensor(x))

    @property
    def f_star(self) -> float:
        return float(self._value(self.x_star))

    def is_minimizer(self, x, tol: float = 1e-2) -> bool:
        """|f(x) - f*| < tol (KnownMinimizer.scala:59-63; tol = the
        reference's acceptance tolerance, Runner.scala:30)."""
        return abs(float(self._value(x)) - self.f_star) < tol

    def report(self, x, tol: float = 1e-2) -> str:
        """Comparison report (KnownMinimizer.scala:23-46)."""
        f_val = float(self._value(x))
        ok = abs(f_val - self.f_star) < tol
        dist = float(torch.linalg.vector_norm(
            torch.as_tensor(x) - torch.as_tensor(self.x_star)))
        return (f"f(x) = {f_val:.6e}, f* = {self.f_star:.6e}, "
                f"|f - f*| = {abs(f_val - self.f_star):.2e} "
                f"({'OK' if ok else 'FAIL'} at tol {tol}); "
                f"||x - x*|| = {dist:.2e}")


def prob_ab(n: int, I_A, p_A: float, sgn_A: float, I_B, p_B: float,
            sgn_B: float, device=None) -> ConstraintSet:
    """The P(A)/P(B) fixture (ConstraintSets.scala:39-60): constraints
    sgn*P(E) <= sgn*p on two events plus positivity.  With sgn = -1 both
    and disjoint A, B, p_A + p_B > 1 makes it infeasible."""
    I_A = torch.as_tensor(I_A, device=device)
    if not I_A.dtype.is_floating_point:
        I_A = I_A.to(torch.float64)
    I_B = torch.as_tensor(I_B, device=I_A.device).to(I_A.dtype)
    G = torch.stack([sgn_A * I_A, sgn_B * I_B])
    ub = torch.tensor([sgn_A * p_A, sgn_B * p_B], dtype=I_A.dtype,
                      device=I_A.device)
    return ConstraintSet(blocks=(
        LinearBlock(G=G, c=torch.zeros_like(ub), ub=ub),
        positivity(n, dtype=I_A.dtype, device=I_A.device),
    ))


def random_feasible_constraints(
    gen: torch.Generator, n: int, x0: torch.Tensor,
    num_linear: int = 3, num_quadratic: int = 2, margin: float = 1.0,
) -> ConstraintSet:
    """Random linear + quadratic constraints that hold STRICTLY at x0 (n,)
    (feasible by construction, ConstraintSets.scala:67-89)."""
    opts = dict(dtype=x0.dtype, device=x0.device)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=x0.dtype,
                           device=gen.device).to(x0.device)

    # linear: a.x <= a.x0 + margin
    G = normal((num_linear, n))
    lin = LinearBlock(G=G, c=torch.zeros(num_linear, **opts),
                      ub=G @ x0 + margin)
    # quadratic: x'Px/2 + a.x <= value at x0 + margin
    P = torch.stack([random_spd(gen, n, cond=10.0, dtype=x0.dtype,
                                device=x0.device)
                     for _ in range(num_quadratic)])
    a = normal((num_quadratic, n))
    v0 = a @ x0 + 0.5 * torch.einsum("mij,i,j->m", P, x0, x0)
    quad = QuadBlock(P=P, a=a, r=torch.zeros(num_quadratic, **opts),
                     ub=v0 + margin)
    return ConstraintSet(blocks=(lin, quad))
