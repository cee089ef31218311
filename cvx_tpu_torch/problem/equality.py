"""Linear equality constraints A x = b.

Counterpart of ``cvx_tpu/problem/equality.py`` (cvx/EqualityConstraint.
scala:16-118): stacking, error norms, phase-I lifts, conversion to +/-
inequalities and the nullspace solution space x = z0 + F u.  A and b are
shared by a batch ((p, n), (p,)) or per instance ((B, p, n), (B, p)).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops._batch import lead, mv, take
from ..ops.nullspace import SolutionSpace, solution_space
from .constraints import LinearBlock


def _cat(a, b, dim):
    """Concatenate two leaves, expanding a shared one to the other's
    batch axis when only one is per instance."""
    base = max(a.dim(), b.dim())
    if a.dim() < base:
        a = a.expand(b.shape[0], *a.shape)
    if b.dim() < base:
        b = b.expand(a.shape[0], *b.shape)
    return torch.cat([a, b], dim=dim)


@dataclass(frozen=True)
class EqualityConstraint:
    A: torch.Tensor   # (p, n) or (B, p, n), p < n, full row rank
    b: torch.Tensor   # (p,) or (B, p)

    @property
    def p(self) -> int:
        return self.A.shape[-2]

    @property
    def dim(self) -> int:
        return self.A.shape[-1]

    def take(self, idx) -> "EqualityConstraint":
        """The equalities of instances ``idx``."""
        return EqualityConstraint(A=take(self.A, 2, idx),
                                  b=take(self.b, 1, idx))

    def residual(self, x):
        """A x - b at points (..., n)."""
        return mv(self.A, x) - lead(self.b, 1, x)

    def error(self, x):
        """||A x - b|| (EqualityConstraint.scala:26)."""
        return torch.linalg.vector_norm(self.residual(x), dim=-1)

    def stack(self, other: "EqualityConstraint") -> "EqualityConstraint":
        """Vertical concatenation (EqualityConstraint.scala:31-37)."""
        return EqualityConstraint(A=_cat(self.A, other.A, -2),
                                  b=_cat(self.b, other.b, -1))

    def lift_phase1(self, extra: int = 1) -> "EqualityConstraint":
        """Append ``extra`` zero columns: the same equalities on (x, s)
        (EqualityConstraint.scala:41-55)."""
        Z = self.A.new_zeros((*self.A.shape[:-1], extra))
        return EqualityConstraint(A=torch.cat([self.A, Z], dim=-1), b=self.b)

    def as_inequalities(self, tol: float) -> LinearBlock:
        """A x = b as the 2p rows Ax <= b + tol, -Ax <= -b + tol
        (EqualityConstraint.scala:84-100)."""
        return LinearBlock(
            G=torch.cat([self.A, -self.A], dim=-2),
            c=self.A.new_zeros((2 * self.p,)),
            ub=torch.cat([self.b + tol, -self.b + tol], dim=-1))

    def affine_pullback(self, z, F) -> "EqualityConstraint":
        """x = z + F u:  (A F) u = b - A z (EqualityConstraint.scala:72-73)."""
        return EqualityConstraint(A=self.A @ F, b=self.b - mv(self.A, z))

    def solution_space(self) -> SolutionSpace:
        return solution_space(self.A, self.b)


def sum_to_one(n: int, dtype=torch.float64, device=None) -> EqualityConstraint:
    """sum(x) = 1 (Constraints.scala:75-80)."""
    return EqualityConstraint(A=torch.ones((1, n), dtype=dtype, device=device),
                              b=torch.ones((1,), dtype=dtype, device=device))


def expectation_eq(w, r: float) -> EqualityConstraint:
    """E[W] = r for discrete W with values w (Constraints.scala:109-117)."""
    return EqualityConstraint(A=w[None, :], b=torch.tensor(
        [r], dtype=w.dtype, device=w.device))
