"""Objective functions, evaluated over a batch of points.

Counterpart of ``cvx_tpu/problem/objective.py`` (cvx/
ObjectiveFunction.scala, cvx/LinearObjectiveFunction.scala,
cvx/QuadraticObjectiveFunction.scala, cvx/ObjectiveFunctions.scala):

  * ``CustomObjective`` wraps one torch function ``fn(params, x)`` of a
    point x (n,) returning a scalar; the gradient is ``torch.func.grad``
    and the Hessian ``torch.func.jacfwd(grad)``, mapped over the points
    with ``torch.func.vmap``;
  * ``LinearObjective`` / ``QuadraticObjective`` are evaluated without
    autodiff.

``value`` takes points (B, n) or (B, L, n) and returns one value per
point; ``grad`` and ``hess`` take (B, n).  Leaves are shared by the batch
in their base shape or per instance with a leading batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.func import grad, jacfwd

from ..ops._batch import lead, mv, take, take_params
from .constraints import over_points


@dataclass(frozen=True)
class CustomObjective:
    """f(x) = fn(params, x) with autodiff-derived gradient and Hessian
    (ObjectiveFunction.scala:12-14).  ``params`` are shared unless
    ``param_dims`` names their batch axes (``torch.func.vmap`` in_dims)."""

    fn: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any = None
    param_dims: Any = None

    def value(self, x):
        return over_points(self.fn, self.params, self.param_dims, x)

    def take(self, idx):
        """The objective of instances ``idx``."""
        return CustomObjective(fn=self.fn, params=take_params(
            self.params, self.param_dims, idx), param_dims=self.param_dims)

    def grad(self, x):
        return over_points(grad(self.fn, argnums=1), self.params,
                           self.param_dims, x)

    def hess(self, x):
        return over_points(jacfwd(grad(self.fn, argnums=1), argnums=1),
                           self.params, self.param_dims, x)


def _dot(a, x):
    """a . x per point: a (n,) shared or (B, n) per instance."""
    return x @ a if a.dim() == 1 else (x * lead(a, 1, x)).sum(dim=-1)


def _expand_hess(P, x):
    n = x.shape[-1]
    return P.expand(*x.shape[:-1], n, n)


@dataclass(frozen=True)
class LinearObjective:
    """f(x) = r + a.x  (LinearObjectiveFunction.scala:19-21)."""

    a: torch.Tensor   # (n,) or (B, n)
    r: torch.Tensor   # () or (B,)

    def value(self, x):
        return lead(self.r, 0, x) + _dot(self.a, x)

    def take(self, idx):
        return LinearObjective(a=take(self.a, 1, idx), r=take(self.r, 0, idx))

    def grad(self, x):
        return lead(self.a, 1, x).expand_as(x)

    def hess(self, x):
        return _expand_hess(x.new_zeros(()), x)


@dataclass(frozen=True)
class QuadraticObjective:
    """f(x) = r + a.x + x'Px/2, P symmetric
    (QuadraticObjectiveFunction.scala:29-36)."""

    P: torch.Tensor   # (n, n) or (B, n, n)
    a: torch.Tensor   # (n,) or (B, n)
    r: torch.Tensor   # () or (B,)

    def value(self, x):
        return (lead(self.r, 0, x) + _dot(self.a, x)
                + 0.5 * (x * mv(self.P, x)).sum(dim=-1))

    def take(self, idx):
        return QuadraticObjective(P=take(self.P, 2, idx),
                                  a=take(self.a, 1, idx),
                                  r=take(self.r, 0, idx))

    def grad(self, x):
        return lead(self.a, 1, x) + mv(self.P, x)

    def hess(self, x):
        return _expand_hess(self.P, x) if self.P.dim() == 2 else self.P


@dataclass(frozen=True)
class AffineObjective:
    """Pullback h(u) = f(z + F u): grad = F' g, hess = F' H F
    (ObjectiveFunction.scala:26-35)."""

    base: Any
    z: torch.Tensor
    F: torch.Tensor

    def take(self, idx):
        return AffineObjective(base=self.base.take(idx),
                               z=take(self.z, 1, idx), F=take(self.F, 2, idx))

    def _x(self, u):
        return lead(self.z, 1, u) + mv(self.F, u)

    def value(self, u):
        return self.base.value(self._x(u))

    def grad(self, u):
        return mv(self.F.mT, self.base.grad(self._x(u)))

    def hess(self, u):
        return self.F.mT @ self.base.hess(self._x(u)) @ self.F


def affine_pullback(obj, z, F):
    """Structure-preserving affine transform x = z + F u of an objective."""
    if isinstance(obj, LinearObjective):
        return LinearObjective(a=mv(F.mT, obj.a), r=obj.r + _dot(obj.a, z))
    if isinstance(obj, QuadraticObjective):
        Pz = mv(obj.P, z)
        return QuadraticObjective(
            P=F.mT @ obj.P @ F, a=mv(F.mT, obj.a + Pz),
            r=obj.r + _dot(obj.a, z) + 0.5 * (z * Pz).sum(dim=-1))
    return AffineObjective(base=obj, z=z, F=F)


# ---------------------------------------------------------------------------
# factory zoo (ObjectiveFunctions.scala)
# ---------------------------------------------------------------------------


def norm_squared(n: int, dtype=torch.float64, device=None) -> QuadraticObjective:
    """f(x) = ||x||^2 / 2  (ObjectiveFunctions.scala:11-16)."""
    return QuadraticObjective(P=torch.eye(n, dtype=dtype, device=device),
                              a=torch.zeros((n,), dtype=dtype, device=device),
                              r=torch.zeros((), dtype=dtype, device=device))


def quadratic_residual(R, x0) -> QuadraticObjective:
    """f(x) = ||R(x - x0)||^2 / 2  (ObjectiveFunctions.scala:21-34)."""
    P = R.mT @ R
    Px0 = P @ x0
    return QuadraticObjective(P=P, a=-Px0, r=0.5 * x0 @ Px0)


def regularized_equation_residual(A, b, delta: float) -> QuadraticObjective:
    """f(x) = (||Ax-b||^2 + delta*||A||*||x||^2)/2, the phase-I-with-
    equalities objective (ObjectiveFunctions.scala:50-61)."""
    n = A.shape[1]
    P = A.mT @ A + delta * torch.linalg.matrix_norm(A) * torch.eye(
        n, dtype=A.dtype, device=A.device)
    return QuadraticObjective(P=P, a=-(A.mT @ b), r=0.5 * b @ b)


def _p_norm_p(p, x):
    return torch.sum(torch.abs(x) ** p)


def p_norm_p(n: int, p: float, dtype=torch.float64,
             device=None) -> CustomObjective:
    """f(x) = sum_j |x_j|^p, p >= 2  (ObjectiveFunctions.scala:70-83)."""
    assert p >= 2, "p-norm objective needs p >= 2 for C^2 smoothness"
    return CustomObjective(fn=_p_norm_p, params=torch.tensor(
        p, dtype=dtype, device=device))


def _power(params, x):
    A, alpha, q = params
    u = A @ x
    return torch.sum(alpha * (u * u) ** q)


def power_objective(A, alpha, q: float) -> CustomObjective:
    """f(x) = sum_j alpha_j (a_j . x)^(2q), evaluated as (u*u)^q so it is
    defined and convex for u < 0 and fractional q (Type1Function.scala:
    91-107).  Global minimum 0 on ker(A)."""
    assert q >= 1
    return CustomObjective(fn=_power, params=(A, alpha, torch.tensor(
        q, dtype=A.dtype, device=A.device)))
