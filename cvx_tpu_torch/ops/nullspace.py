"""Nullspace parametrization of underdetermined systems A x = b.

Counterpart of ``cvx_tpu/ops/nullspace.py`` (cvx/SolutionSpace.scala:
20-37, cvx/MatrixUtils.scala:536-550): for A (p x n) of full row rank,
every solution of ``A x = b`` is ``x = z0 + F u``, z0 the minimum-norm
solution and F an orthonormal basis of ker(A), from a complete QR of A^T.

A shared system (A (p, n), b (p,)) gives one (z0, F) for a whole batch;
points and parameters then carry the batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ._batch import mv
from .cholesky import tri_solve


@dataclass(frozen=True)
class SolutionSpace:
    """Affine solution space ``{x : A x = b} = {z0 + F u}``."""

    z0: torch.Tensor   # (n,) or (B, n) minimum-norm solution
    F: torch.Tensor    # (n, n - p) or (B, n, n - p), orthonormal columns

    def parameter(self, x0):
        """u0 with ``x0 = z0 + F u0`` (exact when A x0 = b): F^T (x0 - z0)
        (SolutionSpace.scala:24-32)."""
        return mv(self.F.mT, x0 - self.z0)

    def point(self, u):
        return self.z0 + mv(self.F, u)


def _finite_qr(M):
    ok = torch.isfinite(M).all(dim=-1).all(dim=-1)
    Q, R = torch.linalg.qr(torch.where(ok[..., None, None], M, 0.0),
                           mode="complete")
    return (torch.where(ok[..., None, None], Q, torch.nan),
            torch.where(ok[..., None, None], R, torch.nan))


def solution_space(A, b) -> SolutionSpace:
    """(z0, F) for ``A x = b`` via a complete QR of A^T (a matrix with a
    non-finite entry gives NaN, as XLA's QR does)."""
    p = A.shape[-2]
    Q, R = _finite_qr(A.mT)           # A^T = Q R, Q (n, n), R (n, p)
    # A x = b  <=>  R^T Q^T x = b: y = R[:p]^-T b, z0 = Q[:, :p] y
    y = tri_solve(R[..., :p, :], b, lower=False, trans=True)
    z0 = (Q[..., :, :p] @ y[..., None])[..., 0]
    return SolutionSpace(z0=z0, F=Q[..., :, p:])
