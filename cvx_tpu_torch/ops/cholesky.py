"""Regularized Cholesky factorization and positive-definite solves,
batched over leading dimensions.

Counterpart of ``cvx_tpu/ops/cholesky.py`` (the reference's re-design of
cvx/MatrixUtils.scala:452-516): always solve the shifted system
``Q + delta * s * I`` (s = mean |diag|), recover accuracy with a fixed
number of refinement steps on the ORIGINAL system, and return the
relative residual as a diagnostic instead of throwing.

A failed factorization gives NaN, as XLA's Cholesky does and as the
solvers expect (a non-finite Newton step keeps the iterate);
``torch.linalg.cholesky`` would raise instead.
"""

from __future__ import annotations

import math

import torch

from ._batch import mv
from .equilibrate import ruiz_equilibrate


def _chol_nan(M):
    """Lower Cholesky factor of a batch, NaN where a matrix is not positive
    definite (as XLA's Cholesky returns; torch would raise or return a
    partial factor)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None], math.nan, L)


def tri_solve(L, b, *, lower: bool = True, trans: bool = False):
    """Solve ``L x = b`` (or ``L^T x = b``) for triangular ``L``; ``b`` a
    vector (one dimension fewer than L) or a matrix.  A zero pivot gives
    inf/NaN, not an error."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    A = L.mT if trans else L
    x = torch.linalg.solve_triangular(A, b, upper=(lower == trans))
    return x[..., 0] if vec else x


def forward_solve(L, b):
    """Solve ``L x = b`` with L lower triangular (MatrixUtils.scala:383-402)."""
    return tri_solve(L, b, lower=True, trans=False)


def back_solve(U, b):
    """Solve ``U x = b`` with U upper triangular (MatrixUtils.scala:409-430)."""
    return tri_solve(U, b, lower=False, trans=False)


def default_delta(dtype) -> float:
    """Regularization floor: ~100x unit roundoff of the compute dtype.

    The reference uses 1e-10 in float64 (MatrixUtils.scala:452-461); the
    idea scales with precision so the float32 path stays stable.
    """
    return 1e-10 if torch.finfo(dtype).bits >= 64 else 3e-6


def regularized_cholesky(Q, delta=None):
    """Lower Cholesky factor of ``Q + delta * s * I`` (s = mean |diag(Q)|,
    1.0 where the diagonal is all zero), NaN where that fails.  The input
    is symmetrized first, as XLA's Cholesky does.  Returns ``(L, shift)``
    with one shift per matrix."""
    if delta is None:
        delta = default_delta(Q.dtype)
    n = Q.shape[-1]
    # scale-RELATIVE shift: an absolute one would swamp a tiny-magnitude
    # matrix such as the Schur complement A H^-1 A^T at large barrier t
    mean_diag = torch.abs(torch.diagonal(Q, dim1=-2, dim2=-1)).mean(dim=-1)
    scale = torch.where(mean_diag > 0, mean_diag, 1.0)
    shift = delta * scale
    Qd = Q + shift[..., None, None] * torch.eye(n, dtype=Q.dtype,
                                                device=Q.device)
    return _chol_nan(0.5 * (Qd + Qd.mT)), shift


def chol_solve_factored(L, b):
    """Solve ``L L^T x = b`` given the factor."""
    return tri_solve(L, tri_solve(L, b, lower=True), lower=True, trans=True)


def relative_residual(A, x, b, tol):
    """Normwise backward error ``||A x - b|| / (tol + ||b|| + ||A||_F ||x||)``
    (MatrixUtils.scala:436-443 with the reference's scale term)."""
    r = torch.linalg.vector_norm(mv(A, x) - b, dim=-1)
    scale = (torch.linalg.matrix_norm(A) * torch.linalg.vector_norm(x, dim=-1))
    return r / (tol + torch.linalg.vector_norm(b, dim=-1) + scale)


def cholesky_solve(H, b, *, delta=None, refine: int = 2, tol: float = 1e-10,
                   equil_sweeps: int | None = 4):
    """Solve symmetric positive (semi)definite ``H x = b``: Ruiz
    equilibration (``equil_sweeps`` fixed rounds; None runs the convergent
    loop), shifted Cholesky, two triangular solves and ``refine`` rounds of
    refinement on the original H.  Returns ``(x, relres)``."""
    d, Q = ruiz_equilibrate(H, sweeps=equil_sweeps)
    L, _ = regularized_cholesky(Q, delta)

    def q_solve(rhs):
        # H x = rhs  <=>  Q u = d * rhs, x = d * u
        return d * chol_solve_factored(L, d * rhs)

    x = q_solve(b)
    for _ in range(refine):
        x = x + q_solve(b - mv(H, x))
    return x, relative_residual(H, x, b, tol)
