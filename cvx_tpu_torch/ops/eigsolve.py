"""Spectral solves with a Tikhonov sweep, batched over leading dimensions.

Counterpart of ``cvx_tpu/ops/eigsolve.py`` (cvx/MatrixUtils.scala:
603-751): the reference's sequential sweep of delta = 1e-14 * 10^k,
k < 18, is evaluated at once in the eigenbasis, the best true residual
wins, and the residual is returned as a diagnostic.

LAPACK's eigh and SVD raise on a matrix with a NaN or inf in it (XLA's
return NaN); such a matrix is replaced by zeros for the decomposition and
its solution is NaN.
"""

from __future__ import annotations

import torch

from .cholesky import relative_residual

# delta sweep of the reference: 1e-14 * 10^k, k = 0..17
_NUM_DELTAS = 18


def _finite_input(M):
    """(M with every non-finite matrix zeroed, per-matrix finite mask)."""
    ok = torch.isfinite(M).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], M, 0.0), ok


def _sweep_solve(lam, c, dtype):
    """The pseudo-inverse candidate and the Tikhonov family in a spectral
    basis (values ``lam``, coordinates ``c`` of b), scored by the residual
    ``||lam z - c||``; returns the best z."""
    lam_max = torch.clamp_min(torch.abs(lam).amax(dim=-1, keepdim=True),
                              torch.finfo(dtype).tiny)
    nonzero = torch.abs(lam) > torch.finfo(dtype).eps * lam_max
    z_pinv = torch.where(nonzero, c / torch.where(nonzero, lam, 1.0), 0.0)
    deltas = 1e-14 * (10.0 ** torch.arange(_NUM_DELTAS, dtype=dtype,
                                           device=lam.device))
    deltas = deltas * lam_max ** 2                       # (..., 18)
    z_tik = ((lam * c)[..., None, :]
             / (lam[..., None, :] ** 2 + deltas[..., :, None]))
    return torch.cat([z_pinv[..., None, :], z_tik], dim=-2)   # (..., 19, n)


def _pick(z_all, res):
    best = torch.argmin(res, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, z_all.shape[-1])
    return torch.gather(z_all, -2, idx)[..., 0, :]


def sym_solve_eig(H, b, *, tol: float = 1e-10):
    """Solve symmetric ``H x = b`` by eigendecomposition and a Tikhonov
    sweep (MatrixUtils.scala:649-699).  Handles singular and indefinite H.
    Returns ``(x, relres)``."""
    Hs, ok = _finite_input(H)
    lam, V = torch.linalg.eigh(Hs)
    c = (V.mT @ b[..., None])[..., 0]
    z_all = _sweep_solve(lam, c, H.dtype)
    res = torch.linalg.vector_norm(lam[..., None, :] * z_all
                                   - c[..., None, :], dim=-1)
    x = (V @ _pick(z_all, res)[..., None])[..., 0]
    x = torch.where(ok[..., None], x, torch.nan)
    return x, relative_residual(H, x, b, tol)


def svd_solve(A, b, *, tol: float = 1e-10):
    """Solve general ``A x = b`` by SVD with the same sweep
    (MatrixUtils.scala:712-729), scored by the TRUE residual (which also
    penalizes the part of b outside the range).  Returns ``(x, relres)``."""
    As, ok = _finite_input(A)
    U, s, Vh = torch.linalg.svd(As, full_matrices=False)
    c = (U.mT @ b[..., None])[..., 0]
    z_all = _sweep_solve(s, c, A.dtype)
    xs = z_all @ Vh                                      # (..., 19, n)
    res = torch.linalg.vector_norm((As[..., None, :, :] @ xs[..., None])[
        ..., 0] - b[..., None, :], dim=-1)
    x = (Vh.mT @ _pick(z_all, res)[..., None])[..., 0]
    x = torch.where(ok[..., None], x, torch.nan)
    return x, relative_residual(A, x, b, tol)
