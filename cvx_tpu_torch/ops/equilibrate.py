"""Ruiz equilibration of symmetric matrices, batched over leading
dimensions.

Counterpart of ``cvx_tpu/ops/equilibrate.py`` (cvx/MatrixUtils.scala:
240-307): rescale H -> Q = D H D with a diagonal D so that every row of Q
has about unit l2 norm.  The convergent loop is a masked loop over the
batch: a matrix whose loop has ended keeps its scaling, and the loop runs
while any matrix is still in it.
"""

from __future__ import annotations

import math

import torch


def _scaled(H, d):
    return (d[..., :, None] * d[..., None, :]) * H


def _sweep(H, d):
    """One l2 round: u_i = sqrt(||row_i(Q)||); zero rows keep scale 1."""
    u = torch.sqrt(torch.linalg.vector_norm(_scaled(H, d), dim=-1))
    v = torch.where(u > 0, 1.0 / torch.where(u > 0, u, 1.0), 1.0)
    return d * v, u


def ruiz_equilibrate(H, *, max_iter: int = 20, tol: float = 1e-6,
                     sweeps: int | None = None):
    """Equilibrate symmetric ``H`` (..., n, n); returns ``(d, Q)`` with
    ``Q = D H D``.  To solve ``H x = b``: solve ``Q u = d * b``, ``x = d * u``.

    ``sweeps=k`` runs exactly k rounds; ``sweeps=None`` runs until
    max |1 - u| <= tol or ``max_iter`` rounds, per matrix."""
    d = torch.ones(H.shape[:-1], dtype=H.dtype, device=H.device)
    if sweeps is not None:
        for _ in range(sweeps):
            d = _sweep(H, d)[0]
        return d, _scaled(H, d)
    batch = H.shape[:-2]
    rho = torch.full(batch, math.inf, dtype=H.dtype, device=H.device)
    it = torch.zeros(batch, dtype=torch.long, device=H.device)
    go = (it < max_iter) & (rho > tol)
    while bool(go.any()):
        dn, u = _sweep(H, d)
        d = torch.where(go[..., None], dn, d)
        rho = torch.where(go, torch.abs(1.0 - u).amax(dim=-1), rho)
        it = it + go.to(torch.long)
        go = go & (it < max_iter) & (rho > tol)
    return d, _scaled(H, d)


def ruiz_equilibrate0(H, *, l2_rounds: int = 5):
    """The second Ruiz variant (MatrixUtils.scala:278-307
    ``ruizEquilibrate0``): one l-infinity round, then ``l2_rounds`` fixed
    l2 rounds with no convergence test; zero rows keep scale 1.  Returns
    ``(d, Q)`` as ``ruiz_equilibrate`` does, for (..., n, n)."""
    f = torch.sqrt(torch.abs(H).amax(dim=-1))
    d = torch.where(f > 0, 1.0 / torch.where(f > 0, f, 1.0), 1.0)
    for _ in range(l2_rounds):
        d = _sweep(H, d)[0]
    return d, _scaled(H, d)


def apply_equilibration(d, b):
    """Scale a right-hand side (or unscale a solution): ``d * b``."""
    return d * b


def hs_norm(A):
    """Hilbert-Schmidt (Frobenius) norm (MatrixUtils.scala:19, 204)."""
    return torch.sqrt(torch.sum(A * A, dim=(-2, -1)))


def check_symmetric(Q, tol: float = 1e-13):
    """||Q - Q^T||_F < tol (MatrixUtils.scala:207-211)."""
    return hs_norm(Q - Q.mT) < tol


def condition_number(H):
    """sigma_max / sigma_min via SVD (MatrixUtils.scala:218-223); NaN for
    a matrix with a non-finite entry (LAPACK would raise)."""
    ok = torch.isfinite(H).all(dim=-1).all(dim=-1)
    s = torch.linalg.svdvals(torch.where(ok[..., None, None], H, 1.0))
    return torch.where(ok, s.amax(dim=-1) / s.amin(dim=-1), torch.nan)
