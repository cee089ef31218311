"""KKT system solves ``H x + A^T w = -q``, ``A x = b``, batched over
leading dimensions.

Counterpart of ``cvx_tpu/ops/kkt.py`` (cvx/KKTSystem.scala).  The
reference's exception ladder becomes three methods:

* ``"aug"`` (default): the singular-H transform K = H + A^T A,
  z = q - A^T b (KKTSystem.scala:55-59), block elimination with a shifted
  Cholesky, and refinement on the ORIGINAL system;
* ``"chol"``: block elimination on H itself (H known PD);
* ``"ladder"``: chol, then aug, then the (n + p) spectral solve
  (KKTSystem.scala:253-310), each taken where the previous residual is
  above ``tol``.  The reference's ``lax.cond`` runs both branches under
  vmap; here every stage runs and a per-instance select keeps the first
  good one.

H is (..., n, n), q (..., n), b (..., p); A is (p, n) shared by the batch
or (..., p, n).  All return ``(x, w, relres)``, relres the larger of the
two normwise backward errors of the original system.
"""

from __future__ import annotations

import torch

from ._batch import mv
from .cholesky import (chol_solve_factored, cholesky_solve,
                       regularized_cholesky)
from .eigsolve import svd_solve, sym_solve_eig
from .equilibrate import ruiz_equilibrate


def _make_block_solver(H, A, *, delta, equil_sweeps=4):
    """Factor once, solve many: Ruiz-equilibrate H -> Q = D H D, factor Q
    and the Schur complement S = B Q^-1 B^T (B = A D), both shifted.  The
    closure solves ``H x + A^T w = -q_``, ``A x = b_`` (KKTSystem.scala:
    99-246)."""
    d, Q = ruiz_equilibrate(H, sweeps=equil_sweeps)
    L, _ = regularized_cholesky(Q, delta)
    B = A * d[..., None, :]
    Hinv_Bt = chol_solve_factored(L, B.mT)
    S = B @ Hinv_Bt
    S = 0.5 * (S + S.mT)
    Ls, _ = regularized_cholesky(S, delta)

    def solve_template(q_, b_):
        Hinv_q = chol_solve_factored(L, d * q_)
        z = -(b_ + mv(B, Hinv_q))
        w = chol_solve_factored(Ls, z)
        y = -(Hinv_q + mv(Hinv_Bt, w))
        return d * y, w

    return solve_template


def _residuals(H, A, q, b, x, w):
    return mv(H, x) + mv(A.mT, w) + q, mv(A, x) - b


def _refined(solve_template, H, A, q, b, x, w, refine, augment):
    for _ in range(refine):
        r1, r2 = _residuals(H, A, q, b, x, w)
        if augment:
            r1 = r1 + mv(A.mT, r2)          # the transform of (r1, -r2)
        dx, dw = solve_template(r1, -r2)
        x, w = x + dx, w + dw
    return x, w


def _block_solve(H, A, q, b, *, delta, refine):
    """One-shot block elimination + refinement on the original KKT."""
    solve_template = _make_block_solver(H, A, delta=delta)
    x, w = solve_template(q, b)
    return _refined(solve_template, H, A, q, b, x, w, refine, False)


def _kkt_residual(H, A, q, b, x, w, tol):
    """Max of the two normwise backward errors of the original system."""
    nrm = torch.linalg.vector_norm
    nx = nrm(x, dim=-1)
    nA = torch.linalg.matrix_norm(A)
    r1, r2 = _residuals(H, A, q, b, x, w)
    s1 = (tol + nrm(q, dim=-1) + torch.linalg.matrix_norm(H) * nx
          + nA * nrm(w, dim=-1))
    s2 = tol + nrm(b, dim=-1) + nA * nx
    return torch.maximum(nrm(r1, dim=-1) / s1, nrm(r2, dim=-1) / s2)


def _augmented(H, A, q, b):
    """The singular-H transform: (H + A^T A) x + A^T w = -(q - A^T b)."""
    return H + A.mT @ A, q - mv(A.mT, b)


def _kkt_eig_solve(H, A, q, b, *, tol):
    """Stage 3: the full (n + p) symmetric solve of [[H, A^T], [A, 0]]."""
    n, p = H.shape[-1], A.shape[-2]
    batch = torch.broadcast_shapes(H.shape[:-2], A.shape[:-2], q.shape[:-1])
    Hb = H.expand(*batch, n, n)
    Ab = A.expand(*batch, p, n)
    Z = H.new_zeros((*batch, p, p))
    M = torch.cat([torch.cat([Hb, Ab.mT], dim=-1),
                   torch.cat([Ab, Z], dim=-1)], dim=-2)
    sol, relres = sym_solve_eig(M, torch.cat([-q, b], dim=-1), tol=tol)
    return sol[..., :n], sol[..., n:], relres


def _select(ok, a, b):
    """Per-instance pick of a where ok, else b, over (x, w, relres)."""
    return tuple(torch.where(ok if u.dim() == ok.dim() else ok[..., None],
                             u, v) for u, v in zip(a, b))


def kkt_solve(H, A, q, b, *, method: str = "aug", delta=None,
              refine: int = 2, tol: float = 1e-10):
    """Solve ``H x + A^T w = -q``, ``A x = b``.  Returns ``(x, w, relres)``."""
    if A.shape[-2] == 0:
        # no equality constraints: a symmetric solve
        x, relres = sym_solve(H, -q, method=method, delta=delta,
                              refine=refine, tol=tol)
        return x, q.new_zeros((*x.shape[:-1], 0)), relres

    if method == "chol":
        x, w = _block_solve(H, A, q, b, delta=delta, refine=refine)
        return x, w, _kkt_residual(H, A, q, b, x, w, tol)

    if method == "aug":
        K, z = _augmented(H, A, q, b)
        solve_template = _make_block_solver(K, A, delta=delta)
        x, w = solve_template(z, b)
        # refine against the ORIGINAL system through the augmented template
        x, w = _refined(solve_template, H, A, q, b, x, w, refine, True)
        return x, w, _kkt_residual(H, A, q, b, x, w, tol)

    if method == "ladder":
        x1, w1 = _block_solve(H, A, q, b, delta=delta, refine=refine)
        r1 = _kkt_residual(H, A, q, b, x1, w1, tol)
        K, z = _augmented(H, A, q, b)
        x2, w2 = _block_solve(K, A, z, b, delta=delta, refine=refine)
        r2 = _kkt_residual(H, A, q, b, x2, w2, tol)
        stage3 = _kkt_eig_solve(H, A, q, b, tol=tol)
        later = _select(r2 <= tol, (x2, w2, r2), stage3)
        return _select(r1 <= tol, (x1, w1, r1), later)

    raise ValueError(f"unknown kkt method: {method!r}")


def sym_solve(H, r, *, method: str = "aug", delta=None, refine: int = 2,
              tol: float = 1e-10):
    """Solve symmetric ``H x = r`` (SymmetricLinearSystem.scala:15-56):
    equilibrated shifted Cholesky with refinement; ``method="ladder"``
    takes the spectral solve where the residual is above ``tol``.
    Returns ``(x, relres)``."""
    x, relres = cholesky_solve(H, r, delta=delta, refine=refine, tol=tol)
    if method == "ladder":
        return _select(relres <= tol, (x, relres),
                       sym_solve_eig(H, r, tol=tol))
    return x, relres


def lin_solve(A, b, *, delta=None, refine: int = 2, tol: float = 1e-10,
              sym_tol: float = 1e-12):
    """General square solve with the reference's symmetry dispatch
    (SymmetricLinearSystem.scala:28-55): symmetric to ``sym_tol`` -> the
    ladder, else ``svd_solve``; per instance.  Returns ``(x, relres)``."""
    scale = torch.clamp_min(torch.abs(A).amax(dim=(-2, -1)),
                            torch.finfo(A.dtype).tiny)
    asym = torch.abs(A - A.mT).amax(dim=(-2, -1)) / scale
    return _select(asym <= sym_tol,
                   sym_solve(A, b, method="ladder", delta=delta,
                             refine=refine, tol=tol),
                   svd_solve(A, b, tol=tol))
