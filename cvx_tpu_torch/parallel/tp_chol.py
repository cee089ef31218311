"""Tensor-parallel dense factorization: sharded Cholesky / KKT for ONE
large instance.

Counterpart of ``cvx_tpu/parallel/tp_chol.py``: the reference's block
elimination (cvx/KKTSystem.scala:99-167, solveWithCholFactor) over a
ROW-SHARDED H, each rank holding n / D consecutive rows:

  * ``make_sharded_cholesky``: blocked right-looking Cholesky.  Per block
    column k the owner broadcasts its block row (bs, n), every rank
    factors the (bs, bs) diagonal block redundantly (tiny), computes its
    piece of the panel with a triangular solve, all-gathers the (n, bs)
    panel and applies the rank-bs trailing update to its rows.
    Communication per step is O(n bs), O(n^2) in all, against O(n^3 / D)
    local work.
  * ``make_sharded_chol_solve``: forward and back substitution on the
    sharded factor.  Forward: the owner's block row is broadcast and
    every rank solves block k (replicated).  Backward: the column-panel
    products are distributed (each rank contributes its rows) and
    all-reduced.
  * ``make_tp_kkt_solver``: [[H, A^T], [A, 0]] with H sharded and the p
    equality rows replicated: factor H, solve H X = [A^T, q], form the
    small Schur complement S = A X replicated, back-substitute.

The local panel math is plain PyTorch, as the reference's is plain jnp.
Each returned function takes the whole matrix on every rank (the
reference's global array), keeps its rows, and returns whole results on
every rank.
"""

from __future__ import annotations

import torch

from .mesh import Mesh


def _tri(L, B, *, trans: bool = False):
    """Solve L Y = B (or L^T Y = B) for lower triangular L."""
    return torch.linalg.solve_triangular(L.mT if trans else L, B,
                                         upper=trans)


def _block_row(A_loc, k, bs, mesh: Mesh):
    """Block row k (bs, n) of the row-sharded matrix, from its owner."""
    rows_loc = A_loc.shape[0]
    owner = (k * bs) // rows_loc
    if owner == mesh.rank:
        start = k * bs - mesh.rank * rows_loc
        piece = A_loc[start:start + bs]
    else:
        piece = A_loc.new_empty((bs, A_loc.shape[1]))
    return mesh.broadcast(piece, owner)


def _cholesky_local(A_loc, n: int, bs: int, mesh: Mesh):
    """This rank's rows of L for its rows ``A_loc`` of H."""
    rows_loc = A_loc.shape[0]
    rows_glob = mesh.rank * rows_loc + torch.arange(rows_loc,
                                                    device=A_loc.device)
    A_loc = A_loc.clone()
    L_loc = torch.zeros_like(A_loc)
    for k in range(n // bs):
        cols = slice(k * bs, (k + 1) * bs)
        blockrow = _block_row(A_loc, k, bs, mesh)
        Lkk = torch.linalg.cholesky(blockrow[:, cols])   # on every rank
        # my panel piece A_ik Lkk^-T, below the diagonal block
        Ppiece = _tri(Lkk, A_loc[:, cols].mT).mT        # (rows_loc, bs)
        below = (rows_glob >= (k + 1) * bs)[:, None]
        Pbelow = torch.where(below, Ppiece, 0.0)
        # my rows inside block k take the rows of Lkk itself
        in_k = (rows_glob >= k * bs) & (rows_glob < (k + 1) * bs)
        idx = torch.clamp(rows_glob - k * bs, 0, bs - 1)
        L_loc[:, cols] = torch.where(in_k[:, None], Lkk[idx], Pbelow)
        # trailing rank-bs update with the whole (n, bs) panel
        Pfull = mesh.gather(Pbelow)
        A_loc -= Pbelow @ Pfull.mT
    return L_loc


def _solve_local(L_loc, B, n: int, bs: int, mesh: Mesh):
    """X with L L^T X = B, L row-sharded, B (n, nrhs) replicated."""
    rows_loc = L_loc.shape[0]
    my_start = mesh.rank * rows_loc
    nblocks = n // bs
    # forward: L Y = B, block k solved by every rank from the owner's row
    Y = torch.zeros_like(B)
    for k in range(nblocks):
        cols = slice(k * bs, (k + 1) * bs)
        blockrow = _block_row(L_loc, k, bs, mesh)
        rhs = B[cols] - blockrow[:, :k * bs] @ Y[:k * bs]
        Y[cols] = _tri(blockrow[:, cols], rhs)
    # backward: L^T X = Y; the panel products are distributed
    rows_glob = my_start + torch.arange(rows_loc, device=L_loc.device)
    X = torch.zeros_like(B)
    for k in reversed(range(nblocks)):
        cols = slice(k * bs, (k + 1) * bs)
        below = (rows_glob >= (k + 1) * bs)[:, None]
        Xloc = X[my_start:my_start + rows_loc]
        s = mesh.sum(torch.where(below, L_loc[:, cols], 0.0).mT @ Xloc)
        blockrow = _block_row(L_loc, k, bs, mesh)
        X[cols] = _tri(blockrow[:, cols], Y[cols] - s, trans=True)
    return X


def _check_shapes(n: int, n_devices: int, bs: int):
    if n % (n_devices * bs) != 0:
        raise ValueError(
            f"n={n} must be divisible by n_devices*block "
            f"({n_devices}*{bs}) so block rows never straddle devices")


def make_sharded_cholesky(mesh: Mesh, n: int, *, axis: str = "tp",
                          block: int = 128):
    """Return ``chol(H) -> L`` for an (n, n) SPD matrix factored with its
    rows split over ``mesh``; H and L whole on every rank."""
    mesh.check_axis(axis)
    _check_shapes(n, mesh.size, block)

    def chol(H):
        rows = mesh.local_rows(n)
        return mesh.gather(_cholesky_local(H[rows], n, block, mesh))

    return chol


def make_sharded_chol_solve(mesh: Mesh, n: int, *, axis: str = "tp",
                            block: int = 128):
    """Return ``solve(L, B) -> X`` with L from ``make_sharded_cholesky``
    (its rows split over ``mesh``) and B, X (n, nrhs) replicated."""
    mesh.check_axis(axis)
    _check_shapes(n, mesh.size, block)

    def solve(L, B):
        return _solve_local(L[mesh.local_rows(n)], B, n, block, mesh)

    return solve


def make_tp_kkt_solver(mesh: Mesh, n: int, p: int, *, axis: str = "tp",
                       block: int = 128):
    """Return ``kkt(H, A, q, b) -> (x, w)`` solving

        H x + A^T w = -q,    A x = b,

    with H (n, n) factored row-sharded over the mesh and A (p, n)
    replicated (p << n): one distributed factorization, one distributed
    multi-rhs solve, a replicated (p, p) factorization.
    """
    mesh.check_axis(axis)
    _check_shapes(n, mesh.size, block)

    def kkt(H, A, q, b):
        L_loc = _cholesky_local(H[mesh.local_rows(n)], n, block, mesh)
        X = _solve_local(L_loc, torch.cat([A.T, q[:, None]], dim=1), n,
                         block, mesh)                     # H^-1 [A^T q]
        Hinv_At, Hinv_q = X[:, :p], X[:, p]
        S = A @ Hinv_At                                   # (p, p) replicated
        S = 0.5 * (S + S.T)
        Ls = torch.linalg.cholesky(S)
        z = -(b + A @ Hinv_q)
        w = torch.cholesky_solve(z[:, None], Ls)[:, 0]
        x = -(Hinv_q + Hinv_At @ w)
        return x, w

    return kkt
