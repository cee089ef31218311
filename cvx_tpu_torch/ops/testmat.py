"""Random test matrices with controlled conditioning.

Counterpart of ``cvx_tpu/ops/testmat.py`` (cvx/MatrixUtils.scala:29-127,
:573-580): Haar-random orthogonal matrices (QR of a Gaussian), SPD
matrices with a prescribed condition number and an exponentially
decaying spectrum, optionally singular (``dim_kernel`` trailing zeros),
adversarial right-hand sides on the small singular directions, and the
sign-combination matrices that expand |x|-constraints into linear rows.

Random draws take a ``torch.Generator`` (the reference takes a JAX key)
and are made on the generator's device, then moved to ``device`` (default:
the generator's).
"""

from __future__ import annotations

import numpy as np
import torch


def _normal(gen, shape, dtype, device):
    g = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return g if device is None else g.to(device)


def random_orthogonal(gen: torch.Generator, n: int, dtype=torch.float64,
                      device=None) -> torch.Tensor:
    """Haar-random orthogonal matrix (MatrixUtils.scala:57-63)."""
    Q, _ = torch.linalg.qr(_normal(gen, (n, n), dtype, device))
    return Q


def decaying_spectrum(n: int, cond: float, dim_kernel: int = 0,
                      dtype=torch.float64, device=None) -> torch.Tensor:
    """d_j = exp(-j*rho), rho = log(cond)/n, trailing dim_kernel zeros
    (MatrixUtils.scala:46-52, ``diagonalMatrix``)."""
    rho = np.log(cond) / n
    d = torch.exp(-rho * torch.arange(n, dtype=dtype, device=device))
    if dim_kernel > 0:
        d[n - dim_kernel:] = 0.0
    return d


def random_spd(gen: torch.Generator, n: int, cond: float,
               dim_kernel: int = 0, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """SPD (or PSD if dim_kernel > 0) A = U D U^T with prescribed
    condition (MatrixUtils.scala:69-74)."""
    U = random_orthogonal(gen, n, dtype, device)
    d = decaying_spectrum(n, cond, dim_kernel, dtype, U.device)
    return (U * d[None, :]) @ U.T


def nasty_rhs(gen: torch.Generator, d: torch.Tensor,
              U: torch.Tensor) -> torch.Tensor:
    """Adversarial RHS: uniform-random weight on every nonzero spectral
    direction, so ``A x = b`` (A = U diag(d) U^T) is solvable but
    exercises the small singular values (MatrixUtils.scala:573-580)."""
    w = torch.rand(d.shape, generator=gen, dtype=d.dtype,
                   device=gen.device).to(d.device)
    w = torch.where(torch.abs(d) > 0, 1.0 + 2.0 * w, 0.0)
    return U @ w


def sign_combination_matrix(m: int) -> np.ndarray:
    """All 2^m sign patterns as rows (MatrixUtils.scala:80-94); used to
    expand ``sum_j |x_j| <= ub`` into 2^m linear rows.  NumPy, because it
    decides shapes."""
    assert m >= 1
    return np.stack(
        np.meshgrid(*([np.array([1.0, -1.0])] * m), indexing="ij"), axis=-1
    ).reshape(-1, m)


def sign_combination_matrix_padded(n: int, p: int, q: int) -> np.ndarray:
    """Sign combinations on coordinates [p, q), zeros elsewhere
    (MatrixUtils.scala:108-127)."""
    assert 0 <= p <= q <= n and q > p
    core = sign_combination_matrix(q - p)
    out = np.zeros((core.shape[0], n))
    out[:, p:q] = core
    return out
