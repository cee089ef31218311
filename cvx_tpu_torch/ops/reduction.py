"""Free-variable elimination for KKT systems.

Counterpart of ``cvx_tpu/ops/reduction.py`` (cvx/KKTData.scala:32-135): a
coordinate j is FREE when row and column j of H are zero, column j of A
is zero and q_j = 0.  The KKT system then puts no condition on x_j, so
the reduced system (those rows and columns dropped) is solved instead and
zeros are re-inserted afterwards (``paddVector``, KKTData.scala:113-127).

The free set decides shapes, so it is detected on the host from concrete
values, as in the reference; the solvers handle zero rows through
regularization instead.
"""

from __future__ import annotations

import numpy as np
import torch


class UnsolvableSystemError(Exception):
    """q has a nonzero entry at a free coordinate: Hx + A^T w = -q is
    unsolvable (cvx/UnsolvableSystemException.scala)."""


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def free_coordinates(H, A, tol: float = 0.0) -> np.ndarray:
    """Boolean mask of free coordinates (KKTData.scala:68-93).  Host-side."""
    H = _np(H)
    A = _np(A)
    col_zero = np.all(np.abs(H) <= tol, axis=0)
    row_zero = np.all(np.abs(H) <= tol, axis=1)
    a_zero = (np.all(np.abs(A) <= tol, axis=0)
              if A.shape[0] > 0 else np.ones(H.shape[1], bool))
    return col_zero & row_zero & a_zero


def reduce_kkt(H, A, q, tol: float = 0.0):
    """Drop free rows/columns.  Returns (H_r, A_r, q_r, keep_idx) as
    tensors (on the device of H; numpy input gives CPU tensors) and the
    kept coordinates as a numpy index array.

    Raises UnsolvableSystemError when q is nonzero on a free coordinate.
    """
    free = free_coordinates(H, A, tol)
    qn = _np(q)
    if np.any(np.abs(qn[free]) > tol):
        raise UnsolvableSystemError(
            "q nonzero at free coordinates " +
            str(np.nonzero(free & (np.abs(qn) > tol))[0].tolist())
        )
    keep = np.nonzero(~free)[0]
    H, A, q = (torch.as_tensor(v) for v in (H, A, q))
    k = torch.as_tensor(keep, device=H.device)
    return (H[k][:, k], A[:, k] if A.shape[0] > 0 else A, q[k], keep)


def pad_solution(x_reduced, keep_idx, n: int) -> torch.Tensor:
    """Re-insert zeros at the eliminated coordinates of the last axis
    (KKTData.scala:113-127)."""
    x = x_reduced.new_zeros((*x_reduced.shape[:-1], n))
    x[..., torch.as_tensor(keep_idx, device=x.device)] = x_reduced
    return x
