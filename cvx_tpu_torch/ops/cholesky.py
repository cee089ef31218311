"""Regularization constants shared by the port's Newton solvers.

Counterpart of ``cvx_tpu/ops/cholesky.py``; only ``default_delta`` is
ported so far (the generic factorizations are ROADMAP M7).
"""

from __future__ import annotations

import torch


def default_delta(dtype) -> float:
    """Regularization floor: ~100x unit roundoff of the compute dtype.

    The reference uses 1e-10 in float64 (MatrixUtils.scala:452-461); the
    idea scales with precision so the float32 path stays stable.
    """
    return 1e-10 if torch.finfo(dtype).bits >= 64 else 3e-6
