"""Kernels and their plain PyTorch versions."""

from .chol import (cholesky_batched, cholesky_batched_cuda,
                   cholesky_batched_plain)
from .kl_barrier import (fused_final_t, fused_n_outer, kl_barrier_fused,
                         kl_barrier_fused_plain)
from .kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                      kl_dual_fused_cert_plain, kl_dual_fused_plain)

__all__ = ["cholesky_batched", "cholesky_batched_cuda",
           "cholesky_batched_plain", "fused_final_t", "fused_n_outer",
           "kl_barrier_fused", "kl_barrier_fused_plain", "kl_dual_fused",
           "kl_dual_fused_cert", "kl_dual_fused_cert_plain",
           "kl_dual_fused_plain"]
