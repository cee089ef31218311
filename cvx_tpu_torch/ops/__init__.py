"""Kernels and their plain PyTorch versions."""

from .kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                      kl_dual_fused_cert_plain, kl_dual_fused_plain)

__all__ = ["kl_dual_fused", "kl_dual_fused_cert", "kl_dual_fused_cert_plain",
           "kl_dual_fused_plain"]
