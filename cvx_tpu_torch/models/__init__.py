"""Model zoo: the dual side of Dist_KL (KL distance minimization)."""

from .dist_kl import DistKL, KLCertificate, kl_certify

__all__ = ["DistKL", "KLCertificate", "kl_certify"]
