"""Model zoo: Dist_KL (KL distance minimization, both sides, and its
fleet screen) and the QP / DiagQP / LP family."""

from .dist_kl import (DistKL, FeasibilityScreen, KLCertificate, KLObjective,
                      kl_certify, kl_feasibility_screen)
from .qp import LP, QP, DiagQP, QPCertificate, qp_certify

__all__ = ["DiagQP", "DistKL", "FeasibilityScreen", "KLCertificate",
           "KLObjective", "LP",
           "QP", "QPCertificate", "kl_certify", "kl_feasibility_screen",
           "qp_certify"]
