"""cvx_tpu_torch: the PyTorch and CUDA port of ``cvx_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``cvx_tpu`` is the reference; this package mirrors its
module paths and is tested against it on the same inputs.  Ported so far:
the batched KL scenario solve through the closed-form dual
(``models.DistKL``: ``solve(method="dual_fused")``, ``solve_certified``,
``solve_certified_batch``) with its two kernels in ``ops.kl_dual``.
Importing the package builds nothing: the CUDA kernels are compiled at
their first launch on a CUDA tensor.
"""

from .models import DistKL
from .solvers import Solution, SolverParams

__all__ = ["DistKL", "Solution", "SolverParams"]
