"""cvx_tpu_torch: the PyTorch and CUDA port of ``cvx_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``cvx_tpu`` is the reference; this package mirrors its
module paths and is tested against it on the same inputs.  Ported so far:
the batched KL scenario solve through the closed-form dual
(``models.DistKL``: ``solve(method="dual_fused" | "dual_fast")``,
``solve_certified``, ``solve_certified_batch``) with its two kernels in
``ops.kl_dual``; the batched primal solve (``solve_jittable_batch`` /
``solve_jittable`` with ``method="fused"`` or ``"BR_fast"``) with its
kernel in ``ops.kl_barrier``; the batched Cholesky
(``ops.cholesky_batched``) with its kernel in ``ops.chol``; and the
generic interior-point core on a batch axis (``ops``, ``problem``,
``solvers``, ``duality.solve_dual``), through which every other ``DistKL``
route runs (``solve()``, "BR", "PD", phase-I, ``feasibility_batch``).
``DistKL`` puts a problem on the card unless the caller passes
``device="cpu"``.  Importing the package builds nothing: the CUDA kernels
are compiled at their first launch on a CUDA tensor.
"""

from .models import DistKL
from .solvers import Solution, SolverParams

__all__ = ["DistKL", "Solution", "SolverParams"]
