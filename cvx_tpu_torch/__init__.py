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
Also ported: the fleet screen (``DistKL.feasibility_screen_batch``),
the problem API ``minimize``, the QP / DiagQP / LP family with its
certified f64 finish (``models.qp``), checkpoint and resume
(``checkpoint``), the dataclass tree helpers and the exact-f32 guard of
every solver (``tree``), and the auxiliary ops and test fixtures.
The top level holds the reference's names (``cvx_tpu/__init__.py``): the
submodules ``checkpoint``, ``diagnostics``, ``models``, ``ops``,
``parallel``, ``problem``, ``solvers`` and ``testing``, and ``minimize``,
``load_pytree``, ``resume_barrier``, ``save_pytree`` and ``solve_dual``.
``DistKL``, ``QP``, ``DiagQP``, ``LP`` and ``minimize`` put a problem on
the card unless the caller passes ``device="cpu"``.  Importing the
package builds nothing, starts no process group and leaves CUDA
uninitialised: the CUDA kernels are compiled at their first launch on a
CUDA tensor.
"""

__version__ = "0.1.0"

from . import (checkpoint, diagnostics, models, ops, parallel, problem,
               solvers, testing)
from .api import minimize
from .checkpoint import load_pytree, resume_barrier, save_pytree
from .duality import solve_dual
from .models import LP, QP, DiagQP, DistKL
from .solvers import Solution, SolverParams

__all__ = ["DiagQP", "DistKL", "LP", "QP", "Solution", "SolverParams",
           "checkpoint", "diagnostics", "load_pytree", "minimize", "models",
           "ops", "parallel", "problem", "resume_barrier", "save_pytree",
           "solve_dual", "solvers", "testing"]
