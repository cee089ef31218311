"""Kernels and their plain PyTorch versions, the dense numerics core
(Cholesky, equilibration, spectral, nullspace and KKT solves) of the
generic interior-point solvers, free-variable elimination, scalar root
finding and test matrices.

Three modules of ``cvx_tpu.ops`` have no counterpart here, on purpose:

* ``blocked_chol.py``, a blocked Cholesky in XLA (not Pallas) that its
  own docstring records as a negative result, with no production caller;
  the counterpart on the H100 is ``torch.linalg.cholesky``, and the
  batched small factors go to ``cholesky_batched`` (K4);
* ``ds.py``, double-single (hi, lo) f32 arithmetic for K2's polish and
  certificate on the TPU, which has no f64: the H100 has native f64, so
  K2's epilogue runs in f64 and returns plain f64 leaves;
* ``_pad.py``, the TPU kernels' lane padding, which the CUDA launchers
  do not need.
"""

from .chol import (cholesky_batched, cholesky_batched_cuda,
                   cholesky_batched_plain)
from .cholesky import (back_solve, chol_solve_factored, cholesky_solve,
                       default_delta, forward_solve, regularized_cholesky,
                       relative_residual, tri_solve)
from .eigsolve import svd_solve, sym_solve_eig
from .equilibrate import (apply_equilibration, check_symmetric,
                          condition_number, hs_norm, ruiz_equilibrate,
                          ruiz_equilibrate0)
from .kkt import kkt_solve, lin_solve, sym_solve
from .kl_barrier import (fused_final_t, fused_n_outer, kl_barrier_fused,
                         kl_barrier_fused_plain)
from .kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                      kl_dual_fused_cert_plain, kl_dual_fused_plain)
from .kl_gap import kl_gap_fused, kl_gap_fused_plain
from .nullspace import SolutionSpace, solution_space
from .reduction import (UnsolvableSystemError, free_coordinates,
                        pad_solution, reduce_kkt)
from .scalar import bisect, newton_1d
from .testmat import (decaying_spectrum, nasty_rhs, random_orthogonal,
                      random_spd, sign_combination_matrix,
                      sign_combination_matrix_padded)

__all__ = ["SolutionSpace", "UnsolvableSystemError", "apply_equilibration",
           "back_solve", "bisect",
           "check_symmetric",
           "chol_solve_factored", "cholesky_batched", "cholesky_batched_cuda",
           "cholesky_batched_plain", "cholesky_solve", "condition_number",
           "default_delta", "forward_solve", "fused_final_t",
           "fused_n_outer", "hs_norm", "kkt_solve", "kl_barrier_fused",
           "kl_barrier_fused_plain", "kl_dual_fused", "kl_dual_fused_cert",
           "kl_dual_fused_cert_plain", "kl_dual_fused_plain",
           "kl_gap_fused", "kl_gap_fused_plain", "lin_solve",
           "regularized_cholesky", "relative_residual", "ruiz_equilibrate",
           "ruiz_equilibrate0",
           "solution_space", "svd_solve", "sym_solve", "sym_solve_eig",
           "tri_solve", "decaying_spectrum", "free_coordinates",
           "nasty_rhs", "newton_1d", "pad_solution", "random_orthogonal",
           "random_spd", "reduce_kkt", "sign_combination_matrix",
           "sign_combination_matrix_padded"]
