"""Parallel layer on ``torch.distributed``: instance batches split over
ranks, Schur-complement consensus for block-separable programs, the
constraint-axis sharded barrier and primal-dual methods, and the
row-sharded Cholesky / KKT solve of one large instance.

Counterpart of ``cvx_tpu/parallel/``.  One process per rank runs the
local body; the reference's ``psum`` / ``pmax`` / ``all_gather`` become
the collectives of a process group (``mesh.Mesh``): NCCL for tensors on
the card, gloo on the CPU.  ``dryrun.dryrun_multichip`` spawns ranks and
runs the six shardings of the reference's dry run.  A ``Mesh`` has one
named axis; a function's ``axis`` argument (the reference's defaults)
must name it, and its process group decides where the collectives go.
"""

from .batch import shard_solve, vmap_solve
from .constraint_shard import (barrier_solve_msharded,
                               barrier_solve_msharded_cnts,
                               primal_dual_solve_msharded)
from .mesh import (block_mesh, init_distributed, instance_mesh,
                   shard_batch)
from .schur import (SeparableProblem, make_sharded_schur_solver,
                    schur_kkt_solve, separable_barrier_solve)
from .tp_chol import (make_sharded_cholesky, make_sharded_chol_solve,
                      make_tp_kkt_solver)

__all__ = [
    "shard_solve", "vmap_solve", "barrier_solve_msharded",
    "barrier_solve_msharded_cnts", "primal_dual_solve_msharded",
    "block_mesh", "init_distributed", "instance_mesh",
    "shard_batch", "SeparableProblem", "make_sharded_schur_solver",
    "schur_kkt_solve", "separable_barrier_solve",
    "make_sharded_cholesky", "make_sharded_chol_solve",
    "make_tp_kkt_solver",
]
