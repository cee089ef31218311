"""Checkpoint / resume for solver state.

Counterpart of ``cvx_tpu/checkpoint.py``.  Every solver's result is an
explicit dataclass tree of tensors (``Solution``, ``FeasibilityReport``,
``QPCertificate``), so a checkpoint is its leaves:

  * ``save_pytree`` / ``load_pytree`` persist any tree of tensors to one
    ``.npz`` file with the reference's layout (``leaf_{i}`` in tree order,
    ``tree.tree_flatten``); the structure comes back from a template at
    load, so classes and static fields never touch disk, and a file that
    ``cvx_tpu`` wrote loads here (the two packages' ``Solution`` fields
    are in the same order);
  * ``resume_barrier`` continues a barrier continuation from a
    checkpointed Solution: the continuation is memoryless given (x, t),
    and t is recovered from the reported gap m/t and passed back as
    ``t0``, one per instance for a batch;
  * ``resume_structured`` does the same for the structured barrier
    (BR_fast, ``solvers.structured.barrier_solve_structured``).

The fused kernels run a fixed schedule with no state to checkpoint:
re-running them from the checkpointed iterate is their resume.
"""

from __future__ import annotations

from typing import Any, TypeVar

import numpy as np
import torch

from .solvers.barrier import barrier_solve
from .solvers.structured import barrier_solve_structured
from .solvers.types import SolverParams
from .tree import instance, tree_flatten, tree_unflatten

_T = TypeVar("_T")


def _npz_path(path: str) -> str:
    # np.savez appends '.npz' to other suffixes but np.load does not:
    # normalizing both sides keeps any path the caller picked round-trip
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> int:
    """Save every tensor leaf of ``tree`` to ``path`` (.npz appended when
    missing).  Returns the number of leaves written."""
    leaves, _ = tree_flatten(tree)
    np.savez(_npz_path(path), **{f"leaf_{i}": leaf.detach().cpu().numpy()
                                 for i, leaf in enumerate(leaves)})
    return len(leaves)


def load_pytree(path: str, like: _T) -> _T:
    """Load a tree saved by ``save_pytree``.  ``like`` supplies the
    structure, the dtypes, the shapes and the device of each leaf (its
    values are ignored); a mismatch of any of the first three raises
    ``ValueError``."""
    data = np.load(_npz_path(path))
    leaves_like, spec = tree_flatten(like)
    if len(data.files) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(data.files)} leaves, template has "
            f"{len(leaves_like)} — structure changed since saving")
    leaves = []
    for i, tmpl in enumerate(leaves_like):
        loaded = torch.from_numpy(np.array(data[f"leaf_{i}"]))
        if loaded.shape != tmpl.shape or loaded.dtype != tmpl.dtype:
            raise ValueError(
                f"checkpoint leaf {i} is {loaded.dtype}{list(loaded.shape)} "
                f"but the template expects {tmpl.dtype}{list(tmpl.shape)} — "
                "same-arity reshape would mis-broadcast downstream")
        leaves.append(loaded.to(tmpl.device))
    return tree_unflatten(spec, leaves)


def _resume_t0(sol, m, pars):
    """The first barrier parameter of the resumed continuation, per
    instance, or None when every instance is already past the target.
    Raises ValueError on an unhealthy checkpoint."""
    gaps = sol.duality_gap
    gh = gaps.detach().cpu().numpy()
    if not np.all(np.isfinite(gh)) or np.any(gh <= 0):
        raise ValueError(
            f"cannot resume from gap={gh!r} (unhealthy checkpoint — "
            "check sol.status)")
    if np.all(gh <= pars.tol):
        # already past the target: re-entering the continuation with
        # t0 > t_max would skip the loop and return its (inf, inf) init
        # diagnostics; the checkpoint IS the finished solution
        return None
    if gaps.dim() == 0:
        return pars.mu * m / float(gh)   # the stage after the checkpoint
    # a batch: t0 capped below the loop's entry threshold, so the ALREADY
    # converged instances of a mixed batch run one cheap closing stage
    # instead of returning the init diagnostics
    return torch.clamp(pars.mu * m / gaps, max=0.99 * pars.mu * m / pars.tol)


def resume_barrier(obj, cnts, sol, pars=None, eqs=None):
    """Continue a barrier continuation from a checkpointed Solution
    (batched (B, n) or one instance (n,)).

    The barrier method's whole state is (x, t): ``sol.x`` is strictly
    feasible (an interior iterate) and t comes from the reported gap m/t.
    Returns the finished Solution, of the result quality of a run straight
    through (the continuation is memoryless)."""
    pars = pars or SolverParams()
    t0 = _resume_t0(sol, cnts.m, pars)
    if t0 is None:
        return sol
    if sol.x.dim() == 1:
        return instance(barrier_solve(obj, cnts, sol.x[None], pars, eqs=eqs,
                                    t0=t0))
    return barrier_solve(obj, cnts, sol.x, pars, eqs=eqs, t0=t0)


def resume_structured(obj, U, ub, A, b, sol, pars=None):
    """Continue a STRUCTURED (Woodbury) barrier continuation, the BR_fast
    route, from a checkpointed Solution: the same memorylessness argument
    as ``resume_barrier``, with m = k + n (the k dense rows plus the n
    built-in positivity terms)."""
    pars = pars or SolverParams()
    m = U.shape[0] + sol.x.shape[-1]
    t0 = _resume_t0(sol, m, pars)
    if t0 is None:
        return sol
    if sol.x.dim() == 1:
        return instance(barrier_solve_structured(obj, U, ub, A, b,
                                               sol.x[None], pars, t0=t0))
    return barrier_solve_structured(obj, U, ub, A, b, sol.x, pars, t0=t0)

