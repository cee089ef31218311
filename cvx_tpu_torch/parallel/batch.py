"""Instance-batch parallel solving: the batch axis on one card, and split
over ranks.

Counterpart of ``cvx_tpu/parallel/batch.py``.  The reference lifts a
one-instance solver with ``jax.vmap`` and shards the lifted solver with
``shard_map``.  The port's solvers are batch-first (the batch leads every
leaf), so:

  * ``vmap_solve``  -- the identity: a batch-native solver already solves
    thousands of same-shape instances in one call;
  * ``shard_solve`` -- each rank runs the solver on its share of the
    leading axis; there is no communication during the solve, and every
    output leaf is all-gathered back to the whole batch on every rank,
    which is what the reference returns (one all-gather per dtype).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..tree import tree_flatten, tree_unflatten
from .mesh import Mesh


def vmap_solve(solve_fn: Callable) -> Callable:
    """``solve_fn`` itself: the port's solvers take a batch on the leading
    axis of every argument (the reference's ``jit(vmap(solve_fn))``)."""
    return solve_fn


def shard_solve(solve_fn: Callable, mesh: Mesh, axis: str = "dp"
                ) -> Callable:
    """The batch split over the mesh axis ``axis``: each rank calls the batch-native
    ``solve_fn`` on its rows of every argument's leading axis, and every
    tensor of the result is all-gathered to the whole batch, in rank
    order, on every rank.  The batch size must divide by the mesh size.
    Arguments stay on their device."""
    mesh.check_axis(axis)

    def run(*args):
        leaves, spec = tree_flatten(args)
        rows = [mesh.local_rows(v.shape[0], "batch") for v in leaves]
        out = solve_fn(*tree_unflatten(spec, [v[r] for v, r in
                                              zip(leaves, rows)]))
        out_leaves, out_spec = tree_flatten(out)
        return tree_unflatten(out_spec, _gather_leaves(mesh, out_leaves))

    return run


def _gather_leaves(mesh: Mesh, leaves: list) -> list:
    """Every leaf all-gathered on its leading axis, one collective per
    dtype: the leaves of a dtype travel as the columns of one buffer."""
    groups: dict = {}
    for i, v in enumerate(leaves):
        if v.dim() == 0:
            raise ValueError("shard_solve: every output needs the batch "
                             "axis first; got a scalar")
        groups.setdefault((v.dtype, v.device), []).append(i)
    out = [None] * len(leaves)
    for idx in groups.values():
        cols = [math.prod(leaves[i].shape[1:]) for i in idx]
        rows = leaves[idx[0]].shape[0]
        buf = torch.cat([leaves[i].reshape(rows, c)
                         for i, c in zip(idx, cols)], dim=1)
        for i, part in zip(idx, torch.split(mesh.gather(buf), cols, dim=1)):
            out[i] = part.reshape(part.shape[0], *leaves[i].shape[1:])
    return out
