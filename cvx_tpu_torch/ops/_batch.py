"""Broadcasting helpers for data that is shared by a batch or given per
instance.

A shared leaf has its base shape ((m, n), (m,), ...); a per-instance leaf
has one leading batch axis more ((B, m, n), (B, m), ...).  Points carry
the batch axis first and may carry more axes after it (the candidates of
a line search: (B, L, n)), so a per-instance leaf is viewed with ones
inserted after its batch axis before it meets them.
"""

from __future__ import annotations


def lead(v, base: int, x):
    """``v`` viewed to broadcast against points ``x`` (B, ..., n): a
    shared leaf (``base`` dims) as it is, a per-instance one (B, *base)
    as (B, 1, ..., *base)."""
    if v is None or v.dim() == base or x.dim() <= 2:
        return v
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), *v.shape[1:])


def take(v, base: int, idx):
    """Instances ``idx`` of a leaf: a per-instance leaf's rows, a shared
    leaf as it is."""
    return v if v is None or v.dim() == base else v[idx]


def take_params(params, dims, idx):
    """Instances ``idx`` of function parameters whose batch axes are given
    as ``torch.func.vmap`` in_dims (None: shared)."""
    if dims is None:
        return params
    if isinstance(dims, int):
        from torch.utils._pytree import tree_map

        return tree_map(lambda a: a.index_select(dims, idx), params)
    return type(params)(take_params(p, d, idx) for p, d in zip(params, dims))


def mv(M, v):
    """M v over the last axis of ``v``: ``M`` shared (r, c) is one GEMM
    for the whole batch; ``M`` (B, r, c) against ``v`` (B, ..., c)."""
    if M.dim() == 2:
        return v @ M.mT
    if M.dim() != v.dim() + 1:
        M = lead(M, 2, v)
    return (M @ v[..., None])[..., 0]
