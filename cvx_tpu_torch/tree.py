"""Dataclass trees: flatten, rebuild and move the port's records, and the
exact-f32 guard of the solvers.

Counterpart of ``cvx_tpu/tree.py``.  The port's problems and results are
dataclasses of tensors (frozen for problems), nested in tuples, lists and
dicts.  A tree's leaves are its tensors in field order (dict keys
sorted, as ``jax.tree_util`` orders them); every other value (ints,
strings, callables, fields marked ``static_field``) is structure, kept in
the tree's spec and never a leaf.  ``None`` is an empty subtree, as in
JAX, so a ``Solution`` with ``ineq_res=None`` has one leaf fewer.

``exact_f32`` is the counterpart of ``mxu_exact``: every solver entry
runs its f32 contractions at full precision, whatever the caller set
(TF32 matmuls carry a 10-bit mantissa, and f32 Newton systems stall near
1e-3 with them).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Any, Callable, TypeVar

import torch

_T = TypeVar("_T")


def static_field(**kwargs: Any) -> Any:
    """A dataclass field kept as structure, never a leaf, even where its
    value is a tensor."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def replace(obj: _T, **changes: Any) -> _T:
    """``dataclasses.replace``."""
    return dataclasses.replace(obj, **changes)


# a spec is ("leaf",), ("none",), ("const", value),
# ("dc", cls, ((name, spec), ...)), ("seq", type, (spec, ...)) or
# ("dict", keys, (spec, ...))


def _flatten(node, leaves):
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return ("leaf",)
    if node is None:
        return ("none",)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        parts = []
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            parts.append((f.name, ("const", v) if f.metadata.get("static")
                          else _flatten(v, leaves)))
        return ("dc", type(node), tuple(parts))
    if isinstance(node, (tuple, list)):
        return ("seq", type(node), tuple(_flatten(v, leaves) for v in node))
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys, tuple(_flatten(node[k], leaves) for k in keys))
    return ("const", node)


def tree_flatten(tree) -> tuple[list, tuple]:
    """(leaves in tree order, spec)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _build(spec, it):
    kind = spec[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "const":
        return spec[1]
    if kind == "dc":
        return spec[1](**{name: _build(s, it) for name, s in spec[2]})
    if kind == "seq":
        items = [_build(s, it) for s in spec[2]]
        return items if spec[1] is list else spec[1](items)
    keys, specs = spec[1], spec[2]
    return {k: _build(s, it) for k, s in zip(keys, specs)}


def tree_unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec has")
    return out


def tree_map(fn: Callable, tree):
    """The tree with ``fn`` applied to every leaf."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [fn(v) for v in leaves])


def instance(tree, i: int = 0):
    """Instance ``i`` of a batched tree: every leaf indexed on its leading
    axis (a batched Solution's record of one instance)."""
    return tree_map(lambda v: v[i], tree)


def to(tree, device=None, dtype=None):
    """The tree with every leaf on ``device`` (and floating leaves in
    ``dtype`` where given)."""
    def move(v):
        if dtype is not None and v.dtype.is_floating_point:
            return v.to(device=device, dtype=dtype)
        return v.to(device=device)

    return tree_map(move, tree)


@contextlib.contextmanager
def exact_f32_matmuls():
    """For the duration: ``torch.set_float32_matmul_precision("highest")``,
    no TF32 in cuBLAS or cuDNN; the caller's settings come back after,
    also on an exception."""
    with warnings.catch_warnings():
        # a caller who mixed the legacy and the new precision APIs gets
        # a warning from this read; their settings are restored as read
        warnings.simplefilter("ignore")
        saved = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        # the precision first: setting it also sets cuBLAS's TF32 flag
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def exact_f32(fn):
    """Run the wrapped solver under ``exact_f32_matmuls``."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with exact_f32_matmuls():
            return fn(*args, **kwargs)

    return wrapped
