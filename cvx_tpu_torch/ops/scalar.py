"""Scalar (1-D) root finding over a batch of brackets or starts.

Counterpart of ``cvx_tpu/ops/scalar.py`` (cvx/MathUtils.scala:36-71):
bisection and 1-D Newton.  The reference runs one root in a bounded
``lax.while_loop`` and is vmapped; here every element of ``lo`` / ``x0``
is one root, and the loop is masked: an element whose loop has ended
keeps its value, and the loop runs while any element is still in it, so
each gets the iterates of its own run.  ``f`` is written in torch for
one scalar and is mapped over the elements with ``torch.func.vmap``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, vmap


def _floats(v, like=None):
    """``v`` as a floating tensor: ``like``'s dtype and device, else a
    floating tensor's own dtype, else float64 (the reference's canonical
    float)."""
    if like is not None:
        return torch.as_tensor(v).to(dtype=like.dtype, device=like.device)
    if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
        return v
    return torch.as_tensor(v, dtype=torch.float64)


def _over(f):
    """``f`` of one scalar, over every element of a tensor."""
    def mapped(x):
        if x.dim() == 0:
            return f(x)
        return vmap(f)(x.reshape(-1)).reshape(x.shape)
    return mapped


def bisect(f: Callable, lo, hi, *, tol: float = 1e-12,
           max_iter: int = 200) -> torch.Tensor:
    """Roots of f on [lo, hi] with f(lo), f(hi) of opposite sign
    (MathUtils.scala:36-52), one per element of ``lo``."""
    lo = _floats(lo)
    hi = _floats(hi, lo)
    lo, hi = torch.broadcast_tensors(lo, hi)
    lo, hi = lo.clone(), hi.clone()
    fv = _over(f)
    f_lo = fv(lo)
    it = 0
    go = hi - lo > tol
    while it < max_iter and bool(go.any()):
        mid = 0.5 * (lo + hi)
        same_side = fv(mid) * f_lo > 0
        lo = torch.where(go & same_side, mid, lo)
        hi = torch.where(go & ~same_side, mid, hi)
        it += 1
        go = go & (hi - lo > tol)
    return 0.5 * (lo + hi)


def newton_1d(f: Callable, x0, *, tol: float = 1e-12,
              max_iter: int = 100) -> torch.Tensor:
    """1-D Newton x <- x - f(x)/f'(x) from each element of ``x0``, the
    derivative by ``torch.func.grad`` (MathUtils.scala:57-71 hands in f'
    explicitly)."""
    x = _floats(x0).clone()
    fv, dfv = _over(f), _over(grad(f))
    it = 0
    go = torch.abs(fv(x)) > tol
    while it < max_iter and bool(go.any()):
        x = torch.where(go, x - fv(x) / dfv(x), x)
        it += 1
        go = go & (torch.abs(fv(x)) > tol)
    return x
