"""Batched Cholesky factorization: plain PyTorch version, CUDA kernel and
the dispatcher.

Counterpart of ``cvx_tpu/ops/pallas_chol.py``.  One kernel, in
``csrc/chol.cu`` and bound through ``_build.py``:

* ``cholesky_batched_cuda`` (K4) replaces the Pallas kernel
  ``_chol_tile_kernel`` (``pallas_call`` at pallas_chol.py:139): the lower
  Cholesky factor of a batch of SPD matrices, its strict upper triangle
  zeroed.  Up to ``held_max_n(dtype)`` the kernel holds the matrix in
  registers and factors it column by column (the held path); above, up to
  ``max_n(dtype)``, it factors column blocks of bk = 32 left-looking,
  the update of each a register-tiled product over the earlier columns
  (the panel path).

``cholesky_batched_plain`` is the same algorithm in PyTorch ops (not
``torch.linalg.cholesky``).  The TPU kernel padded n to a multiple of 128
with an identity diagonal and extracted each column by mask and reduce;
both were Mosaic limits, and neither is carried over: any n is factored
as it is, with a ragged last block.

``cholesky_batched(x, method)`` dispatches as the reference's does, with
the methods renamed for this platform: ``"torch"`` (the default) is
``torch.linalg.cholesky``, the counterpart of the reference's ``"xla"``;
``"cuda"`` is K4, the counterpart of ``"pallas"``.  Both give NaN where a
matrix is not positive definite: ``"torch"`` NaNs the whole lower
triangle, as XLA's Cholesky does, and ``"cuda"`` the columns from the
failed pivot on, as the reference's kernel does.
"""

from __future__ import annotations

import math

import torch

from .._spans import span
from . import _build

_BK = 32           # column block width (kBk in csrc/chol.cu)
# the held path's largest n (kHeldMaxN, kHeldMaxNF64 in csrc/chol.cu)
_HELD_MAX_N = {torch.float32: 192, torch.float64: 192}
# the largest n the launcher takes (kMaxN, kMaxNF64 in csrc/chol.cu)
_MAX_N = {torch.float32: 1760, torch.float64: 880}


def cholesky_batched_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device, f32 or f64): the lower
    factor of ``x`` (B, n, n), upper triangle zeroed."""
    _check(x)
    M = x.clone()
    n = M.shape[-1]
    for j0 in range(0, n, _BK):
        j1 = min(j0 + _BK, n)
        for j in range(j0, j1):
            rs = 1.0 / torch.sqrt(M[:, j, j])
            M[:, j:, j] = M[:, j:, j] * rs[:, None]
            if j + 1 < j1:
                # rank-1 update of the block's later columns
                M[:, j + 1:, j + 1:j1] -= (M[:, j + 1:, j, None]
                                           * M[:, None, j + 1:j1, j])
        if j1 < n:
            P = M[:, j1:, j0:j1]
            M[:, j1:, j1:] -= P @ P.transpose(1, 2)
    return torch.tril(M)


def _check(x):
    if x.dim() != 3 or x.shape[1] != x.shape[2]:
        raise ValueError(f"cholesky_batched: x must be (B, n, n), got "
                         f"{tuple(x.shape)}")


def max_n(dtype) -> int:
    """Largest n the kernel takes: the limit the first panel design's
    shared memory set (n x (bk + 1) elements in 232,448 bytes), kept by
    the launcher; the left-looking panel path does not need it."""
    return _MAX_N[dtype]


def held_max_n(dtype) -> int:
    """Largest n the kernel factors on its held path (the matrix in
    registers, one fma per element and column); larger n, up to
    ``max_n(dtype)``, take the panel path."""
    return _HELD_MAX_N[dtype]


@span("cvx.kernel.cholesky_batched_cuda")
def cholesky_batched_cuda(x: torch.Tensor) -> torch.Tensor:
    """K4: the lower Cholesky factor of each matrix of ``x`` (B, n, n),
    upper triangle zeroed, NaN from a non-positive pivot on.

    CPU tensors run the plain version.  CUDA tensors (f32 or f64, n <=
    ``max_n(dtype)``: 1760 in f32, 880 in f64; any batch and row stride,
    contiguous columns) run the CUDA kernel, one block per matrix, on the
    current stream; anything it does not take raises.
    ``cholesky_batched_cuda.launches`` counts kernel launches.
    """
    _check(x)
    if x.device.type == "cpu":
        return cholesky_batched_plain(x)
    if x.device.type != "cuda" or x.dtype not in (torch.float32,
                                                  torch.float64):
        raise ValueError("cholesky_batched_cuda: takes CPU tensors or "
                         f"f32/f64 CUDA tensors, got {x.dtype} on "
                         f"{x.device}")
    B, n, _ = x.shape
    if n > max_n(x.dtype):
        raise ValueError(f"cholesky_batched_cuda: n = {n} > {max_n(x.dtype)}"
                         f", the largest {x.dtype} n the kernel takes")
    if n > 1 and x.stride(2) != 1:
        raise ValueError("cholesky_batched_cuda: the columns of x must be "
                         "contiguous (stride 1); call .contiguous()")
    L = torch.empty((B, n, n), dtype=x.dtype, device=x.device)
    if B == 0 or n == 0:
        return L
    fn = "chol_batched_f32" if x.dtype == torch.float32 else "chol_batched_f64"
    _build.launch(_build.load("chol"), fn, "cholesky_batched_cuda", x.device,
                  _build.ptr(x), x.stride(0), x.stride(1), _build.ptr(L), B,
                  n)
    cholesky_batched_cuda.launches += 1
    return L


cholesky_batched_cuda.launches = 0


def cholesky_batched(x: torch.Tensor, method: str = "torch") -> torch.Tensor:
    """Batched Cholesky dispatch: "torch" (``torch.linalg.cholesky``, the
    reference's "xla") or "cuda" (K4, the reference's "pallas")."""
    if method == "torch":
        L, info = torch.linalg.cholesky_ex(x)
        # XLA's answer for a failed factorization: NaN lower triangle
        nan = torch.full_like(L[:1], math.nan).tril()
        return torch.where((info > 0)[..., None, None], nan, L)
    if method == "cuda":
        return cholesky_batched_cuda(x)
    raise ValueError(f"unknown cholesky method: {method!r}")
