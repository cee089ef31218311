"""The KL dual gap certificate of a batch of primal iterates: plain
PyTorch version and CUDA kernel.

``kl_gap_fused`` computes the reference's ``kl_dual_gap``
(``cvx_tpu/models/dist_kl.py``) for a batch of iterates x (B, n) against
shared rows H (k, n) and a full equality system A (p, n), per-instance
bounds u (B, k) and right-hand sides b (B, p):

    c  = -(1 + log x - log p)                         the stationarity fit
    z  = (BB' + ridge I)^-1 B c,  lam = z[:k] >= 0    B = [H; A]
    z <- polish_steps line-searched projected-Newton steps on
         -L*(z) = w.z + R.exp(-B'z)                   w = (u, b), R = p / e
    gap = f(x) - g(z) = x.(log x - log p) + w.z + R.exp(-B'z)

and returns ``(gap (B,), z (B, k + p))``.  The reference is plain JAX that
XLA fuses, so this kernel replaces no Pallas kernel: on the card the same
algebra as torch ops was ~1,580 small launches a call of the primal route.

``kl_gap_fused_plain`` is that algebra as batched tensor code (the fit,
``duality._polish_dual``, the gap), which ``models.dist_kl.kl_dual_gap``
ran before the kernel; it runs on any device, and the CPU tests hold it to
the JAX reference.  The wrapper ``kl_gap_fused`` takes the plain version
for tensors on any device but CUDA; CUDA tensors run the kernel
(``csrc/kl_gap.cu``, one warp an instance; f32 or f64, dual dim k + p in
1..8) or raise.  ``route_of`` is ``kl_dual_gap``'s rule: a CUDA call the
kernel does not take runs the plain version's torch ops on the card (the
"chain"), every other call the wrapper.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .._spans import span
from ..duality import _polish_dual, _small_solve, _value_band
from . import _build

# widest dual dimension k + p the kernel unrolls (csrc/kl_gap.cu kMaxDim)
_MAX_DIM = 8
_KERNEL_DTYPES = (torch.float32, torch.float64)


def _uniform_terms(n):
    """(log p, R = p/e) of the uniform prior p = 1/n, as Python floats."""
    return -math.log(float(n)), 1.0 / (n * np.e)


def _prior_terms(prior, n, dtype, device=None):
    """(log p, R = p/e) for an optional shared prior (None = the
    reference's uniform).  The one place the conversion lives."""
    if prior is None:
        logp, r = _uniform_terms(n)
        return (torch.tensor(logp, dtype=dtype, device=device),
                torch.full((n,), r, dtype=dtype, device=device))
    p = prior.to(dtype)
    return torch.log(p), p / np.e


@dataclass
class _NegDualObjective:
    """-L*(z) = w.z + R.exp(-B'z) (convex).  ``w`` is (dim,) for one
    instance or (Bt, dim) per instance, against points z (Bt, ..., dim)."""

    B: torch.Tensor   # (mI + 1 + mE, n), shared
    w: torch.Tensor   # (mI + 1 + mE,) or (Bt, mI + 1 + mE)
    R: torch.Tensor   # (n,)

    def take(self, idx):
        """The dual objective of instances ``idx``."""
        return dataclasses.replace(self, w=self.w if self.w.dim() == 1
                                   else self.w[idx])

    def _w(self, z):
        if self.w.dim() == 1:
            return self.w
        return self.w.reshape(self.w.shape[0], *([1] * (z.dim() - 2)),
                              self.w.shape[1])

    def _y(self, z):
        return self.R * torch.exp(-(z @ self.B))

    def value(self, z):
        return (self._w(z) * z).sum(dim=-1) + self._y(z).sum(dim=-1)

    def grad(self, z):
        return self._w(z) - self._y(z) @ self.B.T

    def hess(self, z):
        return (self.B * self._y(z)[..., None, :]) @ self.B.T


def route_of(device, dtype, dim):
    """What ``kl_dual_gap`` runs at dual dim ``dim`` = k + p on tensors of
    ``dtype`` on ``device``: ``"chain"`` for a CUDA call the kernel does
    not take (not f32 or f64, or dim outside 1..8: the plain version's
    torch ops on the card), else ``"wrapper"`` (``kl_gap_fused``: the
    kernel on CUDA, the plain version on any other device)."""
    if torch.device(device).type == "cuda" and not (
            dtype in _KERNEL_DTYPES and 1 <= dim <= _MAX_DIM):
        return "chain"
    return "wrapper"


def kl_gap_fused_plain(H, u, A, b, x, polish_steps: int = 8,
                       value_band_eps: float | None = None, prior=None):
    """Plain PyTorch version (any device): ``(gap (B,), z (B, k + p))``.

    For any lam >= 0 and any nu, g(z) = -(w.z + R.exp(-B'z)) is a lower
    bound on the optimum, so f(x) - g(z) is an honest certificate.  z
    starts from the least-squares fit of the stationarity condition
    log x - log p + 1 + B'z = 0 (lam >= 0) and is sharpened by
    ``polish_steps`` projected-Newton steps on -g."""
    dtype = x.dtype
    n = x.shape[-1]
    # a coordinate that underflowed to 0 would poison the fit with log 0
    x = torch.clamp_min(x, 1e-30)
    k = H.shape[0]
    Bm = torch.cat([H, A], dim=0).to(dtype)
    w = torch.cat([u, b], dim=1).to(dtype)
    logp, R = _prior_terms(prior, n, dtype, x.device)
    dim = Bm.shape[0]
    c = -(1.0 + torch.log(x) - logp)
    BBt = Bm @ Bm.T
    ridge = (10 * torch.finfo(dtype).eps
             * torch.abs(torch.diagonal(BBt)).mean())
    BBt = BBt + ridge * torch.eye(dim, dtype=dtype, device=x.device)
    z = _small_solve(BBt.expand(x.shape[0], dim, dim), c @ Bm.T)
    mask = torch.arange(dim, device=x.device) < k
    z = torch.where(mask, torch.clamp_min(z, 0.0), z)
    neg_dual = _NegDualObjective(B=Bm, w=w, R=R)
    z = _polish_dual(neg_dual, z, num_ineq=k, steps=polish_steps,
                     value_band_eps=value_band_eps)
    dual_val = -neg_dual.value(z)
    primal_val = (x * (torch.log(x) - logp)).sum(dim=-1)
    return primal_val - dual_val, z


def _check_args(H, u, A, b, x, prior, polish_steps):
    """The kernel's shape, dtype, device and stride contract; raises on
    anything it does not take."""
    name = "kl_gap_fused"
    if H.dim() != 2 or A.dim() != 2 or u.dim() != 2 or b.dim() != 2 \
            or x.dim() != 2:
        raise ValueError(f"{name}: H (k, n), A (p, n), u (B, k), b (B, p) "
                         f"and x (B, n) must be 2-D, got {tuple(H.shape)}, "
                         f"{tuple(A.shape)}, {tuple(u.shape)}, "
                         f"{tuple(b.shape)}, {tuple(x.shape)}")
    (k, n), (B, p) = H.shape, (x.shape[0], A.shape[0])
    if (A.shape[1] != n or tuple(x.shape) != (B, n)
            or tuple(u.shape) != (B, k) or tuple(b.shape) != (B, p)):
        raise ValueError(f"{name}: shapes H {tuple(H.shape)}, u "
                         f"{tuple(u.shape)}, A {tuple(A.shape)}, b "
                         f"{tuple(b.shape)}, x {tuple(x.shape)} do not agree")
    if not 1 <= k + p <= _MAX_DIM or n < 1 or polish_steps < 0:
        raise ValueError(f"{name}: the kernel takes 1 <= k + p <= "
                         f"{_MAX_DIM}, n >= 1 and polish_steps >= 0, got k="
                         f"{k}, p={p}, n={n}, polish_steps={polish_steps}")
    if prior is not None and tuple(prior.shape) != (n,):
        raise ValueError(f"{name}: prior must be ({n},), got "
                         f"{tuple(prior.shape)}")
    for t in (H, u, A, b) + (() if prior is None else (prior,)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: every tensor must be {x.dtype} on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    for t in (H, A, x):
        if n > 1 and t.shape[0] > 0 and t.stride(1) != 1:
            raise ValueError(f"{name}: the lane axis of H, A and x must be "
                             "contiguous (stride 1); call .contiguous()")
    if x.device.type != "cuda" or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"{name}: the kernel takes f32 or f64 CUDA "
                         f"tensors, got {x.dtype} on {x.device}")


@span("cvx.kernel.kl_gap_fused")
def kl_gap_fused(H, u, A, b, x, polish_steps: int = 8,
                 value_band_eps: float | None = None, prior=None):
    """The KL dual gap certificate of a batch of iterates x (B, n):
    ``(gap (B,), z (B, k + p))`` as ``kl_gap_fused_plain`` returns them.

    Tensors on any device but CUDA run the plain version.  CUDA tensors
    (H, u, A, b, x and the prior all of one dtype, f32 or f64;
    1 <= k + p <= 8; the lane axis of H, A and x contiguous) run the CUDA
    kernel on the current stream;
    anything it does not take raises.  ``kl_gap_fused.launches`` counts
    kernel launches."""
    if x.device.type != "cuda":
        return kl_gap_fused_plain(H, u, A, b, x, polish_steps=polish_steps,
                                  value_band_eps=value_band_eps, prior=prior)
    _check_args(H, u, A, b, x, prior, polish_steps)
    B, n = x.shape
    gap = torch.empty((B,), dtype=x.dtype, device=x.device)
    z = torch.empty((B, H.shape[0] + A.shape[0]), dtype=x.dtype,
                    device=x.device)
    if B == 0:
        return gap, z
    # the prior's (log p, R) as (n,) tensors, held until the launch; null
    # for the uniform prior, whose constants the kernel takes as numbers
    ptr = _build.ptr
    terms = (None if prior is None
             else _prior_terms(prior, n, x.dtype, x.device))
    logp, R = (None, None) if terms is None else (ptr(t) for t in terms)
    fn = "kl_gap_fused_f32" if x.dtype == torch.float32 else \
        "kl_gap_fused_f64"
    _build.launch(_build.load("kl_gap"), fn, "kl_gap_fused", x.device,
                  ptr(H), H.stride(0), ptr(u), u.stride(0), u.stride(1),
                  ptr(A), A.stride(0), ptr(b), b.stride(0), b.stride(1),
                  ptr(x), x.stride(0), logp, R, *_uniform_terms(n),
                  ptr(gap), ptr(z), B, n, H.shape[0], A.shape[0],
                  polish_steps,
                  _value_band(torch.finfo(x.dtype).eps, value_band_eps))
    kl_gap_fused.launches += 1
    return gap, z


kl_gap_fused.launches = 0
