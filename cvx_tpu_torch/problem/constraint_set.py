"""ConstraintSet, the inequality-constraint aggregate, over a batch.

Counterpart of ``cvx_tpu/problem/constraint_set.py`` (cvx/
ConstraintSet.scala): a tuple of blocks with the stacked views (values,
Jacobian Dg(x), dual start lambda_i = -1/f_i(x)), the strict-feasibility
predicate of the line searches, the fused barrier assembly

    phi(t,x)  = t f0(x) - sum_i log d_i,           d = ub - g(x)
    grad      = t g0    + Dg(x)^T (1/d)
    hess      = t H0    + Dg^T diag(1/d^2) Dg + sum_i hess(g_i)/d_i

and the phase-I lifts.  Points are (B, n) (or (B, L, n) for values); the
barrier parameter ``t`` is a number or one per instance, shaped like the
points' leading axes or broadcastable to them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops._batch import lead, mv
from .constraints import LinearBlock
from .sets import Domain, whole_space


def _cat_last(parts, base: int):
    """Concatenate leaves along the last axis; shared ones (``base`` dims)
    are expanded to the batch axis when any part is per instance."""
    B = next((p.shape[0] for p in parts if p.dim() > base), None)
    if B is not None:
        parts = [p if p.dim() > base else p.expand(B, *p.shape)
                 for p in parts]
    return torch.cat(parts, dim=-1)


def _cat_rows(parts):
    """Stack Jacobian blocks (..., m_i, n) along the rows, broadcasting
    their leading axes."""
    if len(parts) == 1:
        return parts[0]
    lead_shape = torch.broadcast_shapes(*(p.shape[:-2] for p in parts))
    return torch.cat([p.expand(*lead_shape, *p.shape[-2:]) for p in parts],
                     dim=-2)


def gtwg(G, w):
    """G^T diag(w) G per instance: G (m, n) or (B, m, n), w (B, m)."""
    return (G.mT * w[..., None, :]) @ G


@dataclass(frozen=True)
class ConstraintSet:
    blocks: tuple
    domain: Domain = None   # set where the constraints are defined

    def __post_init__(self):
        if self.domain is None:
            object.__setattr__(self, "domain", whole_space())

    # ------------------------------------------------------------------ views
    @property
    def m(self) -> int:
        return sum(b.m for b in self.blocks)

    @property
    def dim(self) -> int:
        return self.blocks[0].dim

    @property
    def ub(self):
        return _cat_last([b.ub for b in self.blocks], 1)

    @property
    def dtype(self):
        return self.ub.dtype

    def value(self, x):
        """All g_i(x), stacked (ConstraintSet.scala:90-94)."""
        return torch.cat([b.value(x) for b in self.blocks], dim=-1)

    def residual(self, x):
        """f_i(x) = g_i(x) - ub_i  (<= 0 when feasible)."""
        return self.value(x) - lead(self.ub, 1, x)

    def margins(self, x):
        """d_i = ub_i - g_i(x)  (> 0 when strictly feasible)."""
        return lead(self.ub, 1, x) - self.value(x)

    def jac(self, x):
        """Stacked Dg(x), one constraint gradient per row
        (ConstraintSet.scala:100-110); shared (m, n) when every block's
        is."""
        return _cat_rows([b.jac(x) for b in self.blocks])

    def whess(self, x, w):
        """sum_i w_i hess(g_i)(x), split across blocks."""
        out, off = None, 0
        for b in self.blocks:
            if not isinstance(b, LinearBlock):
                h = b.whess(x, w[..., off:off + b.m])
                out = h if out is None else out + h
            off += b.m
        if out is None:
            n = x.shape[-1]
            out = x.new_zeros(()).expand(*x.shape[:-1], n, n)
        return out

    def satisfied_strictly(self, x, slack: float = 0.0):
        """all g_i(x) < ub_i (strictly) and x in the domain, per point
        (ConstraintSet.scala:28, Constraint.scala:23)."""
        return (torch.all(self.margins(x) > slack, dim=-1)
                & self.domain.contains(x))

    def lambda_init(self, x):
        """Dual start lambda_i = -1/f_i(x) (ConstraintSet.scala:116-120)."""
        return -1.0 / self.residual(x)

    # -------------------------------------------------------------- barrier
    def barrier_value(self, obj, t, x):
        d = self.margins(x)
        return t * obj.value(x) - torch.sum(torch.log(d), dim=-1)

    def barrier_grad(self, obj, t, x):
        d = self.margins(x)
        return _col(t) * obj.grad(x) + mv(self.jac(x).mT, 1.0 / d)

    def barrier_hess(self, obj, t, x):
        d = self.margins(x)
        G = self.jac(x)
        return (_col(t, 2) * obj.hess(x) + gtwg(G, 1.0 / (d * d))
                + self.whess(x, 1.0 / d))

    def barrier_value_grad_hess(self, obj, t, x):
        """All three barrier quantities at points (B, n) with the margins
        and the Jacobian computed once (the per-Newton-step hot path)."""
        d = self.margins(x)
        G = self.jac(x)
        inv_d = 1.0 / d
        val = t * obj.value(x) - torch.sum(torch.log(d), dim=-1)
        grad = _col(t) * obj.grad(x) + mv(G.mT, inv_d)
        hess = (_col(t, 2) * obj.hess(x) + gtwg(G, inv_d * inv_d)
                + self.whess(x, inv_d))
        return val, grad, hess

    # -------------------------------------------------------------- phase I
    def lift_phase1(self) -> "ConstraintSet":
        """g_j(x) - s <= ub_j on (x, s) (ConstraintSet.scala:153-168)."""
        return ConstraintSet(blocks=tuple(b.lift_phase1() for b in self.blocks),
                             domain=self.domain.lift(1))

    def phase1_feasible_point(self, x0):
        """(x0, s0) with s0 = 1 + max_j (g_j(x0) - ub_j): strictly feasible
        for the lifted constraints (ConstraintSet.scala:161-163)."""
        s0 = 1.0 + torch.amax(self.residual(x0), dim=-1)
        return torch.cat([x0, s0[..., None]], dim=-1)

    def lift_soi(self) -> "ConstraintSet":
        """One slack per constraint: g_i(x) - s_i <= ub_i plus s_i >= 0, on
        (x, s) in dimension n + m (ConstraintSet.scala:233-282)."""
        p, n = self.m, self.dim
        lifted, off = [], 0
        for b in self.blocks:
            lifted.append(b.lift_soi(p, off))
            off += b.m
        ub = self.ub
        z = torch.zeros((p,), dtype=ub.dtype, device=ub.device)
        Gs = torch.cat([torch.zeros((p, n), dtype=ub.dtype, device=ub.device),
                        -torch.eye(p, dtype=ub.dtype, device=ub.device)],
                       dim=1)
        lifted.append(LinearBlock(G=Gs, c=z, ub=z.clone()))
        return ConstraintSet(blocks=tuple(lifted), domain=self.domain.lift(p))

    def soi_feasible_point(self, x0):
        """(x0, s0) with s0_i = max(0.5, 1 + g_i(x0) - ub_i)
        (ConstraintSet.scala:269-271)."""
        s0 = torch.clamp_min(1.0 + self.residual(x0), 0.5)
        return torch.cat([x0, s0], dim=-1)

    # ------------------------------------------------------------- transform
    def affine_pullback(self, z, F) -> "ConstraintSet":
        """Restrict to the affine space x = z + F u
        (ConstraintSet.scala:580-591)."""
        return ConstraintSet(
            blocks=tuple(b.affine_pullback(z, F) for b in self.blocks),
            domain=self.domain.affine_pullback(z, F))

    def take(self, idx) -> "ConstraintSet":
        """The constraints of instances ``idx``."""
        return ConstraintSet(blocks=tuple(b.take(idx) for b in self.blocks),
                             domain=self.domain.take(idx))

    def add_blocks(self, *extra) -> "ConstraintSet":
        return ConstraintSet(blocks=self.blocks + tuple(extra),
                             domain=self.domain)


def _col(t, extra: int = 1):
    """A per-instance t (B,) as (B, 1) or (B, 1, 1); a number as it is."""
    if isinstance(t, torch.Tensor) and t.dim() > 0:
        return t.reshape(*t.shape, *([1] * extra))
    return t
