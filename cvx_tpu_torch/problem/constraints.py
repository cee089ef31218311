"""Inequality-constraint blocks, evaluated over a batch of points.

Counterpart of ``cvx_tpu/problem/constraints.py`` (cvx/Constraint.scala,
cvx/LinearConstraint.scala, cvx/QuadraticConstraint.scala,
cvx/Constraints.scala): constraints live in homogeneous blocks,

  * ``LinearBlock``     g(x) = c + G x                  (m, n) arrays
  * ``QuadBlock``       g_i  = r_i + a_i.x + x'P_i x/2   (m, n, n) arrays
  * ``NonlinearBlock``  g(x) = fn(params, x), m values, autodiff-derived

each with ``value`` / ``jac`` / ``whess`` (sum_i w_i hess g_i), the
phase-I lifts and the affine pullback x = z + F u.

Points are (B, n), or (B, L, n) for the candidates of a line search.  A
leaf is shared by the batch in its base shape ((m, n), (m,)) or given per
instance with a leading batch axis ((B, m, n), (B, m)); evaluation
broadcasts, so a per-instance bound never copies the shared rows.  A
``NonlinearBlock``'s ``fn(params, x)`` is written in torch for one point
x (n,) and is mapped over the points with ``torch.func.vmap``; its
``params`` are shared unless ``param_dims`` names their batch axes
(``torch.func.vmap`` in_dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.func import grad, jacfwd, vmap

from ..ops._batch import lead, mv, take, take_params
from ..ops.testmat import sign_combination_matrix_padded


def over_points(f, params, param_dims, x):
    """``f(params, x_one)`` over every leading axis of ``x``: the first (the
    instances) with ``param_dims``, the rest with the params shared."""
    if x.dim() == 1:
        return f(params, x)
    g = f
    for _ in range(x.dim() - 2):
        g = vmap(g, in_dims=(None, 0))
    return vmap(g, in_dims=(param_dims, 0))(params, x)


def _eye_rows(m, n_total, offset, like):
    """(m, n_total) with -1 at (i, offset + i)."""
    S = like.new_zeros((m, n_total))
    i = torch.arange(m, device=like.device)
    S[i, offset + i] = -1.0
    return S


def _with_batch(S, like, base):
    """S (shared) expanded to the batch axis of ``like`` when ``like`` is
    per instance."""
    return S if like.dim() == base else S.expand(like.shape[0], *S.shape)


def _zero_hess(x):
    n = x.shape[-1]
    return x.new_zeros(()).expand(*x.shape[:-1], n, n)


@dataclass(frozen=True)
class LinearBlock:
    """m linear constraints c + G x <= ub."""

    G: torch.Tensor    # (m, n) or (B, m, n)
    c: torch.Tensor    # (m,) or (B, m)
    ub: torch.Tensor   # (m,) or (B, m)
    label: str | None = None   # for violation reports

    @property
    def m(self) -> int:
        return self.G.shape[-2]

    @property
    def dim(self) -> int:
        return self.G.shape[-1]

    def value(self, x):
        return lead(self.c, 1, x) + mv(self.G, x)

    def take(self, idx):
        """The block of instances ``idx``."""
        return LinearBlock(G=take(self.G, 2, idx), c=take(self.c, 1, idx),
                           ub=take(self.ub, 1, idx), label=self.label)

    def jac(self, x):
        return lead(self.G, 2, x)

    def whess(self, x, w):
        return _zero_hess(x)

    def lift_phase1(self):
        """g(x) - s <= ub in dimension n + 1 (slack appended last)."""
        col = -torch.ones((*self.G.shape[:-1], 1), dtype=self.G.dtype,
                          device=self.G.device)
        return LinearBlock(G=torch.cat([self.G, col], dim=-1), c=self.c,
                           ub=self.ub, label=self.label)

    def lift_soi(self, n_total: int, offset: int):
        """g_i(x) - s_{offset+i} <= ub_i in dimension dim + n_total."""
        S = _with_batch(_eye_rows(self.m, n_total, offset, self.G), self.G, 2)
        return LinearBlock(G=torch.cat([self.G, S], dim=-1), c=self.c,
                           ub=self.ub, label=self.label)

    def affine_pullback(self, z, F):
        return LinearBlock(G=self.G @ F, c=self.c + mv(self.G, z), ub=self.ub,
                           label=self.label)


def _quad_form(P, x):
    """(P_i x)_i for every constraint: (..., m, n)."""
    return (lead(P, 3, x) @ x[..., None, :, None])[..., 0]


@dataclass(frozen=True)
class QuadBlock:
    """m quadratic constraints r_i + a_i.x + x' P_i x / 2 <= ub_i."""

    P: torch.Tensor    # (m, n, n) or (B, m, n, n), each symmetric
    a: torch.Tensor    # (m, n) or (B, m, n)
    r: torch.Tensor    # (m,) or (B, m)
    ub: torch.Tensor   # (m,) or (B, m)
    label: str | None = None

    @property
    def m(self) -> int:
        return self.a.shape[-2]

    @property
    def dim(self) -> int:
        return self.a.shape[-1]

    def take(self, idx):
        return QuadBlock(P=take(self.P, 3, idx), a=take(self.a, 2, idx),
                         r=take(self.r, 1, idx), ub=take(self.ub, 1, idx),
                         label=self.label)

    def value(self, x):
        Px = _quad_form(self.P, x)
        return (lead(self.r, 1, x) + mv(self.a, x)
                + 0.5 * (Px * x[..., None, :]).sum(dim=-1))

    def jac(self, x):
        return lead(self.a, 2, x) + _quad_form(self.P, x)

    def whess(self, x, w):
        n = self.dim
        if self.P.dim() == 3:
            return (w @ self.P.reshape(self.m, n * n)).reshape(
                *w.shape[:-1], n, n)
        return (w[:, None, :] @ self.P.reshape(-1, self.m, n * n)).reshape(
            w.shape[0], n, n)

    def lift_phase1(self):
        col = -torch.ones((*self.a.shape[:-1], 1), dtype=self.a.dtype,
                          device=self.a.device)
        return QuadBlock(P=torch.nn.functional.pad(self.P, (0, 1, 0, 1)),
                         a=torch.cat([self.a, col], dim=-1), r=self.r,
                         ub=self.ub, label=self.label)

    def lift_soi(self, n_total: int, offset: int):
        S = _with_batch(_eye_rows(self.m, n_total, offset, self.a), self.a, 2)
        return QuadBlock(
            P=torch.nn.functional.pad(self.P, (0, n_total, 0, n_total)),
            a=torch.cat([self.a, S], dim=-1), r=self.r, ub=self.ub,
            label=self.label)

    def affine_pullback(self, z, F):
        az = self.a + _quad_form(self.P, z)
        Ft, Fb = (F.mT, F) if F.dim() == 2 else (F.mT[:, None], F[:, None])
        zPz = (_quad_form(self.P, z) * z[..., None, :]).sum(dim=-1)
        return QuadBlock(P=Ft @ self.P @ Fb, a=az @ F,
                         r=self.r + mv(self.a, z) + 0.5 * zPz, ub=self.ub,
                         label=self.label)


@dataclass(frozen=True)
class NonlinearBlock:
    """m smooth constraints fn(params, x) <= ub, autodiff-derived.
    ``fn`` is written for one point x (n,) and returns (m,)."""

    fn: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any = None
    ub: torch.Tensor = None
    num: int = 0          # m
    in_dim: int = 0       # n
    label: str | None = None
    param_dims: Any = None    # vmap in_dims of params over the instances

    @property
    def m(self) -> int:
        return self.num

    @property
    def dim(self) -> int:
        return self.in_dim

    def value(self, x):
        return over_points(self.fn, self.params, self.param_dims, x)

    def take(self, idx):
        return dataclasses.replace(
            self, params=take_params(self.params, self.param_dims, idx),
            ub=take(self.ub, 1, idx))

    def jac(self, x):
        return over_points(jacfwd(self.fn, argnums=1), self.params,
                           self.param_dims, x)

    def whess(self, x, w):
        """Hessian of the scalar w . fn(params, x), per point; w enters as
        data."""
        fn = self.fn

        def one(params, x_, w_):
            return jacfwd(grad(lambda y: torch.dot(w_, fn(params, y))))(x_)

        if x.dim() == 1:
            return one(self.params, x, w)
        return vmap(one, in_dims=(self.param_dims, 0, 0))(self.params, x, w)

    def _replace(self, fn, in_dim, params=None, param_dims=None):
        return NonlinearBlock(
            fn=fn, params=self.params if params is None else params,
            ub=self.ub, num=self.num, in_dim=in_dim, label=self.label,
            param_dims=self.param_dims if params is None else param_dims)

    def lift_phase1(self):
        fn = self.fn

        def lifted(params, xs):
            return fn(params, xs[:-1]) - xs[-1]

        return self._replace(lifted, self.in_dim + 1)

    def lift_soi(self, n_total: int, offset: int):
        fn, n, m = self.fn, self.in_dim, self.num

        def lifted(params, xs):
            return fn(params, xs[:n]) - xs[n + offset:n + offset + m]

        return self._replace(lifted, n + n_total)

    def affine_pullback(self, z, F):
        fn = self.fn

        def pulled(params, u):
            inner, z_, F_ = params
            return fn(inner, z_ + F_ @ u)

        dims = (self.param_dims, 0 if z.dim() == 2 else None,
                0 if F.dim() == 3 else None)
        return self._replace(pulled, F.shape[-1], params=(self.params, z, F),
                             param_dims=dims)


# ---------------------------------------------------------------------------
# factory zoo (Constraints.scala)
# ---------------------------------------------------------------------------


def positivity(n: int, dtype=torch.float64, device=None) -> LinearBlock:
    """x_j >= 0 for all j, as -x <= 0 (Constraints.scala:26-69)."""
    z = torch.zeros((n,), dtype=dtype, device=device)
    return LinearBlock(G=-torch.eye(n, dtype=dtype, device=device), c=z,
                       ub=z.clone(), label="positivity")


def first_coordinates_positive(n: int, m: int, dtype=torch.float64,
                               device=None) -> LinearBlock:
    """x_0..x_{m-1} >= 0 in dimension n (Constraints.scala:42-49)."""
    G = torch.zeros((m, n), dtype=dtype, device=device)
    i = torch.arange(m, device=device)
    G[i, i] = -1.0
    z = torch.zeros((m,), dtype=dtype, device=device)
    return LinearBlock(G=G, c=z, ub=z.clone(),
                       label="first_coordinates_positive")


def rows_leq(H, u, label: str = "rows_leq") -> LinearBlock:
    """Coordinatewise H x <= u (ConstraintSet.scala:621-638); u may be
    per instance (B, m)."""
    return LinearBlock(G=H, c=torch.zeros(H.shape[:-1], dtype=H.dtype,
                                          device=H.device), ub=u, label=label)


def expectation_lt(w, r: float) -> LinearBlock:
    """E[W] < r for discrete W with values w: w.x <= r
    (Constraints.scala:109-153).  P[E] > r is expectation_lt(-1_E, -r)."""
    return LinearBlock(G=w[None, :], c=w.new_zeros((1,)),
                       ub=torch.tensor([r], dtype=w.dtype, device=w.device))


def abs_bounded(ub) -> LinearBlock:
    """|x_j| <= ub_j for each j: the 2n rows x_j <= ub_j, -x_j <= ub_j."""
    n = ub.shape[0]
    eye = torch.eye(n, dtype=ub.dtype, device=ub.device)
    return LinearBlock(G=torch.cat([eye, -eye], dim=0),
                       c=ub.new_zeros((2 * n,)), ub=torch.cat([ub, ub]))


def half_norm2_bounded(n: int, ub: float, dtype=torch.float64,
                       device=None) -> QuadBlock:
    """||x||^2 / 2 <= ub (Constraints.scala:299-309)."""
    return QuadBlock(P=torch.eye(n, dtype=dtype, device=device)[None],
                     a=torch.zeros((1, n), dtype=dtype, device=device),
                     r=torch.zeros((1,), dtype=dtype, device=device),
                     ub=torch.tensor([ub], dtype=dtype, device=device))


def abs_sum_bounded(n: int, p: int, q: int, ub: float, dtype=torch.float64,
                    device=None) -> LinearBlock:
    """|x_p| + ... + |x_{q-1}| <= ub via the 2^(q-p) sign-combination rows
    (Constraints.scala:252-296)."""
    G = torch.as_tensor(sign_combination_matrix_padded(n, p, q), dtype=dtype,
                        device=device)
    m = G.shape[0]
    return LinearBlock(G=G, c=torch.zeros((m,), dtype=dtype, device=device),
                       ub=torch.full((m,), ub, dtype=dtype, device=device))
