"""Convex duality: solve the primal through its dual, batched over a
leading instance axis.

Counterpart of ``cvx_tpu/duality.py`` (cvx/Duality.scala:38-135): the
small dense solves ``_small_solve`` (:30-106), the projected-Newton polish
of a dual optimum ``_polish_dual`` (:109-224) and ``solve_dual``
(:228-300), the barrier (or primal-dual) method on

    min -L*(z)   subject to   lambda = z[:num_ineq] >= 0

from z0 = dual_start * 1, polished, then mapped back to the primal by the
problem's x* = primal_optimum(z*).  Where the reference runs one instance
and is vmapped, these take every per-instance quantity with a leading
batch axis B.

These are not the fused kernels' ``_solve_small`` (``ops/kl_dual.py``):
the floors differ (a ``tiny`` floor on the pivots here, a ``sick`` flag
there), as they do in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ._spans import span
from .ops.cholesky import _chol_nan

def _small_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a batch of tiny symmetric positive-definite systems A x = b,
    A (B, d, d), b (B, d): the adjugate for d <= 3, an unrolled Cholesky
    with a ``tiny`` pivot floor for d 4-8, and a Cholesky of A + tiny I
    beyond (the reference's branches)."""
    dim = A.shape[-1]
    a = {(i, j): A[:, i, j] for i in range(dim) for j in range(dim)}
    bs = [b[:, i] for i in range(dim)]
    if dim == 1:
        return (bs[0] / a[(0, 0)])[:, None]
    if dim == 2:
        det = a[(0, 0)] * a[(1, 1)] - a[(0, 1)] * a[(1, 0)]
        return torch.stack([
            (a[(1, 1)] * bs[0] - a[(0, 1)] * bs[1]) / det,
            (a[(0, 0)] * bs[1] - a[(1, 0)] * bs[0]) / det,
        ], dim=1)
    if dim == 3:
        c00 = a[(1, 1)] * a[(2, 2)] - a[(1, 2)] * a[(2, 1)]
        c01 = a[(1, 2)] * a[(2, 0)] - a[(1, 0)] * a[(2, 2)]
        c02 = a[(1, 0)] * a[(2, 1)] - a[(1, 1)] * a[(2, 0)]
        det = a[(0, 0)] * c00 + a[(0, 1)] * c01 + a[(0, 2)] * c02
        c10 = a[(0, 2)] * a[(2, 1)] - a[(0, 1)] * a[(2, 2)]
        c11 = a[(0, 0)] * a[(2, 2)] - a[(0, 2)] * a[(2, 0)]
        c12 = a[(0, 1)] * a[(2, 0)] - a[(0, 0)] * a[(2, 1)]
        c20 = a[(0, 1)] * a[(1, 2)] - a[(0, 2)] * a[(1, 1)]
        c21 = a[(0, 2)] * a[(1, 0)] - a[(0, 0)] * a[(1, 2)]
        c22 = a[(0, 0)] * a[(1, 1)] - a[(0, 1)] * a[(1, 0)]
        return torch.stack([
            (c00 * bs[0] + c10 * bs[1] + c20 * bs[2]) / det,
            (c01 * bs[0] + c11 * bs[1] + c21 * bs[2]) / det,
            (c02 * bs[0] + c12 * bs[1] + c22 * bs[2]) / det,
        ], dim=1)
    # the reference floors at f32's tiny whatever the dtype
    tiny = float(torch.finfo(torch.float32).tiny)
    if dim <= 8:
        L = {}
        for j in range(dim):
            d = a[(j, j)]
            for p in range(j):
                d = d - L[(j, p)] * L[(j, p)]
            L[(j, j)] = torch.sqrt(torch.clamp_min(d, tiny))
            for i in range(j + 1, dim):
                off = a[(i, j)]
                for p in range(j):
                    off = off - L[(i, p)] * L[(j, p)]
                L[(i, j)] = off / L[(j, j)]
        yv = []
        for i in range(dim):
            s = bs[i]
            for p in range(i):
                s = s - L[(i, p)] * yv[p]
            yv.append(s / L[(i, i)])
        x = [None] * dim
        for i in range(dim - 1, -1, -1):
            s = yv[i]
            for p in range(i + 1, dim):
                s = s - L[(p, i)] * x[p]
            x[i] = s / L[(i, i)]
        return torch.stack(x, dim=1)
    eye = torch.eye(dim, dtype=A.dtype, device=A.device)
    Lc = _chol_nan(A + tiny * eye)
    y = torch.linalg.solve_triangular(Lc, b[..., None], upper=False)
    return torch.linalg.solve_triangular(Lc.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _value_band(eps: float, value_band_eps: float | None) -> float:
    """The polish's noise band of the value, relative to 1 + |f|: 32 eps,
    or ``value_band_eps`` where that is wider."""
    return (32.0 * eps if value_band_eps is None
            else max(32.0 * eps, float(value_band_eps)))


@span("cvx.cert.polish_dual")
def _polish_dual(obj, z: torch.Tensor, num_ineq: int, steps: int,
                 value_band_eps: float | None = None) -> torch.Tensor:
    """Active-set projected-Newton polish of a batch of dual points z
    (B, dim), lam = z[:, :num_ineq] >= 0, on ``obj``: value, grad and hess
    of -L* at points (B, ..., dim) of each instance.

    Per step: a lam within rounding of 0 is snapped to 0; multipliers at
    the bound with an inward gradient are frozen out of the Newton system;
    the free step is tried at 1, 1/2, ..., 1/128 and at the exact step to
    the first lam boundary; the best strict value decrease wins, else (the
    value's rounding floor) a projected-gradient-norm decrease within the
    value's noise band; boundary landings snap to 0.  The reference's
    steps, per instance."""
    dtype, dev = z.dtype, z.device
    dim = z.shape[1]
    mask = torch.arange(dim, device=dev) < num_ineq
    ts = 0.5 ** torch.arange(8, device=dev).to(dtype)
    eps = torch.finfo(dtype).eps
    band_eps = _value_band(eps, value_band_eps)
    eye = torch.eye(dim, dtype=dtype, device=dev)

    def project(z_):
        return torch.where(mask, torch.clamp_min(z_, 0.0), z_)

    def proj_grad_norm(zt, gt):
        at_b = mask & (zt <= 0.0) & (gt > 0.0)
        return torch.linalg.vector_norm(torch.where(at_b, 0.0, gt), dim=-1)

    for _ in range(steps):
        zmax = torch.abs(z).amax(dim=1, keepdim=True)
        z = torch.where(mask & (z <= 64.0 * eps * (1.0 + zmax)), 0.0, z)
        f0 = obj.value(z)
        g = obj.grad(z)
        H = obj.hess(z)
        free = ~(mask & (z <= 0.0) & (g > 0.0))
        freef = free.to(dtype)
        gf = torch.where(free, g, 0.0)
        Hf = (H * (freef[:, :, None] * freef[:, None, :])
              + torch.diag_embed(1.0 - freef))
        ridge = 10.0 * eps * torch.abs(torch.diagonal(Hf, dim1=1,
                                                      dim2=2)).mean(dim=1)
        Hf = Hf + ridge[:, None, None] * eye
        d = -_small_solve(Hf, gf)
        # exact step to the first lam boundary crossed
        neg = mask & (d < 0)
        t_bd = torch.where(neg, -z / torch.where(neg, d, -1.0),
                           math.inf).amin(dim=1)
        cand = torch.cat([ts.expand(z.shape[0], -1),
                          torch.clamp(t_bd, 0.0, 1.0)[:, None]], dim=1)
        zt = project(z[:, None, :] + cand[:, :, None] * d[:, None, :])
        ft = obj.value(zt)                       # (B, 9)
        gnt = proj_grad_norm(zt, obj.grad(zt))
        bad = ~torch.isfinite(ft)
        fs = torch.where(bad, math.inf, ft)
        gns = torch.where(bad, math.inf, gnt)
        dir_ok = torch.all(torch.isfinite(d), dim=1)
        bf = torch.argmin(fs, dim=1, keepdim=True)
        f_ok = (fs.gather(1, bf)[:, 0] < f0) & dir_ok
        gn0 = torch.linalg.vector_norm(gf, dim=-1)
        bg = torch.argmin(gns, dim=1, keepdim=True)
        noise = band_eps * (1.0 + torch.abs(f0))
        g_ok = ((gns.gather(1, bg)[:, 0] < 0.9 * gn0)
                & (fs.gather(1, bg)[:, 0] <= f0 + noise) & dir_ok)
        t_take = torch.where(f_ok, cand.gather(1, bf)[:, 0],
                             cand.gather(1, bg)[:, 0])
        take = f_ok | g_ok
        z_out = torch.where(take[:, None], project(z + t_take[:, None] * d),
                            z)
        # snap boundary landings (O(eps z) residue) to the bound
        snap = 8.0 * eps * torch.abs(z)
        z = torch.where(mask & (z_out <= snap), 0.0, z_out)
    return z


def _data_dtype(obj):
    """The joint floating dtype of an objective's tensor fields (f32 data
    keeps the f32 path; the reference's duality.py:246-251)."""
    dtype = None
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
            dtype = v.dtype if dtype is None else torch.promote_types(
                dtype, v.dtype)
    return dtype or torch.get_default_dtype()


def solve_dual(neg_dual_objective, num_ineq: int, dual_dim: int,
               primal_optimum, *, method: str = "BR", pars=None,
               polish_steps: int = 3, batch: int = 1, device=None):
    """Solve min -L*(z) s.t. z[:, :num_ineq] >= 0 for ``batch`` instances
    and map back to the primal.

    ``neg_dual_objective`` exposes value/grad/hess of -L* (convex) at
    points (B, dual_dim).  Returns a batched Solution whose ``x`` is the
    PRIMAL optimum and whose ``lam``/``nu`` split the dual optimum as in
    Duality.scala:128-132; ``duality_gap`` keeps the dual barrier's m/t
    bound (the polish only improves z) and ``norm_grad`` is refreshed at
    the polished point, with multipliers at the bound excluded.
    """
    from .problem.constraint_set import ConstraintSet
    from .problem.constraints import first_coordinates_positive
    from .solvers.barrier import barrier_solve
    from .solvers.newton import newton_minimize
    from .solvers.primal_dual import primal_dual_solve
    from .solvers.types import Solution, SolverParams

    pars = pars or SolverParams()
    dtype = _data_dtype(neg_dual_objective)
    z0 = torch.full((batch, dual_dim), pars.dual_start, dtype=dtype,
                    device=device)
    if num_ineq > 0:
        cnts = ConstraintSet(blocks=(first_coordinates_positive(
            dual_dim, num_ineq, dtype=dtype, device=device),))
        if method == "BR":
            sol = barrier_solve(neg_dual_objective, cnts, z0, pars)
        elif method == "PD":
            sol = primal_dual_solve(neg_dual_objective, cnts, z0, pars)
        else:
            raise ValueError(f"unknown solver method: {method!r}")
    else:
        # no inequality duals: the unconstrained dual
        def fgh(z):
            return (neg_dual_objective.value(z), neg_dual_objective.grad(z),
                    neg_dual_objective.hess(z))

        def in_set(z):
            return torch.ones(z.shape[:-1], dtype=torch.bool, device=z.device)

        res = newton_minimize(fgh, in_set, z0, pars,
                              value_fn=neg_dual_objective.value)
        nan = torch.full((batch,), math.nan, dtype=dtype, device=device)
        empty = torch.zeros((batch, 0), dtype=dtype, device=device)
        sol = Solution(x=res.x, lam=empty, nu=empty, newton_decrement=nan,
                       duality_gap=nan, eq_gap=nan, norm_grad=res.norm_grad,
                       norm_dual_residual=nan, iters=res.iters,
                       maxed_out=res.maxed_out, stalled=res.stalled)
    z = sol.x
    if polish_steps > 0:
        z = _polish_dual(neg_dual_objective, z, num_ineq, polish_steps)
    g_pol = neg_dual_objective.grad(z)
    at_b = ((torch.arange(dual_dim, device=z.device) < num_ineq)
            & (z <= 0.0) & (g_pol > 0.0))
    return dataclasses.replace(
        sol, x=primal_optimum(z), lam=z[:, :num_ineq], nu=z[:, num_ineq:],
        norm_grad=torch.linalg.vector_norm(torch.where(at_b, 0.0, g_pol),
                                           dim=-1))
