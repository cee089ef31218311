"""Kullback–Leibler distance minimization over discrete distributions: the
dual side of ``cvx_tpu/models/dist_kl.py``.

    Q* = argmin_Q  d_KL(Q, P)   s.t.   H Q <= u,   A Q = r,

with d_KL(Q, P) = sum_j q_j (log q_j - log p_j), P uniform (the
reference's Dist_KL, cvx/Dist_KL.scala:218) or a general strictly positive
prior.  The dual (Dist_KL.scala:114-171, docs/maxent.pdf) is

    -L*(z) = w.z + R.exp(-B'z),    R = p/e,  B = [H; 1'; A],  w = (u, 1, r),

and the primal is recovered as Q(z) = R exp(-B'z) / sum.

This module ports the routes of the batched KL scenario solve: the whole
dual solve in one kernel (``solve(method="dual_fused")``), the certified
routes (``solve_certified``, ``solve_certified_batch``) and the warm
branch of ``kl_certify``.  The other routes of the reference raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kl_dual import (_FUSED_MAX_DIM, _certify_f64, _Ctx, _polish_f64,
                           _residuals, kl_dual_fused, kl_dual_fused_cert)
from ..solvers.types import Solution, SolverParams

_NOT_PORTED = {
    "dual_fast": "ROADMAP M4 (the XLA dual_fast route, solve_dual_newton)",
    "dual": "ROADMAP M7 (the generic core: duality.solve_dual)",
    "dual_BR": "ROADMAP M7 (the generic core: duality.solve_dual)",
    "dual_PD": "ROADMAP M7 (the generic core: duality.solve_dual)",
    "BR": "ROADMAP M7 (the generic core: barrier_solve)",
    "PD": "ROADMAP M7 (the generic core: primal_dual_solve)",
    "BR_fast": "ROADMAP M6 (the primal KL routes)",
    "fused": "ROADMAP M6 (the primal KL routes, kernel K3)",
}


def _prior_terms(prior, n, dtype, device=None):
    """(log p, R = p/e) for an optional shared prior (None = the
    reference's uniform).  The one place the conversion lives."""
    if prior is None:
        return (torch.tensor(-math.log(float(n)), dtype=dtype, device=device),
                torch.full((n,), 1.0 / (n * np.e), dtype=dtype,
                           device=device))
    p = prior.to(dtype)
    return torch.log(p), p / np.e


@dataclass
class _NegDualObjective:
    """-L*(z) = w.z + R.exp(-B'z) (convex) for one instance."""

    B: torch.Tensor   # (mI + 1 + mE, n)
    w: torch.Tensor   # (mI + 1 + mE,)
    R: torch.Tensor   # (n,)

    def _y(self, z):
        return self.R * torch.exp(-(z @ self.B))

    def value(self, z):
        return self.w @ z + torch.sum(self._y(z))

    def grad(self, z):
        return self.w - self.B @ self._y(z)

    def hess(self, z):
        return (self.B * self._y(z)) @ self.B.T


@dataclass
class KLCertificate:
    """F64-certified refinement of a batch of KL iterates."""

    x: torch.Tensor          # (B, n) refined primal
    gap: torch.Tensor        # (B,) MEASURED f(x) - g(z)
    ineq_res: torch.Tensor   # (B,) max(Hx - u, -x)_+
    eq_res: torch.Tensor     # (B,) max |Ax - b| over the full system
    lam: torch.Tensor        # (B, k) polished inequality duals
    nu: torch.Tensor         # (B, p) polished equality duals


def kl_certify(H, u, A, b, x, *, z0, polish_steps=6, prior=None,
               compare_input=True):
    """F64 finishing pass for a batch of KL iterates, warm branch (the
    reference's kl_certify with ``z0`` given, models/dist_kl.py:278-411).

    ``H`` (k, n) shared inequality rows, ``u`` (B, k); ``A`` (p, n) the FULL
    equality system (the sum-to-one row first), ``b`` (B, p); ``x`` (B, n)
    the iterates; ``z0`` (B, k + p) the f32 kernel's dual in the layout
    [lam, nu].  Polishes z, recovers x_ref = R exp(-B'z) / sum and measures
    its gap and residuals from one exp pass.  ``compare_input=False``
    returns the refined point (the input only where the refinement is
    non-finite, then with gap = +inf); ``True`` keeps whichever of
    {refined, input} scores the smaller gap + violations.  The cold branch
    (``z0=None``, kl_dual_gap) is ROADMAP M4.
    """
    if z0 is None:
        raise NotImplementedError(
            "kl_certify: the cold branch (z0=None, kl_dual_gap) is not "
            "ported yet, ROADMAP M4")
    f64 = torch.float64
    H, u, A, b, x = (t.to(f64) for t in (H, u, A, b, x))
    B, n = x.shape
    k = H.shape[0]
    logp, _ = _prior_terms(prior, n, f64, x.device)
    # the polish and the certificate treat A's first row as the ones row
    # and b[:, 0] as 1, with the per-instance layout of the fused kernels
    ctx = _Ctx(H[None].expand(B, k, n), u, A[None, 1:].expand(B, -1, n),
               b[:, 1:], logp)
    z = _polish_f64(ctx, list(z0.to(f64).unbind(dim=1)), polish_steps,
                    guard_sick=False)
    # ONE exp pass serves the refined primal, both gap terms and the
    # residuals
    x_ref, gap_ref, viol_ref, eq_ref, dval = _certify_f64(ctx, z)
    score_ref = torch.clamp_min(gap_ref, 0.0) + viol_ref + eq_ref
    viol_in, eq_in = _residuals(ctx, x)
    if compare_input:
        xs = torch.clamp_min(x, 1e-30)
        gap_in = (xs * (torch.log(xs) - logp)).sum(dim=1) + dval
        score_in = torch.clamp_min(gap_in, 0.0) + viol_in + eq_in
        # a non-finite input score must lose to any finite refinement
        better = torch.isfinite(score_ref) & (
            (score_ref <= score_in) | ~torch.isfinite(score_in))
    else:
        # the refined point with its measured gap, or the input with
        # gap = +inf where the refinement went non-finite (a dead lane)
        better = torch.isfinite(score_ref)
        gap_in = torch.full_like(gap_ref, math.inf)
    zt = torch.stack(z, dim=1)
    return KLCertificate(
        x=torch.where(better[:, None], x_ref, x),
        gap=torch.where(better, gap_ref, gap_in),
        ineq_res=torch.where(better, viol_ref, viol_in),
        eq_res=torch.where(better, eq_ref, eq_in),
        lam=zt[:, :k], nu=zt[:, k:])


def _stalled(x, gap, ineq, tol, tol_feas, eq=None):
    """stalled = not(|gap| <= tol and ineq <= tol_feas [and eq <=
    tol_feas]), or a non-finite x.  |gap|: an infeasible instance's dual
    drives the gap to -inf; the measured residuals join because a small
    gap alone cannot certify feasibility; the not-<= form flags NaN."""
    ok = (torch.abs(gap) <= tol) & (ineq <= tol_feas)
    if eq is not None:
        ok = ok & (eq <= tol_feas)
    return ~torch.all(torch.isfinite(x), dim=-1) | ~ok


@dataclass
class DistKL:
    """The KL-minimization problem (canonical form: empty blocks allowed).
    Use ``DistKL.create(n, H=..., u=..., A=..., r=...)``."""

    H: torch.Tensor   # (mI, n) inequality rows, mI may be 0
    u: torch.Tensor   # (mI,)
    A: torch.Tensor   # (mE, n) extra equalities, mE may be 0
    r: torch.Tensor   # (mE,)
    n: int
    prior: torch.Tensor | None = None   # (n,) prior p; None = uniform

    @classmethod
    def create(cls, n: int, H=None, u=None, A=None, r=None, dtype=None,
               prior=None, device=None) -> "DistKL":
        """``prior`` (optional): a strictly positive (n,) weight vector
        (normalized here).  ``dtype`` defaults to the joint floating dtype
        of the tensors and arrays given (f64 when none carries one, as the
        reference under jax_enable_x64); ``device`` to the first tensor's
        device, else the CPU."""
        given = [v for v in (H, u, A, r) if v is not None]
        if dtype is None:
            dtype = _joint_float_dtype(given)
        if device is None:
            device = next((v.device for v in given
                           if isinstance(v, torch.Tensor)),
                          torch.device("cpu"))
        if (H is None) != (u is None) or (A is None) != (r is None):
            raise ValueError("H,u (and A,r) must be given together")
        opts = dict(dtype=dtype, device=device)
        if H is None:
            H, u = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        if A is None:
            A, r = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        H, u, A, r = (torch.as_tensor(v).to(**opts) for v in (H, u, A, r))
        if H.shape[0] == 0 and A.shape[0] == 0:
            raise ValueError("need at least one constraint (H,u or A,r)")
        if H.shape[1] != n or A.shape[1] != n:
            raise ValueError("H and A must have n columns")
        if prior is not None:
            prior = torch.as_tensor(prior).to(**opts)
            if tuple(prior.shape) != (n,):
                raise ValueError(f"prior must have shape ({n},), got "
                                 f"{tuple(prior.shape)}")
            if not bool(torch.all(prior > 0)):
                raise ValueError("prior must be strictly positive")
            prior = prior / torch.sum(prior)
        return cls(H=H, u=u, A=A, r=r, n=n, prior=prior)

    # -------------------------------------------------------------- dual side
    @property
    def num_ineq_dual(self) -> int:
        return self.H.shape[0]

    @property
    def dual_dim(self) -> int:
        """mI + 1 + mE (Dist_KL.scala:115-116)."""
        return self.H.shape[0] + 1 + self.A.shape[0]

    def _R(self, dtype=None) -> torch.Tensor:
        """Dual constant R = p/e (uniform: 1/(n e), Dist_KL.scala:131)."""
        return _prior_terms(self.prior, self.n, dtype or self.H.dtype,
                            self.H.device)[1]

    def neg_dual_objective(self) -> _NegDualObjective:
        ones = torch.ones((1, self.n), dtype=self.H.dtype,
                          device=self.H.device)
        B = torch.cat([self.H, ones, self.A], dim=0)
        w = torch.cat([self.u, ones[0, :1], self.r])
        return _NegDualObjective(B=B, w=w, R=self._R())

    def primal_optimum(self, z: torch.Tensor) -> torch.Tensor:
        """Q(z) = R exp(-B'z) (Dist_KL.scala:171), renormalized to sum 1."""
        q = self.neg_dual_objective()._y(z)
        return q / torch.sum(q)

    def _ineq_res(self, x: torch.Tensor) -> torch.Tensor:
        """Measured max inequality violation max(Hx - u, -x)_+ of an
        iterate (B, n) or (n,)."""
        viol = torch.clamp_min(torch.amax(-x, dim=-1), 0.0)
        if self.H.shape[0] > 0:
            viol = torch.maximum(viol, torch.amax(
                torch.clamp_min(x @ self.H.T - self.u, 0.0), dim=-1))
        return viol

    def _check_fused_dim(self):
        if self.dual_dim > _FUSED_MAX_DIM:
            raise NotImplementedError(
                f"dual dim {self.dual_dim} > {_FUSED_MAX_DIM}: the fallback "
                "to the dual_fast route is not ported yet, ROADMAP M4")

    # ----------------------------------------------------------------- solve
    def solve_dual_fused(self, pars: SolverParams | None = None,
                         steps: int = 16) -> Solution:
        """Whole dual solve in one kernel (method="dual_fused", K1) for
        dual dim k + 1 + mE <= 16."""
        pars = pars or SolverParams()
        self._check_fused_dim()
        k, m_eq = self.H.shape[0], self.A.shape[0]
        lp = None if self.prior is None else torch.log(self.prior)
        x, gap, z = kl_dual_fused(
            self.H[None], self.u[None],
            self.A[None] if m_eq > 0 else None,
            self.r[None] if m_eq > 0 else None,
            log_prior=lp, n_steps=steps, z0=float(pars.dual_start))
        x, gap, z = x[0], gap[0], z[0]
        dev = x.device
        nan = torch.full((), math.nan, dtype=x.dtype, device=dev)
        tol = math.sqrt(torch.finfo(x.dtype).eps)
        ineq = self._ineq_res(x)
        return Solution(
            x=x, lam=z[:k], nu=z[k:], newton_decrement=nan,
            duality_gap=gap, eq_gap=torch.abs(torch.sum(x) - 1.0),
            norm_grad=nan, norm_dual_residual=nan,
            iters=torch.tensor(steps, device=dev),
            maxed_out=torch.tensor(False, device=dev),
            stalled=_stalled(x, gap, ineq, tol, tol), ineq_res=ineq)

    def solve_certified(self, pars: SolverParams | None = None,
                        steps: int = 16, polish_steps: int = 2) -> Solution:
        """K1 dual solve + f64 warm finishing pass (method=
        "dual_fused_cert"), certified to gap <= pars.tol with measured
        residuals <= pars.tol_feas."""
        pars = pars or SolverParams()
        sol = self.solve_dual_fused(pars, steps=steps)
        cert = self._certify(self.u[None], self.r[None], sol.x[None],
                             torch.cat([sol.lam, sol.nu])[None], polish_steps)
        return self._cert_solution(cert, pars, steps + polish_steps, batch=0)

    def _certify(self, u, r, xs, zs, polish_steps):
        ones = torch.ones((1, self.n), dtype=self.H.dtype,
                          device=self.H.device)
        eq_A = torch.cat([ones, self.A], dim=0)
        b = torch.cat([u.new_ones((u.shape[0], 1)), r.to(u.dtype)], dim=1)
        return kl_certify(self.H, u, eq_A, b, xs, z0=zs,
                          polish_steps=polish_steps, prior=self.prior,
                          compare_input=False)

    def _cert_solution(self, cert, pars, iters, batch=None):
        """Solution from batched certificate leaves; ``batch=0`` returns
        the single instance."""
        x, gap, ineq, eq = cert.x, cert.gap, cert.ineq_res, cert.eq_res
        lam, nu = cert.lam, cert.nu
        if batch is not None:
            x, gap, ineq, eq, lam, nu = (t[batch] for t in
                                         (x, gap, ineq, eq, lam, nu))
        shape, dev = gap.shape, x.device
        nan = torch.full(shape, math.nan, dtype=torch.float64, device=dev)
        return Solution(
            x=x, lam=lam, nu=nu, newton_decrement=nan, duality_gap=gap,
            eq_gap=eq, norm_grad=nan, norm_dual_residual=nan,
            iters=torch.full(shape, iters, device=dev),
            maxed_out=torch.zeros(shape, dtype=torch.bool, device=dev),
            stalled=_stalled(x, gap, ineq, pars.tol, pars.tol_feas, eq=eq),
            ineq_res=ineq)

    def solve_certified_batch(self, u, r=None,
                              pars: SolverParams | None = None,
                              steps: int = 16, polish_steps: int = 2,
                              fused_cert: bool | None = None) -> Solution:
        """Batched certified solve: per-instance bounds ``u`` (B, k) (and
        optionally ``r`` (B, mE)) against this problem's SHARED rows.

        ``fused_cert=True`` runs K2 (f32 solve, f64 polish and certificate
        in one kernel; f32 problem data only).  ``fused_cert=False`` runs
        K1 and then the f64 ``kl_certify`` warm pass.  ``None`` (auto)
        takes K2 wherever the dual dim fits the kernels and the data is
        f32, and the K1 + f64 route for f64 data.  On CPU tensors both
        kernels run their plain versions.  Returns a batched Solution with
        measured f64 certificate leaves.
        """
        pars = pars or SolverParams()
        k, m_eq = self.H.shape[0], self.A.shape[0]
        dtype = self.H.dtype
        u = torch.as_tensor(u).to(dtype=dtype, device=self.H.device)
        B = u.shape[0]
        Hb = self.H[None].expand(B, k, self.n)
        if m_eq > 0:
            Ab = self.A[None].expand(B, m_eq, self.n)
            rb = (self.r[None].expand(B, m_eq) if r is None else
                  torch.as_tensor(r).to(dtype=dtype, device=self.H.device))
        else:
            Ab = rb = None
        kernel_fits = k + m_eq >= 1 and k + 1 + m_eq <= _FUSED_MAX_DIM
        if fused_cert is None:
            fused_cert = kernel_fits and dtype == torch.float32
        iters = steps + polish_steps
        if fused_cert:
            if not kernel_fits:
                raise ValueError(
                    f"fused_cert needs 1 <= k + m_eq and k + 1 + m_eq <= "
                    f"{_FUSED_MAX_DIM}, got k={k}, m_eq={m_eq}")
            if dtype != torch.float32:
                # the kernel would certify a ROUNDED problem
                raise ValueError(
                    "fused_cert=True requires f32 problem data (the kernel "
                    f"takes f32; got {dtype}) — use fused_cert=False for "
                    "the f64 finishing pass on f64 models")
            lp = (None if self.prior is None
                  else torch.log(self.prior.to(torch.float64)))
            x, z, gap, ineq, eq = kl_dual_fused_cert(
                Hb, u, Ab, rb, log_prior=lp, n_steps=steps,
                polish_steps=polish_steps, z0=float(pars.dual_start))
            cert = KLCertificate(x=x, gap=gap, ineq_res=ineq, eq_res=eq,
                                 lam=z[:, :k], nu=z[:, k:])
            return self._cert_solution(cert, pars, iters)
        self._check_fused_dim()
        lp = None if self.prior is None else torch.log(self.prior)
        xs, _, zs = kl_dual_fused(Hb, u, Ab, rb, log_prior=lp,
                                  n_steps=steps, z0=float(pars.dual_start))
        rb_ = rb if m_eq > 0 else u.new_zeros((B, 0))
        cert = self._certify(u, rb_, xs, zs, polish_steps)
        return self._cert_solution(cert, pars, iters)

    def solve(self, method: str = "dual",
              pars: SolverParams | None = None) -> Solution:
        """Solve the problem.  Ported: "dual_fused" (whole dual solve in
        one kernel) and "dual_fused_cert" (+ the f64 finishing pass,
        certified to gap < 1e-8).  The reference's other methods,
        including its default "dual", raise NotImplementedError naming
        their ROADMAP item."""
        pars = pars or SolverParams()
        if method == "dual_fused":
            return self.solve_dual_fused(pars)
        if method == "dual_fused_cert":
            return self.solve_certified(pars)
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"method={method!r} is not ported yet: {_NOT_PORTED[method]}")
        raise ValueError(f"unknown method: {method!r}")


def _joint_float_dtype(values):
    dtypes = []
    for v in values:
        if isinstance(v, torch.Tensor) and v.dtype.is_floating_point:
            dtypes.append(v.dtype)
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            dtypes.append(torch.from_numpy(np.zeros(0, v.dtype)).dtype)
    if not dtypes:
        return torch.float64
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out
