"""Kullback–Leibler distance minimization over discrete distributions.

Counterpart of ``cvx_tpu/models/dist_kl.py``:

    Q* = argmin_Q  d_KL(Q, P)   s.t.   H Q <= u,   A Q = r,

with d_KL(Q, P) = sum_j q_j (log q_j - log p_j), P uniform (the
reference's Dist_KL, cvx/Dist_KL.scala:218) or a general strictly positive
prior.  Both routes of the reference:

* PRIMAL: objective x.log(x/p), gradient 1 + log x - log p, diagonal
  Hessian 1/x (Dist_KL.scala:223-239); the rows of H and positivity as
  inequalities; [1'; A] x = [1; r] as equalities.  Routes: the generic
  barrier (``method="BR"``) and primal-dual (``"PD"``) methods, the whole
  solve in one kernel (``"fused"``, K3) and the structured barrier
  (``"BR_fast"``), from phase-I's strictly feasible point unless one is
  given, with the measured certificate ``kl_dual_gap`` on the last two.
* DUAL: -L*(z) = w.z + R.exp(-B'z), R = p/e, B = [H; 1'; A], w = (u, 1, r)
  (Dist_KL.scala:114-171, docs/maxent.pdf), the primal recovered as
  Q(z) = R exp(-B'z) / sum.  Routes: the barrier (``"dual"``,
  ``"dual_BR"``) or primal-dual (``"dual_PD"``) method on the dual, the
  whole dual solve in one kernel (``"dual_fused"``, K1), its fallback
  past dual dim 16 (``"dual_fast"``, ``solve_dual_newton``), the
  certified routes (``solve_certified``, ``solve_certified_batch``) and
  ``kl_certify``.

Every batched entry point takes per-instance bounds against the model's
shared rows, the written-out batch axis of the reference's
``vmap(lambda u_i: DistKL.create(n, H, u_i).solve...)``; phase-I is
``feasibility`` and, over a batch of bounds, ``feasibility_batch``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from .._spans import span
from ..duality import _polish_dual, _small_solve, solve_dual
from ..ops.kl_barrier import fused_final_t, fused_n_outer, kl_barrier_fused
from ..ops.kl_dual import (_FUSED_MAX_DIM, _cert_leaves, _certify_f64, _Ctx,
                           _polish_f64, _residuals, _solve_small,
                           _uniform_log_prior, kl_dual_fused,
                           kl_dual_fused_cert)
from ..ops.kl_gap import (_NegDualObjective, _prior_terms, kl_gap_fused,
                          kl_gap_fused_plain, route_of)
from ..problem.constraint_set import ConstraintSet
from ..problem.constraints import LinearBlock, positivity, rows_leq
from ..problem.equality import EqualityConstraint, sum_to_one
from ..solvers.barrier import barrier_solve
from ..solvers.phase1 import (FeasibilityReport, _phase1_linear_structured,
                              feasibility_analysis, find_feasible_point)
from ..solvers.primal_dual import primal_dual_solve
from ..solvers.structured import barrier_solve_structured
from ..solvers.types import Solution, SolverParams
from ..tree import exact_f32, instance

_DUAL = ("dual", "dual_BR", "dual_PD")


@dataclass
class KLObjective:
    """d_KL(x, p) = x . (log x - log p); grad 1 + log x - log p; hess
    diag(1/x) (Dist_KL.scala:223-239), at points (..., n).  ``log_prior``
    None is the reference's uniform prior p = 1/n."""

    n: int
    log_prior: torch.Tensor | None = None

    def _logp(self, x):
        if self.log_prior is None:
            return torch.tensor(-math.log(float(self.n)), dtype=x.dtype,
                                device=x.device)
        return self.log_prior.to(x.dtype)

    def value(self, x):
        return (x * (torch.log(x) - self._logp(x))).sum(dim=-1)

    def grad(self, x):
        return 1.0 + torch.log(x) - self._logp(x)

    def hess(self, x):
        return torch.diag_embed(1.0 / x)

    def hess_diag(self, x):
        return 1.0 / x

    def take(self, idx):
        """The objective of instances ``idx``: one shared prior."""
        return self


@span("cvx.cert.kl_dual_gap")
def kl_dual_gap(H, u, A, b, x, polish_steps: int = 8,
                value_band_eps: float | None = None, prior=None):
    """Measured duality-gap certificate of a batch of KL iterates x (B, n)
    (the reference's kl_dual_gap, models/dist_kl.py:128-186, per
    instance).

    ``H`` (k, n) shared inequality rows, ``u`` (B, k); ``A`` (p, n) the FULL
    equality system (sum-to-one row included), ``b`` (B, p).  For any
    lam >= 0 and any nu, g(z) = -(w.z + R.exp(-B'z)) (B = [H; A],
    w = (u, b)) is a lower bound on the optimum, so f(x) - g(z) is an
    honest certificate.  z starts from the least-squares fit of the
    stationarity condition log x - log p + 1 + B'z = 0 (lam >= 0) and is
    sharpened by ``polish_steps`` projected-Newton steps on -g.  Returns
    ``(gap (B,), z (B, k + p))``.

    ``ops.kl_gap.route_of`` picks the computation: a CUDA call the
    kernel does not take (dual dim k + p above 8, or neither f32 nor f64)
    runs the plain version's torch ops, counted in
    ``kl_dual_gap.chain_calls``; every other call ``kl_gap_fused`` (the
    kernel on CUDA, the plain version elsewhere) with the rows cast to
    x's dtype.
    """
    kw = dict(polish_steps=polish_steps, value_band_eps=value_band_eps)
    if route_of(x.device, x.dtype, H.shape[0] + A.shape[0]) == "chain":
        kl_dual_gap.chain_calls += 1
        return kl_gap_fused_plain(H, u, A, b, x, prior=prior, **kw)
    dtype = x.dtype
    H, A, x = (t.to(dtype).contiguous() for t in (H, A, x))
    u, b = u.to(dtype), b.to(dtype)
    prior = None if prior is None else prior.to(dtype)
    return kl_gap_fused(H, u, A, b, x, prior=prior, **kw)


kl_dual_gap.chain_calls = 0


def _dense_solve(m, gf, dim):
    """``_polish_f64``'s step by the reference's dense small solve, for a
    dual dim past the kernels' unrolled systems (the reference's warm
    polish solves every dim so); no sick flag."""
    M = torch.stack([torch.stack([m[min(i, j), max(i, j)]
                                  for j in range(dim)], dim=1)
                     for i in range(dim)], dim=1)
    dz = list(_small_solve(M, -torch.stack(gf, dim=1)).unbind(dim=1))
    return dz, torch.zeros_like(gf[0], dtype=torch.bool)


@dataclass
class KLCertificate:
    """F64-certified refinement of a batch of KL iterates."""

    x: torch.Tensor          # (B, n) refined primal
    gap: torch.Tensor        # (B,) MEASURED f(x) - g(z)
    ineq_res: torch.Tensor   # (B,) max(Hx - u, -x)_+
    eq_res: torch.Tensor     # (B,) max |Ax - b| over the full system
    lam: torch.Tensor        # (B, k) polished inequality duals
    nu: torch.Tensor         # (B, p) polished equality duals


@span("cvx.cert.kl_certify")
def kl_certify(H, u, A, b, x, *, z0=None, polish_steps=6, prior=None,
               compare_input=True):
    """F64 finishing pass for a batch of KL iterates (the reference's
    kl_certify, models/dist_kl.py:278-411).

    ``H`` (k, n) shared inequality rows, ``u`` (B, k); ``A`` (p, n) the FULL
    equality system (the sum-to-one row first), ``b`` (B, p); ``x`` (B, n)
    the iterates.  Two dual starts:

    * ``z0=None`` (cold): ``kl_dual_gap``'s least-squares fit at x and its
      line-searched polish, for an iterate of unknown quality (a primal
      route's x).  The input is always compared.
    * ``z0`` (B, k + p), a fused kernel's dual in the layout [lam, nu]: the
      active set is settled, so a lean warm Newton polish suffices.

    Recovers x_ref = R exp(-B'z) / sum and measures its gap and residuals
    from one exp pass.  ``compare_input=False`` (warm only) returns the
    refined point (the input only where the refinement is non-finite, then
    with gap = +inf); otherwise whichever of {refined, input} scores the
    smaller gap + violations is kept.
    """
    f64 = torch.float64
    H, u, A, b, x = (t.to(f64) for t in (H, u, A, b, x))
    B, n = x.shape
    k = H.shape[0]
    logp, _ = _prior_terms(prior, n, f64, x.device)
    # the polish and the certificate treat A's first row as the ones row
    # and b[:, 0] as 1, with the per-instance layout of the fused kernels
    ctx = _Ctx(H[None].expand(B, k, n), u, A[None, 1:].expand(B, -1, n),
               b[:, 1:], logp)
    gap_in = None
    if z0 is None:
        gap_in, zc = kl_dual_gap(H, u, A, b, x, polish_steps=polish_steps,
                                 prior=prior)
        z = list(zc.unbind(dim=1))
    else:
        solve = _dense_solve if ctx.dim > _FUSED_MAX_DIM else _solve_small
        z = _polish_f64(ctx, list(z0.to(f64).unbind(dim=1)), polish_steps,
                        guard_sick=False, solve=solve)
    # ONE exp pass serves the refined primal, both gap terms and the
    # residuals
    x_ref, gap_ref, viol_ref, eq_ref, dval = _certify_f64(ctx, z)
    score_ref = torch.clamp_min(gap_ref, 0.0) + viol_ref + eq_ref
    viol_in, eq_in = _residuals(ctx, x)
    if z0 is None or compare_input:
        if gap_in is None:
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


def _kl_solution(x, lam, nu, gap, ineq, steps, *, eq=None, tol=None,
                 leaves=None, norm_grad=None) -> Solution:
    """A KL route's batched Solution.  ``leaves``: the per-instance
    ``(stalled, nan, iters, maxed_out)`` as K2 (or its plain version) wrote
    them, taken as they are; without them ``_cert_leaves`` makes them, with
    iters = ``steps``.  The certified routes give the certificate's ``eq``
    (the eq_gap leaf, and it joins the stall test) and ``tol`` = (tol,
    tol_feas); the others report |sum x - 1| and stall at sqrt(eps) of x's
    dtype.  The NaN leaf stands for every field the route does not measure
    (``norm_grad`` unless given)."""
    if leaves is None:
        if tol is None:
            tol = (math.sqrt(torch.finfo(x.dtype).eps),) * 2
        leaves = _cert_leaves(x, gap, ineq, *tol, steps, eq=eq)
    stalled, nan, iters, maxed = leaves
    if eq is None:
        eq = torch.abs(torch.sum(x, dim=-1) - 1.0)
    return Solution(
        x=x, lam=lam, nu=nu, newton_decrement=nan, duality_gap=gap,
        eq_gap=eq, norm_grad=nan if norm_grad is None else norm_grad,
        norm_dual_residual=nan, iters=iters, maxed_out=maxed,
        stalled=stalled, ineq_res=ineq)


@span("cvx.route.cert_solution")
def _cert_solution(cert, pars, iters, leaves=None):
    """The certified routes' Solution from a certificate (``_kl_solution``
    at ``pars.tol`` / ``pars.tol_feas``); ``leaves`` as K2 wrote them.
    Counts the calls whose leaves K2 wrote on the card
    (``_cert_solution.leaves_fused``) and the others (``.leaves_torch``)."""
    if leaves is not None and cert.x.is_cuda:
        _cert_solution.leaves_fused += 1
    else:
        _cert_solution.leaves_torch += 1
    return _kl_solution(cert.x, cert.lam, cert.nu, cert.gap, cert.ineq_res,
                        iters, eq=cert.eq_res, tol=(pars.tol, pars.tol_feas),
                        leaves=leaves)


_cert_solution.leaves_fused = 0
_cert_solution.leaves_torch = 0


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
        reference under jax_enable_x64).  ``device`` defaults to the card
        (``"cuda"``), where the kernels run; the data is moved there, and
        without a CUDA device the call raises.  Pass ``device="cpu"`` for
        the plain PyTorch versions."""
        given = [v for v in (H, u, A, r) if v is not None]
        if dtype is None:
            dtype = _joint_float_dtype(given)
        device = torch.device("cuda" if device is None else device)
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

    def _opts(self):
        return dict(dtype=self.H.dtype, device=self.H.device)

    def _bounds(self, u, r=None):
        """Per-instance (u (B, k), r (B, mE)) on the model's device and
        dtype; r defaults to the model's."""
        u = torch.as_tensor(u).to(**self._opts())
        if r is None:
            r = self.r[None].expand(u.shape[0], self.A.shape[0])
        return u, torch.as_tensor(r).to(**self._opts())

    # ------------------------------------------------------------ primal side
    @property
    def objective(self) -> KLObjective:
        lp = None if self.prior is None else torch.log(self.prior)
        return KLObjective(n=self.n, log_prior=lp)

    @property
    def equalities(self) -> EqualityConstraint:
        """[1'; A] x = [1; r]: the probability constraint always first
        (Dist_KL.scala:193-209, 296-297)."""
        eq = sum_to_one(self.n, **self._opts())
        if self.A.shape[0] == 0:
            return eq
        return eq.stack(EqualityConstraint(A=self.A, b=self.r))

    @property
    def inequalities(self) -> ConstraintSet:
        """Rows of H plus positivity, on the whole space
        (Dist_KL.scala:293): the strictly feasible set already has x > 0,
        and phase-I stays free to relax positivity through its slack."""
        return self._inequalities(self.u)

    def _inequalities(self, u) -> ConstraintSet:
        """``inequalities`` with bounds ``u`` (k,) or per instance (B, k)."""
        blocks = []
        if self.H.shape[0] > 0:
            blocks.append(rows_leq(self.H, u))
        blocks.append(positivity(self.n, **self._opts()))
        return ConstraintSet(blocks=tuple(blocks))

    # -------------------------------------------------------------- dual side
    @property
    def num_ineq_dual(self) -> int:
        return self.H.shape[0]

    @property
    def dual_dim(self) -> int:
        """mI + 1 + mE (Dist_KL.scala:115-116)."""
        return self.H.shape[0] + 1 + self.A.shape[0]

    @cached_property
    def _log_prior64(self) -> torch.Tensor:
        """The f64 log prior (n,) K2 takes, made at the first certified
        call and kept on the model, so that a call makes none."""
        if self.prior is None:
            return _uniform_log_prior(self.n, torch.float64, self.H.device)
        return torch.log(self.prior.to(torch.float64))

    def _R(self, dtype=None) -> torch.Tensor:
        """Dual constant R = p/e (uniform: 1/(n e), Dist_KL.scala:131)."""
        return _prior_terms(self.prior, self.n, dtype or self.H.dtype,
                            self.H.device)[1]

    def neg_dual_objective(self, u=None, r=None) -> _NegDualObjective:
        """-L* of this problem, or of a batch with per-instance bounds
        ``u`` (B, k) (and ``r`` (B, mE)) against its shared rows."""
        ones = torch.ones((1, self.n), **self._opts())
        B = torch.cat([self.H, ones, self.A], dim=0)
        if u is None:
            w = torch.cat([self.u, ones[0, :1], self.r])
        else:
            u, r = self._bounds(u, r)
            w = torch.cat([u, ones[:, :1].expand(u.shape[0], 1), r], dim=1)
        return _NegDualObjective(B=B, w=w, R=self._R())

    def primal_optimum(self, z: torch.Tensor) -> torch.Tensor:
        """Q(z) = R exp(-B'z) (Dist_KL.scala:171), renormalized to sum 1."""
        q = self.neg_dual_objective()._y(z)
        return q / torch.sum(q, dim=-1, keepdim=True)

    def _ineq_res(self, x: torch.Tensor, u=None) -> torch.Tensor:
        """Measured max inequality violation max(Hx - u, -x)_+ of an
        iterate (B, n) or (n,); ``u`` defaults to the model's bounds."""
        viol = torch.clamp_min(torch.amax(-x, dim=-1), 0.0)
        if self.H.shape[0] > 0:
            viol = torch.maximum(viol, torch.amax(torch.clamp_min(
                x @ self.H.T - (self.u if u is None else u), 0.0), dim=-1))
        return viol

    # ---------------------------------------------------------- dual routes
    def _dual_newton_batch(self, u, pars, steps=30, r=None) -> Solution:
        """solve_dual_newton with per-instance bounds u (B, k) (and r
        (B, mE); default the model's)."""
        d = self.neg_dual_objective(u, r)
        k, B = self.num_ineq_dual, u.shape[0]
        z0 = torch.full((B, self.dual_dim), pars.dual_start, **self._opts())
        z = _polish_dual(d, z0, num_ineq=k, steps=steps)
        y = d._y(z)
        x = y / torch.sum(y, dim=-1, keepdim=True)
        # f(x) - g(z), measured
        gap = self.objective.value(x) + d.value(z)
        return _kl_solution(
            x, z[:, :k], z[:, k:], gap, self._ineq_res(x, u), steps,
            norm_grad=torch.linalg.vector_norm(d.grad(z), dim=-1))

    def solve_dual_newton(self, pars: SolverParams | None = None,
                          steps: int = 30) -> Solution:
        """Direct active-set projected-Newton solve of the closed-form dual
        (method="dual_fast"): ``steps`` steps of ``duality._polish_dual``
        from z = dual_start, then x = Q(z) and the measured gap f(x) -
        g(z).  The route past dual dim 16, where K1 does not reach."""
        pars = pars or SolverParams()
        return instance(self._dual_newton_batch(self.u[None], pars, steps),
                         0)

    def _dual_fused_batch(self, u, pars, steps=16, r=None) -> Solution:
        """K1 on per-instance bounds u (B, k) (and r (B, mE); default the
        model's); dual_fast past dim 16."""
        k, m_eq = self.H.shape[0], self.A.shape[0]
        if k + m_eq < 1 or k + 1 + m_eq > _FUSED_MAX_DIM:
            return self._dual_newton_batch(u, pars, r=r)
        B = u.shape[0]
        _, rb = self._bounds(u, r)
        lp = None if self.prior is None else torch.log(self.prior)
        x, gap, z = kl_dual_fused(
            self.H[None].expand(B, k, self.n), u,
            self.A[None].expand(B, m_eq, self.n) if m_eq > 0 else None,
            rb if m_eq > 0 else None,
            log_prior=lp, n_steps=steps, z0=float(pars.dual_start))
        return _kl_solution(x, z[:, :k], z[:, k:], gap, self._ineq_res(x, u),
                            steps)

    def solve_dual_fused(self, pars: SolverParams | None = None,
                         steps: int = 16) -> Solution:
        """Whole dual solve in one kernel (method="dual_fused", K1) for
        dual dim k + 1 + mE <= 16; larger shapes fall back to
        ``solve_dual_newton``, as in the reference."""
        pars = pars or SolverParams()
        return instance(self._dual_fused_batch(self.u[None], pars, steps),
                         0)

    def _certified_batch(self, u, pars, steps=16, polish_steps=2):
        """K1 (or dual_fast) then the f64 warm finish, per instance."""
        sol = self._dual_fused_batch(u, pars, steps)
        _, rb = self._bounds(u)
        cert = self._certify(u, rb, sol.x, torch.cat([sol.lam, sol.nu], 1),
                             polish_steps)
        return _cert_solution(cert, pars, steps + polish_steps)

    def solve_certified(self, pars: SolverParams | None = None,
                        steps: int = 16, polish_steps: int = 2) -> Solution:
        """K1 dual solve + f64 warm finishing pass (method=
        "dual_fused_cert"), certified to gap <= pars.tol with measured
        residuals <= pars.tol_feas."""
        pars = pars or SolverParams()
        return instance(self._certified_batch(self.u[None], pars, steps,
                                               polish_steps), 0)

    def _certify(self, u, r, xs, zs, polish_steps):
        b = torch.cat([u.new_ones((u.shape[0], 1)), r.to(u.dtype)], dim=1)
        return kl_certify(self.H, u, self.equalities.A, b, xs, z0=zs,
                          polish_steps=polish_steps, prior=self.prior,
                          compare_input=False)

    @span("cvx.entry.solve_certified_batch")
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
        f32, and the K1 + f64 route for f64 data.  Past dual dim 16 the
        K1 solve is replaced by ``solve_dual_newton``'s (at least 30
        steps, cold), as in the reference.  On CPU tensors both kernels
        run their plain versions.  Returns a batched Solution with
        measured f64 certificate leaves.
        """
        pars = pars or SolverParams()
        k, m_eq = self.H.shape[0], self.A.shape[0]
        dtype = self.H.dtype
        u, rb = self._bounds(u, r)
        B = u.shape[0]
        kernel_fits = k + m_eq >= 1 and k + 1 + m_eq <= _FUSED_MAX_DIM
        if fused_cert is None:
            fused_cert = kernel_fits and dtype == torch.float32
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
            x, z, gap, ineq, eq, *leaves = kl_dual_fused_cert(
                self.H[None].expand(B, k, self.n), u,
                self.A[None].expand(B, m_eq, self.n) if m_eq > 0 else None,
                rb if m_eq > 0 else None, log_prior=self._log_prior64,
                n_steps=steps, polish_steps=polish_steps,
                z0=float(pars.dual_start), tol=pars.tol,
                tol_feas=pars.tol_feas)
            cert = KLCertificate(x=x, gap=gap, ineq_res=ineq, eq_res=eq,
                                 lam=z[:, :k], nu=z[:, k:])
            return _cert_solution(cert, pars, steps + polish_steps, leaves)
        if kernel_fits:
            sol = self._dual_fused_batch(u, pars, steps, r=rb)
        else:
            # the fallback starts cold, so it gets at least its own tuned
            # schedule even when the caller passes the kernel-sized one
            steps = max(steps, 30)
            sol = self._dual_newton_batch(u, pars, steps, r=rb)
        cert = self._certify(u, rb, sol.x, torch.cat([sol.lam, sol.nu], 1),
                             polish_steps)
        return _cert_solution(cert, pars, steps + polish_steps)

    # -------------------------------------------------------- primal routes
    def _fused_batch(self, u, x0, pars) -> Solution:
        """K3 on per-instance bounds u (B, k) from x0 (B, n), then the
        measured certificate kl_dual_gap (pallas route, dist_kl.py:907-969
        of the reference)."""
        k, n, B = self.H.shape[0], self.n, u.shape[0]
        ones = torch.ones((1, 1, n), **self._opts())
        schedule = self._fused_schedule(pars)
        x = kl_barrier_fused(
            self.H[None].expand(B, k, n), u, ones.expand(B, 1, n),
            ones[0, :, :1].expand(B, 1), x0, mu=float(pars.mu),
            n_outer=schedule[0], n_inner=schedule[1])
        return self._fused_solution(u, x, schedule)

    def _fused_schedule(self, pars) -> tuple[int, int, float]:
        """K3's fixed schedule: (n_outer, n_inner, the final t)."""
        m, mu, tol = self.H.shape[0] + self.n, float(pars.mu), float(pars.tol)
        n_outer = fused_n_outer(m, mu=mu, tol=tol)
        # pars.max_iter (default 1000) caps the iterative solvers' inner
        # loops, not a step count here
        return (n_outer, min(int(pars.max_iter), 8),
                fused_final_t(m, mu=mu, tol=tol, n_outer=n_outer))

    @span("cvx.route.fused_solution")
    def _fused_solution(self, u, x, schedule) -> Solution:
        """The fused route's Solution for K3's x (B, n) on bounds u (B, k)
        after ``schedule`` (``_fused_schedule``): the measured gap, its
        duals and the stall rule."""
        k, n, B = self.H.shape[0], self.n, u.shape[0]
        n_outer, n_inner, t_final = schedule
        ones = torch.ones((1, 1, n), **self._opts())
        # the MEASURED gap at the returned iterate, not the central-path m/t
        gap, z = kl_dual_gap(self.H, u, ones[0], ones[0, :, :1].expand(B, 1),
                             x, prior=self.prior)
        # |gap| and the violation: an iterate the kernel could not move has
        # f(x0) < p*, a negative gap a one-sided test calls healthy
        return _kl_solution(
            x, torch.cat([z[:, :k], 1.0 / (t_final * x)], dim=1), z[:, k:],
            gap, self._ineq_res(x, u), n_outer * n_inner)

    @span("cvx.entry.solve_jittable_batch")
    def solve_jittable_batch(self, u, feasible_points,
                             method: str = "fused",
                             pars: SolverParams | None = None) -> Solution:
        """Batched solve with per-instance bounds ``u`` (B, k) against this
        problem's shared rows, from strictly feasible ``feasible_points``
        (B, n) (ignored by the dual methods): the written-out batch axis of
        the reference's ``vmap(lambda u_i, x0_i: DistKL.create(n, H, u_i)
        .solve_jittable(x0_i, method, pars))``.

        method: "BR" (the generic barrier), "PD" (primal-dual), "fused"
        (K3, then the measured gap; falls back to "BR_fast" for extra
        equality rows, a prior, or k not in {1, 2}), "BR_fast" (the
        structured barrier), "dual" / "dual_BR" / "dual_PD" (the barrier or
        primal-dual method on the dual), "dual_fast", "dual_fused" (K1) or
        "dual_fused_cert" (K1 + the f64 finish).  Returns a batched
        Solution.
        """
        pars = pars or SolverParams()
        u, _ = self._bounds(u)
        if method in _DUAL:
            return self._solve_dual_batch(u, method, pars)
        if method == "dual_fast":
            return self._dual_newton_batch(u, pars)
        if method == "dual_fused":
            return self._dual_fused_batch(u, pars)
        if method == "dual_fused_cert":
            return self._certified_batch(u, pars)
        if method not in ("BR", "PD", "fused", "BR_fast"):
            raise ValueError(f"unknown method: {method!r}")
        if feasible_points is None:
            raise ValueError(f"method={method!r} needs strictly feasible "
                             "points (B, n)")
        x0 = torch.as_tensor(feasible_points).to(**self._opts())
        eqs = self.equalities
        if method == "BR":
            return barrier_solve(self.objective, self._inequalities(u), x0,
                                 pars, eqs=eqs)
        if method == "PD":
            return primal_dual_solve(self.objective, self._inequalities(u),
                                     x0, pars, eqs=eqs)
        k = self.H.shape[0]
        if method == "fused":
            # K3's closed-form algebra covers 1 <= k <= 2 rows, the
            # sum-to-one equality and the uniform prior; any other shape
            # falls back to the structured path
            if (self.A.shape[0] == 0 and 1 <= k <= 2
                    and self.prior is None):
                return self._fused_batch(u, x0, pars)
        b = eqs.b[None].expand(u.shape[0], -1)
        return barrier_solve_structured(self.objective, self.H, u, eqs.A, b,
                                        x0, pars)

    def _solve_dual_batch(self, u, method, pars) -> Solution:
        """The barrier ("dual", "dual_BR") or primal-dual ("dual_PD")
        method on the dual of each instance, bounds u (B, k)."""
        return solve_dual(self.neg_dual_objective(u), self.num_ineq_dual,
                          self.dual_dim, self.primal_optimum,
                          method="PD" if method == "dual_PD" else "BR",
                          pars=pars, batch=u.shape[0], device=self.H.device)

    def solve_jittable(self, feasible_point, method: str = "BR",
                       pars: SolverParams | None = None) -> Solution:
        """Primal solve from a given strictly feasible point, or a dual
        route: ``solve_jittable_batch`` with one instance."""
        fp = None if feasible_point is None else \
            torch.as_tensor(feasible_point)[None]
        return instance(self.solve_jittable_batch(self.u[None], fp, method,
                                                   pars), 0)

    def solve(self, method: str = "dual",
              pars: SolverParams | None = None,
              feasible_point=None) -> Solution:
        """Solve the problem.

        method: "dual" (the barrier on the closed-form dual), "dual_BR",
        "dual_PD", "dual_fast", "dual_fused" (K1), "dual_fused_cert", "BR"
        (primal barrier), "PD" (primal primal-dual), "fused" (K3) or
        "BR_fast".  The primal routes run phase-I from the uniform point
        unless ``feasible_point`` is given (Dist_KL.scala:307), and raise
        ``InfeasibleProblemError`` when there is none.
        """
        pars = pars or SolverParams()
        if method == "dual_fast":
            return self.solve_dual_newton(pars)
        if method == "dual_fused":
            return self.solve_dual_fused(pars)
        if method == "dual_fused_cert":
            return self.solve_certified(pars)
        if method in _DUAL:
            return instance(self._solve_dual_batch(self.u[None], method,
                                                    pars), 0)
        if method not in ("BR", "PD", "fused", "BR_fast"):
            raise ValueError(f"unknown method: {method!r}")
        if feasible_point is None:
            x0 = torch.full((1, self.n), 1.0 / self.n, **self._opts())
            feasible_point = find_feasible_point(
                self.inequalities, x0, pars, self.equalities)[0]
        return self.solve_jittable(feasible_point, method=method, pars=pars)

    def feasibility(self, pars: SolverParams | None = None
                    ) -> FeasibilityReport:
        """Phase-I report for this problem's constraints, from the uniform
        point (the reference's dist_kl.py:983-988)."""
        pars = pars or SolverParams()
        x0 = torch.full((1, self.n), 1.0 / self.n, **self._opts())
        return instance(feasibility_analysis(self.inequalities, x0, pars,
                                              self.equalities), 0)

    def feasibility_batch(self, u, pars: SolverParams | None = None):
        """Fleet phase-I screen: per-instance bounds ``u`` (B, k) against
        this problem's shared rows.  Returns ``(s_max (B,),
        strictly_feasible (B,))``; ``s_max > 0`` certifies that no point
        satisfies instance i's constraints (ConstraintSet.scala:571-572).

        The shared equality system is eliminated ONCE (x = z0 + F v), the
        all-linear set pulls back to shared rows with only the bounds
        varying, and the exact low-rank phase-I runs over the batch of
        bounds (the reference's dist_kl.py:990-1036)."""
        rep = self._screen(u, pars or SolverParams())
        return rep.s_max, rep.strictly_feasible

    def feasibility_screen_batch(self, u, *, t0: float = 4.0,
                                 mu_t: float = 4.0, stages: int = 6,
                                 newton_steps: int = 4,
                                 polish_steps: int = 16,
                                 eq_tol: float = 1e-4) -> "FeasibilityScreen":
        """Fleet phase-I screen: the entropy-smoothed GAME dual, for
        per-instance bounds ``u`` (B, k) against this problem's rows
        (the reference's dist_kl.py:1038-1118).

        By LP duality on the simplex

            s* = min_{x in simplex} max_i (H_i x - u_i)
               = max_{w in simplex_k} [ min_j (w'H)_j - w'u ],

        and ANY primal/dual pair gives MEASURED certificates s_lower <= s*
        <= s_upper, so the screen needs no convergence proof to be sound.
        ``s_upper < 0``: strictly feasible (x is the point: strictly
        positive, sums to one, H x < u); ``s_lower > 0``: INFEASIBLE (w
        proves it); neither: ``undecided`` (|s*| below the smoothing floor
        ~ log(n)/t_final; escalate those instances to
        ``feasibility_batch``).  The schedule is fixed (``stages`` stages
        t <- mu_t t of ``newton_steps`` Newton steps and ``polish_steps``
        primal steps), so instances do not couple.

        Extra equality rows A x = r fold in as the +/- row pairs A x <= r
        + eq_tol, -A x <= -r + eq_tol (the reference's eqs-as-inequalities,
        ConstraintSet.scala:326-347): ``strictly_feasible`` then certifies
        a point meeting the equalities within eq_tol, ``infeasible`` the
        original problem.  s* is the game value over the CLOSED simplex,
        while ``feasibility_batch``'s s_max also slacks positivity: the
        signs agree, the magnitudes need not.
        """
        u, _ = self._bounds(u)
        H = self.H
        if self.A.shape[0] > 0:
            H = torch.cat([H, self.A, -self.A], dim=0)
            pad = torch.cat([self.r + eq_tol, -self.r + eq_tol])
            u = torch.cat([u, pad[None].expand(u.shape[0], -1)], dim=1)
        return kl_feasibility_screen(H, u, t0=t0, mu_t=mu_t, stages=stages,
                                     newton_steps=newton_steps,
                                     polish_steps=polish_steps)

    def _screen(self, u, pars) -> FeasibilityReport:
        """``feasibility_batch``'s phase-I report in the reduced variables
        v (x = z0 + F v), with its Newton step counts."""
        u, _ = self._bounds(u)
        B = u.shape[0]
        ss = self.equalities.solution_space()
        blocks = []
        if self.H.shape[0] > 0:
            blocks.append(LinearBlock(G=self.H @ ss.F, c=self.H @ ss.z0, ub=u,
                                      label="rows"))
        blocks.append(LinearBlock(G=-ss.F, c=-ss.z0,
                                  ub=torch.zeros((self.n,), **self._opts()),
                                  label="positivity"))
        v0 = torch.zeros((B, ss.F.shape[1]), **self._opts())
        return _phase1_linear_structured(ConstraintSet(blocks=tuple(blocks)),
                                         v0, pars)


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


@dataclass
class FeasibilityScreen:
    """Batched result of :meth:`DistKL.feasibility_screen_batch`.

    ``s_lower <= s* <= s_upper`` are MEASURED certificates of the game
    value s* = min_{x in simplex} max_i (H_i x - u_i); the flags are the
    per-instance decisions (``undecided``: the interval straddles 0)."""

    s_lower: torch.Tensor            # (B,)
    s_upper: torch.Tensor            # (B,)
    x: torch.Tensor                  # (B, n) strictly positive, sums to one
    w: torch.Tensor                  # (B, k) dual weights on the simplex
    strictly_feasible: torch.Tensor  # (B,) bool: s_upper < 0
    infeasible: torch.Tensor         # (B,) bool: s_lower > 0
    undecided: torch.Tensor          # (B,) bool


@exact_f32
def kl_feasibility_screen(H, u, *, t0: float = 4.0, mu_t: float = 4.0,
                          stages: int = 6, newton_steps: int = 4,
                          polish_steps: int = 16) -> FeasibilityScreen:
    """Entropy-smoothed game-dual feasibility screen (the reference's
    dist_kl.py:1135-1313): ``H`` (k, n) shared rows, ``u`` (B, k)
    per-instance bounds.  Every stage runs both halves over all B
    instances at once:

    * LOWER bound: damped Gauss-Newton ascent of the x-smoothed dual on
      softmax logits theta (any iterate maps to a valid w in the simplex,
      so every stage's bound is sound), the tiny systems through
      ``duality._small_solve``, and a fixed 5-candidate line search;
    * UPPER bound: ``polish_steps`` exponentiated-gradient steps in log
      space on the w-smoothed max violation (1/t) logsumexp(t(Hx - u)),
      from the better of the running best x and the dual recovery
      x(w) = softmax(-t w'H): where rows cancel along the optimal w (the
      anti-parallel +/- rows of an equality pair) x(w) degenerates to
      uniform, and only the primal descent finds the feasible band.

    Bounds are the running best across stages.  The contractions run at
    full f32 precision (``exact_f32``).
    """
    H = torch.as_tensor(H)
    dtype, dev = H.dtype, H.device
    k, n = H.shape
    u = torch.as_tensor(u).to(dtype=dtype, device=dev)
    logn = math.log(n)
    ts = [float(t0) * float(mu_t) ** j for j in range(stages)]
    eye = torch.eye(k, dtype=dtype, device=dev)
    eps = torch.finfo(dtype).eps
    tiny = float(torch.finfo(torch.float32).tiny)
    damp = 64.0 * eps
    # exponentiated-gradient step: |log-space update| <= eta * max|H|
    eta = 1.0 / (torch.amax(torch.abs(H)) + tiny)
    # the returned x seeds barrier solves, whose log(x) cannot take the
    # exact zeros softmax underflows to at high t: mix in a vanishing
    # uniform mass BEFORE measuring, so s_upper certifies the point
    # returned
    delta = 32.0 * eps

    def wa(theta):
        w = torch.softmax(theta, dim=-1)
        return w, w @ H

    def phi(theta, t):
        # smoothed dual at candidates (B, L, k):
        # -(1/t)(logsumexp(-t w'H) - log n) - w'u
        w, a = wa(theta)
        inner = -(torch.logsumexp(-t * a, dim=-1) - logn) / t
        return inner - (w * u[:, None, :]).sum(dim=-1)

    def lower(theta):
        # MEASURED (unsmoothed) dual certificate at the iterate
        w, a = wa(theta)
        return torch.amin(a, dim=-1) - (w * u).sum(dim=-1), w

    def viol(x):
        return x @ H.T - u

    def mix(x):
        return (1.0 - delta) * x + (delta / n)

    B = u.shape[0]
    theta = torch.zeros((B, k), dtype=dtype, device=dev)
    x = torch.full((B, n), 1.0 / n, dtype=dtype, device=dev)
    s_lb, w = lower(theta)
    s_ub = torch.amax(viol(x), dim=-1)
    rows = torch.arange(B, device=dev)
    for t in ts:
        for _ in range(newton_steps):
            # GAUSS-NEWTON metric: phi(softmax(theta)) is not concave in
            # theta, so the NSD w-space Hessian -t H (diag(x) - x x') H'
            # is pulled back through the softmax Jacobian J = diag(w) -
            # w w' (PSD as J Mw J).  wi is loop-local: w carries the
            # running-best certificate, and the returned w must reproduce
            # s_lower
            wi, a = wa(theta)
            x_t = torch.softmax(-t * a, dim=-1)
            hx = x_t @ H.T
            hv = hx - u                                   # grad_w phi
            g = wi * hv - wi * (wi * hv).sum(dim=-1, keepdim=True)
            Mw = t * ((H * x_t[:, None, :]) @ H.T
                      - hx[:, :, None] * hx[:, None, :])
            JM = wi[:, :, None] * Mw - wi[:, :, None] * (
                wi[:, None, :] @ Mw)
            Hm = (JM * wi[:, None, :]
                  - (JM @ wi[:, :, None]) * wi[:, None, :])
            Hm = 0.5 * (Hm + Hm.mT)                       # exact symmetry
            # the damping must dominate the f32 rounding of Hm's own
            # construction (~eps * max|Mw| ~ eps * t), not just its trace
            lam = damp * (torch.diagonal(Hm, dim1=1, dim2=2).sum(dim=-1) / k
                          + 1.0 + torch.amax(torch.abs(Hm), dim=(1, 2)))
            d = _small_solve(Hm + lam[:, None, None] * eye, g)
            # a residual non-finite direction falls back to the gradient
            d = torch.where(torch.all(torch.isfinite(d), dim=-1,
                                      keepdim=True), d, g)
            gn = g / (torch.sqrt((g * g).sum(dim=-1, keepdim=True)) + tiny)
            # cap the step in logit space: a saturated softmax flattens
            # Hm to ~0 and the damped solve emits an enormous d
            dn = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
            d = d * torch.clamp(10.0 / (dn + tiny), max=1.0)
            cands = torch.stack([theta + alpha * d
                                 for alpha in (1.0, 0.25, 0.0625)]
                                + [theta + gn, theta], dim=1)
            best = torch.argmax(phi(cands, t), dim=1)
            theta = cands[rows, best]
            # recenter (softmax-invariant) and clip: logits stay finite;
            # -60 still represents weight ~ 1e-26
            theta = torch.clamp(
                theta - torch.amax(theta, dim=-1, keepdim=True), -60.0, 0.0)
        lb, wt = lower(theta)
        w = torch.where((lb > s_lb)[:, None], wt, w)
        s_lb = torch.maximum(s_lb, lb)
        # primal polish in LOG space (x(w) underflows to exact 0 at high
        # t), from the better of the running best x and x(w)
        _, a = wa(theta)
        lw = torch.log_softmax(-t * a, dim=-1)
        xw = mix(torch.exp(lw))
        ub_w = torch.amax(viol(xw), dim=-1)
        take = (ub_w < s_ub)[:, None]
        lx = torch.where(take, lw, torch.log(torch.clamp_min(x, tiny)))
        x = torch.where(take, xw, x)
        s_ub = torch.minimum(s_ub, ub_w)
        for _ in range(polish_steps):
            sig = torch.softmax(t * viol(torch.exp(lx)), dim=-1)
            lx = torch.log_softmax(lx - eta * (sig @ H), dim=-1)
            xp = mix(torch.exp(lx))
            ub_p = torch.amax(viol(xp), dim=-1)
            x = torch.where((ub_p < s_ub)[:, None], xp, x)
            s_ub = torch.minimum(s_ub, ub_p)
    feas = s_ub < 0.0
    infeas = s_lb > 0.0
    return FeasibilityScreen(s_lower=s_lb, s_upper=s_ub, x=x, w=w,
                             strictly_feasible=feas, infeasible=infeas,
                             undecided=~(feas | infeas))
