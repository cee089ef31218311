"""Quadratic programming model family, batched.

Counterpart of ``cvx_tpu/models/qp.py`` (the reference's ad hoc QPs,
SimpleOptimizationProblems.scala:221-300, :389-414, as a model):

    min  a.x + x' P x / 2    s.t.   G x <= h,   A x = b

with automatic phase-I, both interior-point solvers and a certified f64
finish (``qp_certify``); ``DiagQP`` is the structured family (diagonal P,
x > 0, a few dense rows) on the Woodbury barrier, and ``LP`` its c = 0
member.

The reference vmaps over instances; here a model is a batch.  The
matrices P, G, A (DiagQP: c, U, A) are shared by every instance, and the
vectors a, h, b (DiagQP: a, ub, b) are shared ((n,), (m,), ...) or given
per instance with a leading batch axis ((B, n), (B, m), ...), as
``bench_scaling.qp_fleet`` vmaps them.  Points are (B, n), or (n,) for
all instances; a model with no per-instance leaf solved from an (n,)
point returns one instance's record.  Shared leaves are factored once:
P's Cholesky and M = B P^-1 B' of the certificate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.cholesky import chol_solve_factored, regularized_cholesky
from ..problem.constraint_set import ConstraintSet, _cat_last
from ..problem.constraints import positivity, rows_leq
from ..problem.equality import EqualityConstraint
from ..problem.objective import QuadraticObjective
from ..solvers.barrier import barrier_solve
from ..solvers.phase1 import find_feasible_point
from ..solvers.primal_dual import primal_dual_solve
from ..solvers.structured import barrier_solve_structured
from ..solvers.types import Solution, SolverParams
from ..ops._batch import lead
from ..tree import instance, static_field
from .dist_kl import _joint_float_dtype


def _leaves(values, dtype, device):
    """The given values as tensors of one floating dtype (default: their
    joint one) on ``device`` (default: the card)."""
    given = [v for v in values if v is not None]
    dtype = dtype or _joint_float_dtype(given)
    device = torch.device("cuda" if device is None else device)
    return [None if v is None else torch.as_tensor(v).to(dtype=dtype,
                                                          device=device)
            for v in values], dict(dtype=dtype, device=device)


def _batch(*vectors):
    """The batch size of the per-instance vectors (None: all shared)."""
    return next((v.shape[0] for v in vectors if v.dim() == 2), None)


def _points(x, B, n, like):
    """Points (B, n) from (B, n) or (n,), in the model's dtype at least."""
    x = torch.as_tensor(x).to(device=like.device)
    x = x.to(torch.promote_types(x.dtype, like.dtype))
    if x.dim() == 1:
        x = x.expand(B or 1, n).clone()
    return x


def _one(sol, single):
    """Instance 0 of a batched record where the caller asked for one."""
    return instance(sol) if single else sol


def _certified_solution(cert, sol, pars) -> Solution:
    """Package a QPCertificate as a Solution (shared by QP/DiagQP
    solve_certified so the stall rule and field mapping live once)."""
    nan = torch.full(cert.gap.shape, math.nan, dtype=torch.float64,
                     device=cert.gap.device)
    stalled = (~torch.all(torch.isfinite(cert.x), dim=-1)
               | ~(torch.abs(cert.gap) <= pars.tol))
    return Solution(
        x=cert.x, lam=cert.lam, nu=cert.nu, newton_decrement=nan,
        duality_gap=cert.gap, eq_gap=cert.eq_res, norm_grad=nan,
        norm_dual_residual=nan, iters=sol.iters,
        maxed_out=sol.maxed_out, stalled=stalled,
        ineq_res=cert.ineq_res)


@dataclass(frozen=True)
class QP:
    """Dense QP data.  Use ``QP.create``; empty G/A allowed (shape (0, n))."""

    P: torch.Tensor   # (n, n) symmetric PSD, shared
    a: torch.Tensor   # (n,) or (B, n)
    G: torch.Tensor   # (mI, n), shared
    h: torch.Tensor   # (mI,) or (B, mI)
    A: torch.Tensor   # (mE, n), shared
    b: torch.Tensor   # (mE,) or (B, mE)
    n: int = static_field()

    @classmethod
    def create(cls, P, a, G=None, h=None, A=None, b=None, dtype=None,
               device=None) -> "QP":
        """``dtype`` defaults to the joint floating dtype of the inputs
        (f32 data stays f32), ``device`` to the card (``"cuda"``); pass
        ``device="cpu"`` for the CPU."""
        if (G is None) != (h is None) or (A is None) != (b is None):
            raise ValueError("G,h (and A,b) must be given together")
        (P, a, G, h, A, b), opts = _leaves((P, a, G, h, A, b), dtype, device)
        n = a.shape[-1]
        if G is None:
            G, h = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        if A is None:
            A, b = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        return cls(P=P, a=a, G=G, h=h, A=A, b=b, n=n)

    @property
    def batch(self) -> int | None:
        """The number of instances (None: every leaf shared)."""
        return _batch(self.a, self.h, self.b)

    @property
    def objective(self) -> QuadraticObjective:
        return QuadraticObjective(P=self.P, a=self.a,
                                  r=self.P.new_zeros(()))

    @property
    def inequalities(self) -> ConstraintSet:
        if self.G.shape[0] == 0:
            raise ValueError("QP has no inequality constraints; use the "
                             "equality-constrained Newton solver directly")
        return ConstraintSet(blocks=(rows_leq(self.G, self.h),))

    @property
    def equalities(self) -> EqualityConstraint | None:
        if self.A.shape[0] == 0:
            return None
        return EqualityConstraint(A=self.A, b=self.b)

    def solve(self, method: str = "BR", pars: SolverParams | None = None,
              feasible_point=None, x0=None) -> Solution:
        """Solve with automatic phase-I from ``x0`` (default 0); raises
        InfeasibleProblemError when an instance has no strictly feasible
        point."""
        pars = pars or SolverParams()
        single = self.batch is None and (
            feasible_point is None or torch.as_tensor(feasible_point).dim()
            == 1)
        if feasible_point is None:
            x0 = self.P.new_zeros((self.n,)) if x0 is None else x0
            feasible_point = find_feasible_point(
                self.inequalities, _points(x0, self.batch, self.n, self.P),
                pars, self.equalities)
        return _one(self.solve_jittable(feasible_point, method, pars),
                    single)

    def _solve_batch(self, x, method, pars) -> Solution:
        if method == "BR":
            return barrier_solve(self.objective, self.inequalities, x, pars,
                                 eqs=self.equalities)
        if method == "PD":
            return primal_dual_solve(self.objective, self.inequalities, x,
                                     pars, eqs=self.equalities)
        raise ValueError(f"unknown method: {method!r}")

    def solve_jittable(self, feasible_point, method: str = "BR",
                       pars: SolverParams | None = None) -> Solution:
        """Solve from strictly feasible points, (B, n) or (n,)."""
        pars = pars or SolverParams()
        x = _points(feasible_point, self.batch, self.n, self.P)
        single = self.batch is None and \
            torch.as_tensor(feasible_point).dim() == 1
        return _one(self._solve_batch(x, method, pars), single)

    def solve_certified(self, feasible_point,
                        pars: SolverParams | None = None,
                        method: str = "PD",
                        polish_steps: int = 3) -> Solution:
        """Native-precision solve + f64 finishing pass certified to the
        reference's written gap contract 1e-8 (SolverParams.scala:41).
        Needs strictly convex P (the dual closed form inverts it); the
        Solution's duality_gap / ineq_res / eq_gap are MEASURED f64
        residuals."""
        pars = pars or SolverParams()
        x = _points(feasible_point, self.batch, self.n, self.P)
        single = self.batch is None and \
            torch.as_tensor(feasible_point).dim() == 1
        sol = self._solve_batch(x, method, pars)
        cert = qp_certify(self.P, self.a, self.G, self.h, self.A, self.b,
                          sol.x, sol.lam, sol.nu, polish_steps=polish_steps)
        return _one(_certified_solution(cert, sol, pars), single)


@dataclass(frozen=True)
class DiagQP:
    """Structured QP family:  min a.x + sum_j c_j x_j^2 / 2
    s.t.  U x <= ub,  x > 0,  A x = b: diagonal Hessian, few dense rows,
    solved by the Woodbury barrier at O(n (k+p)^2) a Newton step.  c, U, A
    are shared; a, ub, b shared or per instance (B, ...)."""

    c: torch.Tensor    # (n,) diagonal of P (>= 0)
    a: torch.Tensor    # (n,) or (B, n)
    U: torch.Tensor    # (k, n) dense inequality rows
    ub: torch.Tensor   # (k,) or (B, k)
    A: torch.Tensor    # (p, n)
    b: torch.Tensor    # (p,) or (B, p)

    @classmethod
    def create(cls, c, a, U=None, ub=None, A=None, b=None, dtype=None,
               device=None) -> "DiagQP":
        """As ``QP.create``: dtype from the inputs, device the card by
        default; empty U/A allowed."""
        if (U is None) != (ub is None) or (A is None) != (b is None):
            raise ValueError("U,ub (and A,b) must be given together")
        (c, a, U, ub, A, b), opts = _leaves((c, a, U, ub, A, b), dtype,
                                            device)
        n = a.shape[-1]
        if U is None:
            U, ub = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        if A is None:
            A, b = torch.zeros((0, n), **opts), torch.zeros((0,), **opts)
        return cls(c=c, a=a, U=U, ub=ub, A=A, b=b)

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    @property
    def batch(self) -> int | None:
        return _batch(self.a, self.ub, self.b)

    def value(self, x):
        a = lead(self.a, 1, x)
        return (x * a).sum(dim=-1) + 0.5 * (self.c * x * x).sum(dim=-1)

    def grad(self, x):
        return lead(self.a, 1, x) + self.c * x

    def hess_diag(self, x):
        return self.c.expand_as(x)

    @property
    def inequalities(self) -> ConstraintSet:
        """U x <= ub plus the positivity rows the structured solver bakes
        into its barrier, as an explicit ConstraintSet for phase-I."""
        blocks = []
        if self.U.shape[0] > 0:
            blocks.append(rows_leq(self.U, self.ub))
        blocks.append(positivity(self.n, dtype=self.a.dtype,
                                 device=self.a.device))
        return ConstraintSet(blocks=tuple(blocks))

    @property
    def equalities(self) -> EqualityConstraint | None:
        if self.A.shape[0] == 0:
            return None
        return EqualityConstraint(A=self.A, b=self.b)

    def solve(self, pars: SolverParams | None = None, feasible_point=None,
              x0=None) -> Solution:
        """Solve with automatic phase-I from ``x0`` (default: all ones,
        strictly inside the orthant); the all-linear set takes phase-I's
        exact low-rank analysis.  May raise InfeasibleProblemError."""
        pars = pars or SolverParams()
        single = self.batch is None and (
            feasible_point is None or torch.as_tensor(feasible_point).dim()
            == 1)
        if feasible_point is None:
            x0 = self.a.new_ones((self.n,)) if x0 is None else x0
            feasible_point = find_feasible_point(
                self.inequalities, _points(x0, self.batch, self.n, self.a),
                pars, self.equalities)
        return _one(self.solve_jittable(feasible_point, pars), single)

    def _solve_batch(self, x, pars) -> Solution:
        return barrier_solve_structured(self, self.U, self.ub, self.A,
                                        self.b, x, pars)

    def solve_jittable(self, feasible_point,
                       pars: SolverParams | None = None) -> Solution:
        x = _points(feasible_point, self.batch, self.n, self.a)
        single = self.batch is None and \
            torch.as_tensor(feasible_point).dim() == 1
        return _one(self._solve_batch(x, pars), single)

    def solve_certified(self, feasible_point,
                        pars: SolverParams | None = None,
                        polish_steps: int = 3) -> Solution:
        """Structured solve + f64 certified finish (see
        ``QP.solve_certified``).  Needs strictly positive ``c`` (an LP has
        a singular Hessian and no closed-form dual value); the positivity
        rows -x <= 0 join the certificate's constraint system, so the pass
        factors a dense (k + p + n)^2 Schur matrix per instance."""
        if not bool(torch.all(self.c > 0)):
            raise ValueError(
                "solve_certified needs strictly positive c (an LP has a "
                "singular Hessian; solve it in f64 directly instead)")
        pars = pars or SolverParams()
        x = _points(feasible_point, self.batch, self.n, self.a)
        single = self.batch is None and \
            torch.as_tensor(feasible_point).dim() == 1
        sol = self._solve_batch(x, pars)
        n, opts = self.n, dict(dtype=self.a.dtype, device=self.a.device)
        G_full = torch.cat([self.U, -torch.eye(n, **opts)], dim=0)
        h_full = _cat_last([self.ub, torch.zeros((n,), **opts)], 1)
        cert = qp_certify(self.c, self.a, G_full, h_full, self.A, self.b,
                          sol.x, sol.lam, sol.nu, polish_steps=polish_steps)
        return _one(_certified_solution(cert, sol, pars), single)


def LP(a, U=None, ub=None, A=None, b=None, dtype=None, device=None) -> DiagQP:
    """Linear program  min a.x  s.t.  U x <= ub,  x > 0,  A x = b  as the
    c = 0 member of the DiagQP family: the barrier Hessian is diag(1/x^2)
    + low rank, so LPs get the same O(n (k+p)^2) Newton steps
    (KKTSystem.scala:55-59's zero-Hessian escape hatch as a fast path).
    ``dtype`` follows the inputs, ``device`` defaults to the card."""
    dtype = dtype or _joint_float_dtype(
        [v for v in (a, U, ub, A, b) if v is not None])
    a = torch.as_tensor(a)
    return DiagQP.create(torch.zeros(a.shape[-1:], dtype=dtype), a, U, ub, A,
                         b, dtype=dtype, device=device)


@dataclass(frozen=True)
class QPCertificate:
    """F64-certified refinement of QP iterates (see ``qp_certify``), one
    entry per instance."""

    x: torch.Tensor          # refined primal (f64)
    gap: torch.Tensor        # MEASURED f(x) - g(lam, nu) in f64
    ineq_res: torch.Tensor   # max(G x - h)_+
    eq_res: torch.Tensor     # max |A x - b|
    lam: torch.Tensor        # polished inequality duals (f64, >= 0)
    nu: torch.Tensor         # polished equality duals (f64)


def qp_certify(P, a, G, h, A, b, x, lam, nu, polish_steps: int = 3,
               r=0.0) -> QPCertificate:
    """F64 finishing pass for STRICTLY convex QPs: refine iterates to the
    reference's written 1e-8 duality-gap contract and certify them with
    measured residuals (SolverParams.scala:41).

    For P > 0 the dual function has the closed form (B = [G; A] rows,
    q = (h, b), z = (lam >= 0, nu)):

        g(z) = -(1/2) w' P^-1 w - q.z + r,      w = a + B'z,

    a TRUE lower bound on the primal optimum for ANY lam >= 0, so f(x) -
    g(z) is an honest certificate.  The polish solves the equality KKT
    system of the current active set exactly in Schur form (M|act z =
    rhs|act, M = B P^-1 B' factored once for the batch, the masked Schur
    matrix once per instance and pass); stationarity recovers the primal
    x(z) = -P^-1 w.  Keeps whichever of {refined, input} primal scores
    better on gap + measured violations.

    ``P`` (n, n) dense or (n,) strictly positive DIAGONAL, G (m, n) and A
    (p, n) shared; a, h, b shared or per instance (B, ...); x (B, n) (or
    (n,) for one instance), lam (B, m), nu (B, p).  LP (P singular) is
    not certifiable this way.
    """
    f64 = torch.float64
    single = x.dim() == 1
    if single:
        x, lam, nu = x[None], lam[None], nu[None]
    Bt = x.shape[0]
    diag_P = P.dim() == 1
    P64, a64 = P.to(f64), a.to(f64)
    G64, h64 = G.to(f64), h.to(f64)
    A64, b64 = A.to(f64), b.to(f64)
    x64 = x.to(f64)
    m, p = G.shape[0], A.shape[0]
    dim = m + p
    Bm = torch.cat([G64, A64], dim=0)                       # (m+p, n)
    q = _cat_last([h64.expand(Bt, m), b64.expand(Bt, p)], 1)   # (B, m+p)
    # non-finite warm-start multipliers (e.g. a barrier route that does
    # not estimate nu) start from 0: any (lam >= 0, nu) is dual-feasible
    lam0 = torch.clamp_min(torch.nan_to_num(lam.to(f64), nan=0.0,
                                            posinf=0.0, neginf=0.0), 0.0)
    nu0 = torch.nan_to_num(nu.to(f64), nan=0.0, posinf=0.0, neginf=0.0)
    z = torch.cat([lam0, nu0], dim=-1)
    ineq = torch.arange(dim, device=x.device) < m

    if diag_P:
        def P_cols(V):                           # (n, k): O(n) solves
            return V / P64[:, None]

        def P_rows(v):                           # (B, n)
            return v / P64

        def P_mv(v):
            return P64 * v
    else:
        L_P, _ = regularized_cholesky(P64, delta=1e-13)

        def P_cols(V):
            # one refinement pass against the measured residual (the
            # reference's, written for the TPU's emulated f64; parity
            # keeps it)
            y = chol_solve_factored(L_P, V)
            return y + chol_solve_factored(L_P, V - P64 @ y)

        def P_rows(v):
            return P_cols(v.T).T

        def P_mv(v):
            return v @ P64.T
    Y = P_cols(Bm.T)                                         # (n, m+p)
    BY = Bm @ Y
    M = 0.5 * (BY + BY.T)                                    # B P^-1 B'
    y_a = P_rows(a64.expand(Bt, -1))                         # (B, n)
    rhs = -(q + y_a @ Bm.T)                                  # (B, m+p)

    def g_of(z):
        w = a64 + z @ Bm
        y = P_rows(w)
        gval = -0.5 * (w * y).sum(dim=-1) - (q * z).sum(dim=-1) + r
        return gval, -y

    # ACTIVE-SET passes, not Newton ascent: the dual Hessian -B P^-1 B'
    # is singular whenever m + p > n; each pass solves the equality KKT
    # system restricted to the current active set exactly, then updates
    # membership.  The initial membership comes from the PRIMAL slack at
    # the warm iterate (any lam >= 0 is dual-feasible, so the multipliers
    # handed in may be poor).
    slack0 = q - x64 @ Bm.T
    act = torch.where(ineq, slack0 < 1e-4 * (1.0 + torch.abs(q)), True)
    zs = z
    for _ in range(max(polish_steps, 1)):
        D = act.to(f64)
        Mf = M * (D[:, :, None] * D[:, None, :]) + torch.diag_embed(1.0 - D)
        Mf = Mf + torch.diag_embed(
            1e-13 * (1.0 + torch.abs(torch.diagonal(Mf, dim1=-2, dim2=-1))))
        Lm, _ = regularized_cholesky(Mf, delta=1e-14)
        zs = D * chol_solve_factored(Lm, D * rhs)
        # refinement of the Schur solve (see P_cols)
        res = D * rhs - (Mf @ zs[..., None])[..., 0]
        zs = D * (zs + chol_solve_factored(Lm, res))
        _, xz = g_of(zs)
        slack = q - xz @ Bm.T
        act_new = torch.where(ineq, (zs > 0.0) | (slack < 0.0), True)
        finite = torch.all(torch.isfinite(xz), dim=-1, keepdim=True)
        act = torch.where(finite, act_new, act)
    z_ref = torch.where(ineq, torch.clamp_min(zs, 0.0), zs)
    z = z_ref if polish_steps > 0 else z
    gval, x_ref = g_of(z)

    def f_of(xc):
        return (xc * a64).sum(dim=-1) + 0.5 * (xc * P_mv(xc)).sum(dim=-1) + r

    def residuals(xc):
        zero = xc.new_zeros(xc.shape[:-1])
        viol = (torch.amax(torch.clamp_min(xc @ G64.T - h64, 0.0), dim=-1)
                if m > 0 else zero)
        eq = (torch.amax(torch.abs(xc @ A64.T - b64), dim=-1) if p > 0
              else zero)
        return viol, eq

    gap_ref = f_of(x_ref) - gval
    gap_in = f_of(x64) - gval
    viol_ref, eq_ref = residuals(x_ref)
    viol_in, eq_in = residuals(x64)
    score_ref = torch.clamp_min(gap_ref, 0.0) + viol_ref + eq_ref
    score_in = torch.clamp_min(gap_in, 0.0) + viol_in + eq_in
    better = torch.isfinite(score_ref) & (
        (score_ref <= score_in) | ~torch.isfinite(score_in))
    cert = QPCertificate(
        x=torch.where(better[:, None], x_ref, x64),
        gap=torch.where(better, gap_ref, gap_in),
        ineq_res=torch.where(better, viol_ref, viol_in),
        eq_res=torch.where(better, eq_ref, eq_in),
        lam=z[:, :m], nu=z[:, m:])
    return _one(cert, single)
