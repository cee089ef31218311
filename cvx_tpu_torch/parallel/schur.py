"""Distributed Schur-complement consensus for block-separable programs.

Counterpart of ``cvx_tpu/parallel/schur.py`` (north-star config 5):

    min  sum_k f_k(x_k)    s.t.   G_k x_k <= u_k   (per-block inequalities)
                                  sum_k C_k x_k = c  (coupling equalities)

The barrier Hessian is block-diagonal, so the Newton-KKT system

    H_k dx_k + C_k^T w = -q_k   (k = 1..K),      sum_k C_k dx_k = rhs

is solved by per-block factorizations plus ONE small p x p reduced
(Schur) system

    S = sum_k C_k H_k^-1 C_k^T,    S w = -(rhs + sum_k C_k H_k^-1 q_k),
    dx_k = -H_k^-1 (q_k + C_k^T w)

(cvx/KKTSystem.scala:99-167 generalized to many blocks).  Distribution:
the blocks are split over the ranks of a ``Mesh``; the only
communication is an all-reduce of the (p, p) Schur contribution and the
(p,) right-hand side, then every rank back-substitutes its own blocks and
the blocks' steps are all-gathered.  The per-block factorizations use the
port's ``ops.cholesky.regularized_cholesky`` and ``ops.equilibrate``, as
the reference's use ``lax.linalg``.

Every K-stacked argument of the sharded functions is the whole problem on
every rank (the reference's global arrays); a rank computes on its own
blocks, and the results come back whole on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops._batch import mv
from ..ops.cholesky import chol_solve_factored, regularized_cholesky
from ..ops.equilibrate import ruiz_equilibrate
from ..solvers.types import Solution, SolverParams
from ..tree import exact_f32
from .mesh import Mesh


def _local_schur_pieces(H, C, q):
    """For the blocks at hand, H (Kl, nb, nb), C (Kl, p, nb), q (Kl, nb):
    H^-1 C^T and H^-1 q per block (kept for back-substitution), and the
    Schur contribution sum_k C_k H_k^-1 C_k^T and the rhs contribution
    sum_k C_k H_k^-1 q_k."""
    # fixed sweeps: a convergent loop would couple every block to the
    # slowest one (see ops/kkt._make_block_solver)
    d, Q = ruiz_equilibrate(H, sweeps=4)
    L, _ = regularized_cholesky(Q)
    Bm = C * d[:, None, :]
    Hinv_Ct = d[:, :, None] * chol_solve_factored(L, Bm.mT)   # (Kl, nb, p)
    Hinv_q = d * chol_solve_factored(L, d * q)                # (Kl, nb)
    return Hinv_Ct, Hinv_q, (C @ Hinv_Ct).sum(dim=0), mv(C, Hinv_q).sum(dim=0)


def _reduced_solve(Hinv_Ct, Hinv_q, S, y, rhs):
    S = 0.5 * (S + S.T)
    Ls, _ = regularized_cholesky(S)
    w = chol_solve_factored(Ls, -(rhs + y))
    dx = -(Hinv_q + (Hinv_Ct @ w[:, None])[..., 0])
    return dx, w


@exact_f32
def schur_kkt_solve(H, C, q, rhs):
    """Single-rank block-separable KKT solve.

    H (K, nb, nb) SPD blocks; C (K, p, nb) coupling rows; q (K, nb);
    rhs (p,) the equality right-hand side (= c - sum C_k x_k at the
    current iterate for infeasible-start Newton).  Returns (dx (K, nb),
    w (p,)).
    """
    return _reduced_solve(*_local_schur_pieces(H, C, q), rhs)


def make_sharded_schur_solver(mesh: Mesh, axis: str = "blocks") -> Callable:
    """Sharded version: the blocks are split over the ranks and one
    all-reduce couples them.  The returned function has the signature of
    ``schur_kkt_solve`` (whole arrays in, whole dx and w out on every
    rank); K must divide by the mesh size.  ``axis`` names the mesh's
    axis."""
    mesh.check_axis(axis)

    @exact_f32
    def solve(H, C, q, rhs):
        rows = mesh.local_rows(H.shape[0], "blocks")
        Hinv_Ct, Hinv_q, S_loc, y_loc = _local_schur_pieces(
            H[rows], C[rows], q[rows])
        S, y = mesh.sum(S_loc), mesh.sum(y_loc)
        dx, w = _reduced_solve(Hinv_Ct, Hinv_q, S, y, rhs)
        return mesh.gather(dx), w

    solve.mesh = mesh
    return solve


@dataclass
class SeparableCertificate:
    """F64-certified refinement of a block-separable iterate
    (see ``separable_certify``)."""

    x: torch.Tensor          # refined primal (K, nb), f64
    gap: torch.Tensor        # MEASURED f(x) - g(lam, w) in f64 (true bound)
    ineq_res: torch.Tensor   # max (G_k x_k - u_k)_+ over all blocks
    eq_res: torch.Tensor     # max |sum_k C_k x_k - c|
    lam: torch.Tensor        # polished per-block inequality duals (K, mb)
    nu: torch.Tensor         # polished coupling duals (p,)


def _kmv(M, x):
    """Per-block M_k x_k: M (K, r, c), x (..., K, c) -> (..., K, r)."""
    return torch.einsum("kij,...kj->...ki", M, x)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def separable_certify(prob: "SeparableProblem", x, lam, nu,
                      polish_steps: int = 2,
                      _mesh: Mesh | None = None) -> SeparableCertificate:
    """F64 finishing pass for a block-separable QP: refine the barrier
    exit to the reference's written 1e-8 duality-gap contract with a
    MEASURED dual-value certificate.

    The Lagrange dual of  min sum_k f_k(x_k)  s.t.  G_k x_k <= u_k,
    sum_k C_k x_k = c  has, for strictly convex P_k, the closed form
    (w_k := a_k + G_k' lam_k + C_k' w):

        g(lam, w) = sum_k [ -1/2 w_k' P_k^-1 w_k - lam_k . u_k ] - w . c,

    a TRUE lower bound for ANY lam >= 0, so f(x) - g is an honest
    certificate.  The polish is an active-set equality-KKT pass that
    eliminates lam_k per block through an (mb, mb) masked factorization,
    reduces to ONE (p, p) coupling Schur system in w, back-substitutes and
    updates the membership from the recovered primal's slacks; then one
    residual-correction pass on the coupling.  O(K (nb^3 + mb^3)) a pass.
    Always in f64.  ``_mesh`` names the ranks its cross-block reductions
    run over when ``prob``, ``x`` and ``lam`` hold this rank's blocks
    (``make_sharded_separable_certify``).
    """
    f64 = torch.float64
    P, a, G, u, C, c = (v.to(f64) for v in (prob.P, prob.a, prob.G, prob.u,
                                            prob.C, prob.c))
    x64 = x.to(f64)
    mb = G.shape[1]
    p = c.shape[0]
    lam0 = torch.clamp_min(torch.nan_to_num(lam.to(f64), nan=0.0,
                                            posinf=0.0, neginf=0.0), 0.0)
    w0 = torch.nan_to_num(nu.to(f64), nan=0.0, posinf=0.0, neginf=0.0)

    # cross-block reductions: local on one rank, all-reduced over the mesh
    def gsum(v):
        return v if _mesh is None else _mesh.sum(v)

    def gmax(v):
        return v if _mesh is None else _mesh.max(v)

    def gall(v):
        return v if _mesh is None else _mesh.all(v)

    Lp, _ = regularized_cholesky(P, delta=1e-13)
    YG = chol_solve_factored(Lp, G.mT)            # P^-1 G'  (K, nb, mb)
    YC = chol_solve_factored(Lp, C.mT)            # P^-1 C'  (K, nb, p)
    ya = chol_solve_factored(Lp, a)                     # P^-1 a   (K, nb)
    M_GG, M_GC, M_CC = G @ YG, G @ YC, C @ YC
    y_G, y_C = mv(G, ya), mv(C, ya)

    def g_of(lam_, w_):
        """Dual value and recovered primal for ANY (lam >= 0, w)."""
        wv = a + mv(G.mT, lam_) + (C.mT @ w_)
        xk = -chol_solve_factored(Lp, wv)
        gk = 0.5 * _dot(wv, xk) - _dot(lam_, u)
        return gsum(gk.sum()) - torch.dot(w_, c), xk

    # membership from the PRIMAL slack at the warm iterate
    slack0 = u - mv(G, x64)
    act = slack0 < 1e-4 * (1.0 + torch.abs(u))
    eye_mb = torch.eye(mb, dtype=f64, device=u.device)
    eye_p = torch.eye(p, dtype=f64, device=u.device)

    def one_pass(act):
        D = act.to(f64)
        F = M_GG * (D[:, :, None] * D[:, None, :]) + torch.diag_embed(1.0 - D)
        F = F + (1e-13 * (1.0 + torch.abs(torch.diagonal(
            F, dim1=1, dim2=2))))[:, :, None] * eye_mb
        Lf, _ = regularized_cholesky(F, delta=1e-14)
        # lam_k(w) = -F^-1 D (u + y_G + M_GC w): the w-independent part
        # and the (mb, p) sensitivity
        t0 = chol_solve_factored(Lf, D * (u + y_G))                 # (K, mb)
        T = chol_solve_factored(Lf, D[:, :, None] * M_GC)     # (K, mb, p)
        S_k = -M_GC.mT @ T
        r_k = mv(M_GC.mT, t0)
        S = gsum(M_CC.sum(dim=0) + S_k.sum(dim=0))
        S = 0.5 * (S + S.T) + (1e-13 * (1.0 + torch.abs(torch.diagonal(
            S))))[:, None] * eye_p
        rhs = -(c + gsum(y_C.sum(dim=0))) + gsum(r_k.sum(dim=0))
        Ls, _ = regularized_cholesky(S, delta=1e-14)
        w = chol_solve_factored(Ls, rhs)
        lam_ = -(t0 + (T @ w[:, None])[..., 0])
        lam_ = D * lam_
        _, xk = g_of(lam_, w)
        slack = u - mv(G, xk)
        act_new = (lam_ > 0.0) | (slack < 0.0)
        ok = gall(torch.all(torch.isfinite(xk)))
        return torch.where(ok, act_new, act), (lam_, w, T, Ls)

    for _ in range(max(polish_steps, 1)):
        act, last = one_pass(act)
    lam_ref = torch.clamp_min(last[0], 0.0)
    w_ref = last[1]
    if polish_steps > 0:
        lam_z, w_z = lam_ref, w_ref
    else:
        lam_z, w_z = lam0, w0
    gval, x_ref = g_of(lam_z, w_z)

    # residual correction on the coupling: correct against the MEASURED
    # residual r = sum C x - c with the same approximate operator
    # (w += S^-1 r, lam -= T S^-1 r); still a valid bound for any
    # (lam >= 0, w)
    T_last, Ls_last = last[2], last[3]
    r_meas = gsum(mv(C, x_ref).sum(dim=0)) - c
    dw = chol_solve_factored(Ls_last, r_meas)
    w_c = w_z + dw
    lam_c = torch.clamp_min(lam_z - (T_last @ dw[:, None])[..., 0], 0.0)
    gval_c, x_c = g_of(lam_c, w_c)
    fin_c = gall(torch.all(torch.isfinite(x_c))) & (polish_steps > 0)
    eq_ref_pre = torch.abs(r_meas).max()
    eq_c = torch.abs(gsum(mv(C, x_c).sum(dim=0)) - c).max()
    take_c = fin_c & (eq_c < eq_ref_pre)
    lam_z = torch.where(take_c, lam_c, lam_z)
    w_z = torch.where(take_c, w_c, w_z)
    gval = torch.where(take_c, gval_c, gval)
    x_ref = torch.where(take_c, x_c, x_ref)

    def f_of(xc):
        return gsum((_dot(a, xc) + 0.5 * _dot(xc, mv(P, xc))).sum())

    def residuals(xc):
        viol = gmax(torch.clamp_min(mv(G, xc) - u, 0.0).max())
        eq = torch.abs(gsum(mv(C, xc).sum(dim=0)) - c).max()
        return viol, eq

    gap_ref = f_of(x_ref) - gval
    gap_in = f_of(x64) - gval
    viol_ref, eq_ref = residuals(x_ref)
    viol_in, eq_in = residuals(x64)
    score_ref = torch.clamp_min(gap_ref, 0.0) + viol_ref + eq_ref
    score_in = torch.clamp_min(gap_in, 0.0) + viol_in + eq_in
    better = torch.isfinite(score_ref) & (
        (score_ref <= score_in) | ~torch.isfinite(score_in))
    return SeparableCertificate(
        x=torch.where(better, x_ref, x64),
        gap=torch.where(better, gap_ref, gap_in),
        ineq_res=torch.where(better, viol_ref, viol_in),
        eq_res=torch.where(better, eq_ref, eq_in),
        lam=torch.where(better, lam_z, lam0),
        nu=torch.where(better, w_z, w0))


def make_sharded_separable_certify(mesh: Mesh, axis: str = "blocks",
                                   polish_steps: int = 2) -> Callable:
    """Sharded ``separable_certify``: the blocks are split over the ranks,
    as in ``make_sharded_schur_solver``; the only communication is the
    all-reduce of the (p, p) / (p,) coupling pieces, a max over block
    residuals and the agreement of the finiteness tests.  The returned
    function has the signature ``(prob, x, lam, nu) ->
    SeparableCertificate`` on the whole problem; x and lam come back
    whole on every rank.  K must divide by the mesh size.  ``axis`` names
    the mesh's axis."""
    mesh.check_axis(axis)

    def certify(prob: SeparableProblem, x, lam, nu):
        rows = mesh.local_rows(prob.K, "blocks")
        cert = separable_certify(prob.blocks(rows), x[rows], lam[rows], nu,
                                 polish_steps=polish_steps, _mesh=mesh)
        return SeparableCertificate(
            x=mesh.gather(cert.x), gap=cert.gap, ineq_res=cert.ineq_res,
            eq_res=cert.eq_res, lam=mesh.gather(cert.lam), nu=cert.nu)

    return certify


# ---------------------------------------------------------------------------
# A full barrier solver for block-separable QP/KL-style programs.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeparableProblem:
    """min sum_k [ a_k.x_k + x_k' P_k x_k / 2 ]  s.t.  G_k x_k <= u_k,
    sum_k C_k x_k = c.   Every tensor but c is stacked over the blocks K."""

    P: torch.Tensor   # (K, nb, nb)
    a: torch.Tensor   # (K, nb)
    G: torch.Tensor   # (K, mb, nb)
    u: torch.Tensor   # (K, mb)
    C: torch.Tensor   # (K, p, nb)
    c: torch.Tensor   # (p,)

    @property
    def K(self):
        return self.P.shape[0]

    @property
    def nb(self):
        return self.P.shape[1]

    def blocks(self, rows) -> "SeparableProblem":
        """The problem's blocks ``rows`` (c is shared)."""
        return SeparableProblem(P=self.P[rows], a=self.a[rows],
                                G=self.G[rows], u=self.u[rows],
                                C=self.C[rows], c=self.c)

    def obj_value(self, x):
        """The objective at x (..., K, nb)."""
        return (_dot(self.a, x) + 0.5 * _dot(x, _kmv(self.P, x))).sum(dim=-1)

    def barrier_value(self, t, x):
        """t f(x) - sum log(u - G x) at x (..., K, nb); NaN outside."""
        d = self.u - _kmv(self.G, x)
        return t * self.obj_value(x) - torch.log(d).sum(dim=(-2, -1))

    def barrier_pieces(self, t, x):
        """Per-block barrier value/grad/Hessian (block-diagonal)."""
        d = self.u - _kmv(self.G, x)
        inv_d = 1.0 / d
        val = t * self.obj_value(x) - torch.log(d).sum()
        grad = t * (self.a + _kmv(self.P, x)) + _kmv(self.G.mT, inv_d)
        hess = t * self.P + (self.G.mT * (inv_d * inv_d)[:, None, :]) @ self.G
        return val, grad, hess

    def feasible(self, x):
        """All margins u - G x > 0, at x (..., K, nb)."""
        return torch.all((self.u - _kmv(self.G, x) > 0).flatten(-2), dim=-1)


def _round(v: float, dtype) -> float:
    """``v`` rounded to ``dtype`` (the reference carries t in the dtype)."""
    return float(torch.tensor(v, dtype=dtype))


@exact_f32
def separable_barrier_solve(prob: SeparableProblem, x0,
                            pars: SolverParams | None = None,
                            kkt_solver: Callable | None = None) -> Solution:
    """Barrier method for a SeparableProblem from a strictly feasible x0
    (coupling equalities may start violated: infeasible-start Newton).

    ``kkt_solver(H, C, q, rhs) -> (dx, w)`` defaults to the single-rank
    ``schur_kkt_solve``; pass ``make_sharded_schur_solver(mesh)`` to run
    the blocks across ranks (every rank then runs this loop on the whole
    problem, and each loop exit is agreed over the mesh).

    Returns a Solution: ``x`` (K, nb), per-block inequality duals ``lam``
    (K, mb) from the barrier estimate 1/(t d), the coupling duals ``nu``
    (p,), and per-block ``stalled`` flags: a poisoned block (non-finite
    iterate or violated margins) is flagged by itself, and a line-search
    stall while the decrement is still above sqrt(tol) flags every block
    (the Newton system couples them).
    """
    pars = pars or SolverParams()
    solver = kkt_solver or schur_kkt_solve
    mesh = getattr(solver, "mesh", None)
    m_total = prob.G.shape[0] * prob.G.shape[1]
    dtype, dev = x0.dtype, x0.device
    K = prob.K
    p = prob.c.shape[0]
    tol = pars.tol
    hard_stall_dec = math.sqrt(_round(tol, dtype))
    ss = pars.beta ** torch.arange(pars.ls_max_steps, device=dev).to(dtype)

    def agree(flag) -> bool:
        return mesh.agree(flag) if mesh is not None else bool(flag)

    def coupling(x):
        return _kmv(prob.C, x).sum(dim=-2) - prob.c

    def inner_newton(t, x, w):
        big = torch.tensor(math.inf, dtype=dtype, device=dev)
        dec, eq_err = big, big
        it, hard, moved = 0, torch.tensor(False, device=dev), True
        while True:
            go = ((dec > tol) | (eq_err > math.sqrt(tol))) & moved
            # a rejected step leaves the state IDENTICAL, so the next
            # iteration would recompute the same rejected step: exit
            if not (it < pars.max_iter and agree(go)):
                break
            val, grads, hesss = prob.barrier_pieces(t, x)
            eq_resid = coupling(x)
            # Newton: sum_k C_k dx_k must equal -(sum C x - c)
            dx, w_new = solver(hesss, prob.C, grads, -eq_resid)
            q = (dx * grads).sum()
            dec = -q / 2.0
            # every backtracking candidate at once
            xs = x + ss[:, None, None] * dx
            vs = prob.barrier_value(t, xs)
            ok = prob.feasible(xs) & torch.isfinite(vs)
            armijo = vs <= val + pars.alpha * ss * q
            eq_new = torch.linalg.vector_norm(coupling(xs), dim=-1)
            eq_old = torch.linalg.vector_norm(eq_resid)
            improving = torch.where(
                dec > tol, armijo,
                eq_new <= (1 - pars.alpha * ss) * eq_old + tol)
            accepts = ok & improving
            # true select + finiteness guard: with s = 0 and a non-finite
            # direction, x + s dx would be NaN (0 * inf)
            take = accepts.any() & torch.all(torch.isfinite(dx))
            s = torch.where(take, ss[torch.argmax(accepts.to(torch.int8))],
                            0.0)
            x = torch.where(take, x + s * dx, x)
            w = torch.where(take, w_new, w)
            eq_err = torch.linalg.vector_norm(coupling(x))
            # a rejected step while the decrement still certifies progress
            # to go (or is not finite) is a REAL stall, not convergence
            hard = hard | (~take & ((dec > hard_stall_dec)
                                    | ~torch.isfinite(dec)))
            dec = torch.where(s > 0, dec, 0.0)   # stalled -> exit via dec
            moved = take
            it += 1
        return x, w, it, hard

    x = x0
    w = torch.zeros((p,), dtype=dtype, device=dev)
    t, t_active = 1.0, 1.0
    outer_it, n_newton = 0, 0
    hard = torch.tensor(False, device=dev)
    while agree(_round(m_total / t, dtype) * pars.mu > tol
                and outer_it < pars.outer_max_iter):
        x_new, w, inner_it, hard_i = inner_newton(t, x, w)
        if agree(bool(torch.any(x_new != x))):
            t_active = t
        x = x_new
        t = _round(pars.mu * t, dtype)
        outer_it += 1
        n_newton += inner_it
        hard = hard | hard_i

    t_solved = t / pars.mu
    margins = prob.u - mv(prob.G, x)
    lam = 1.0 / (t_active * margins)            # (K, mb) per-block duals
    nu = w / t_active                           # coupling duals
    eps = torch.finfo(dtype).eps
    # per-block health: a finite iterate, a finite barrier gradient (NaN
    # data shows there even when x never left x0), unviolated margins
    _, exit_grads, _ = prob.barrier_pieces(t_active, x)
    block_ok = (torch.all(torch.isfinite(x), dim=1)
                & torch.all(torch.isfinite(exit_grads), dim=1)
                & torch.all(margins > -100.0 * eps * (1.0 + torch.abs(
                    prob.u)), dim=1))
    stalled = ~block_ok | hard.expand(K)
    nan = torch.tensor(math.nan, dtype=dtype, device=dev)
    gap = torch.where(block_ok.all(),
                      torch.tensor(m_total / t_solved, dtype=dtype,
                                   device=dev), nan)
    return Solution(
        x=x, lam=lam, nu=nu, newton_decrement=nan, duality_gap=gap,
        eq_gap=torch.linalg.vector_norm(coupling(x)), norm_grad=nan,
        norm_dual_residual=nan,
        iters=torch.tensor(n_newton, device=dev),
        maxed_out=torch.full((K,), outer_it >= pars.outer_max_iter,
                             device=dev),
        stalled=stalled)
