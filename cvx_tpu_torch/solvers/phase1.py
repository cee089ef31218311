"""Phase-I feasibility analysis, batched.

Counterpart of ``cvx_tpu/solvers/phase1.py`` (cvx/ConstraintSet.scala:
123-575): find a strictly feasible point of ``g_i(x) <= u_i`` (with
optional ``A x = b``) per instance, or certify infeasibility.

  * simple (no equalities): lift to (x, s) and minimize s until s < 0
    ([boyd] 11.4.1); all-linear sets take an exact low-rank Newton;
  * with equalities: as +/- inequalities with a tolerance, or eliminated
    through x = z0 + F u (the default: exact, one QR for shared
    equalities);
  * sum-of-infeasibilities (SOI): one slack per constraint.

Every analysis returns a ``FeasibilityReport`` with one entry per
instance.  ``find_feasible_point`` is the host gate that raises
``InfeasibleProblemError`` (ConstraintSet.scala:556-575).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from ..ops._batch import mv
from ..ops.cholesky import _chol_nan, default_delta
from ..problem.constraint_set import ConstraintSet, _cat_rows
from ..problem.constraints import LinearBlock
from ..problem.equality import EqualityConstraint
from ..problem.objective import LinearObjective
from ..tree import exact_f32
from .barrier import barrier_solve
from .newton import ls_steps
from .types import SolverParams, phase1_criterion


class InfeasibleProblemError(Exception):
    """Raised by find_feasible_point when phase-I certifies infeasibility
    (cvx/InfeasibleProblemException.scala)."""

    def __init__(self, report, violations=None):
        self.report = report
        self.violations = violations or []
        listing = ""
        if self.violations:
            rows = ", ".join(f"{name} (violation {v:+.3e})"
                             for name, _, v in self.violations[:10])
            more = (f", ... ({len(self.violations) - 10} more)"
                    if len(self.violations) > 10 else "")
            listing = f"; violated: {rows}{more}"
        super().__init__(
            f"problem infeasible: max slack {report.s_max.tolist()}, "
            f"equality error {report.eq_error.tolist()}{listing}")


def violated_constraints(cnts: ConstraintSet, x, tol: float = 0.0,
                         i: int = 0):
    """Host-side listing of the constraints violated at instance ``i`` of
    the points ``x`` (B, n) (FeasibilityReport.scala:32-47):
    ``[(name, global_index, violation)]`` with ``violation = g_j(x) - ub_j
    > tol``, worst first."""
    out, off = [], 0
    for b in cnts.blocks:
        r = (b.value(x) - b.ub)[i].detach().cpu()
        for j in torch.nonzero(r > tol).flatten().tolist():
            name = f"{b.label or type(b).__name__}[{j}]"
            out.append((name, off + j, float(r[j])))
        off += b.m
    return sorted(out, key=lambda t: -t[2])


@dataclass
class FeasibilityReport:
    """Result of a phase-I analysis (cvx/FeasibilityReport.scala), one
    entry per instance."""

    x: torch.Tensor                  # (B, n) feasibility candidate
    s_max: torch.Tensor              # (B,) max slack (< 0: strictly feasible)
    slacks: torch.Tensor             # (B, m) per constraint (SOI) or (B, 1)
    strictly_feasible: torch.Tensor  # (B,) bool
    eq_error: torch.Tensor           # (B,) ||A x - b|| at the candidate
    iters: torch.Tensor | None = None    # (B,) Newton steps taken

    def is_feasible(self, tol: float):
        """Feasible up to tolerance (FeasibilityReport.scala:35-36)."""
        return (self.s_max < tol) & (self.eq_error < tol)

    def violations(self, cnts: ConstraintSet, tol: float = 0.0, i: int = 0):
        """Violated-constraint listing at instance i's candidate."""
        return violated_constraints(cnts, self.x, tol, i)


def _eq_tol(pars: SolverParams, dtype) -> float:
    """max(tol, 100 eps): ||Ax-b|| floors at ~eps * scale."""
    return max(pars.tol, 100.0 * torch.finfo(dtype).eps)


def _slack_objective(n: int, dtype, device) -> LinearObjective:
    """f(x, s) = s (ConstraintSet.scala:131-144)."""
    a = torch.zeros((n + 1,), dtype=dtype, device=device)
    a[n] = 1.0
    return LinearObjective(a=a, r=torch.zeros((), dtype=dtype, device=device))


@exact_f32
def _phase1_linear_structured(cnts: ConstraintSet, x0,
                              pars: SolverParams) -> FeasibilityReport:
    """Phase-I for ALL-LINEAR constraint sets by exact low-rank Newton
    (the reference's phase1.py:117-240).

    The phase-I barrier Hessian is J^T diag(1/d^2) J with J = [G, -1], of
    rank at most m; the Jacobi-regularized system (eps diag(J^T W J) +
    J^T W J) dz = -g is solved exactly by the Woodbury identity, so the
    null-space motion that drives s -> -inf is well scaled.  Shared rows
    G stay shared; per-instance bounds only change the margins.
    """
    n = cnts.dim
    x0 = x0.to(torch.promote_types(x0.dtype, cnts.dtype))
    dtype, dev = x0.dtype, x0.device
    B = x0.shape[0]
    G = _cat_rows([b.G for b in cnts.blocks])
    c0 = torch.cat([b.c.expand(B, b.m) for b in cnts.blocks], dim=-1)
    ub = torch.cat([b.ub.expand(B, b.m) for b in cnts.blocks], dim=-1)
    m = G.shape[-2]
    J = torch.cat([G, -torch.ones((*G.shape[:-1], 1), dtype=dtype,
                                  device=dev)], dim=-1)      # (.., m, n+1)
    JJ = J * J
    z = cnts.phase1_feasible_point(x0)
    eps = 1e-6 if torch.finfo(dtype).bits >= 64 else 1e-4
    tiny = torch.finfo(dtype).tiny
    delta = default_delta(dtype)
    ls_ts = ls_steps(pars, pars.ls_max_steps, dtype, dev)
    eye = torch.eye(m, dtype=dtype, device=dev)
    en = torch.zeros((n + 1,), dtype=dtype, device=dev)
    en[n] = 1.0

    def newton_step(t, z, ub, c0, J, JJ):
        d = ub - c0 - mv(J, z)
        inv_d = 1.0 / d
        w = inv_d * inv_d
        g = t[:, None] * en + mv(J.mT, inv_d)
        h = eps * mv(JJ.mT, w) + tiny
        inv_h = 1.0 / h
        JD = J * inv_h[:, None, :]
        M = torch.diag_embed(1.0 / w) + JD @ J.mT
        M = M + (delta * torch.abs(torch.diagonal(M, dim1=-2, dim2=-1)).mean(
            dim=-1))[:, None, None] * eye
        L = _chol_nan(0.5 * (M + M.mT))
        y = torch.cholesky_solve(mv(JD, g)[..., None], L)[..., 0]
        dz = -(inv_h * g - mv(JD.mT, y))
        # cap the slack decrease per step: the objective is unbounded
        # below once feasible, and s < -1 already certifies with margin
        cap = torch.where(dz[:, n] < 0, torch.clamp_max(
            (torch.abs(z[:, n]) + 1.0) / torch.clamp_min(-dz[:, n], 1e-30),
            1.0), 1.0)
        dz = cap[:, None] * dz
        q = (dz * g).sum(dim=-1)
        f0 = t * z[:, n] - torch.sum(torch.log(d), dim=-1)
        Jdz = mv(J, dz)
        ds = d[:, None, :] - ls_ts[:, None] * Jdz[:, None, :]
        ok = torch.all(ds > 0, dim=-1)
        fs = (t[:, None] * (z[:, None, n] + ls_ts * dz[:, None, n])
              - torch.sum(torch.log(torch.where(ds > 0, ds, 1.0)), dim=-1))
        acc = ok & (fs <= f0[:, None] + pars.alpha * ls_ts * q[:, None])
        # true select + finiteness guard
        take = acc.any(dim=1) & torch.all(torch.isfinite(dz), dim=-1)
        s = torch.where(take, ls_ts[torch.argmax(acc.to(torch.int8), dim=1)],
                        0.0)
        z_new = torch.where(take[:, None], z + s[:, None] * dz, z)
        return z_new, -q / 2.0, ~take

    tol = max(pars.tol, 50.0 * torch.finfo(dtype).eps)
    # once m/t certifies s* within tol, more continuation only risks
    # overflow (an infeasible instance never reaches s < 0)
    t_max = 10.0 * pars.mu * m / pars.tol
    t = torch.ones(B, dtype=dtype, device=dev)
    it_out = torch.zeros(B, dtype=torch.long, device=dev)
    n_newton = torch.zeros(B, dtype=torch.long, device=dev)

    def outer_cond(z, t, it_out):
        return ((z[:, n] > -pars.tol_feas) & (it_out < pars.outer_max_iter)
                & (t <= t_max))

    per_instance = {"t", "z", "ub", "c0", "dec", "it", "stalled"}
    if J.dim() == 3:
        per_instance |= {"J", "JJ"}

    def inner_solve(t, z, go):
        """One stage's Newton loop for the instances ``go``.  Once at most
        half of the instances being stepped are still in it, those alone
        are gathered and stepped (the stragglers of a large batch)."""
        w = dict(t=t, z=z, ub=ub, c0=c0, J=J, JJ=JJ,
                 dec=torch.full((B,), math.inf, dtype=dtype, device=dev),
                 it=torch.zeros(B, dtype=torch.long, device=dev),
                 stalled=torch.zeros(B, dtype=torch.bool, device=dev))
        z_all, it_all, idx = z, w["it"], None
        act = go
        while True:
            act = (act & (w["it"] < pars.max_iter)
                   & (w["z"][:, n] > -pars.tol_feas) & (w["dec"] > tol)
                   & ~w["stalled"])
            act_h = act.cpu()    # the loop test: one host read a step
            n_act = int(act_h.sum())
            if n_act == 0:
                break
            if n_act <= act.numel() // 2:
                if idx is not None:
                    z_all = z_all.index_copy(0, idx, w["z"])
                    it_all = it_all.index_copy(0, idx, w["it"])
                else:
                    z_all, it_all = w["z"], w["it"]
                pos = torch.nonzero(act_h).flatten().to(dev)
                idx = pos if idx is None else idx[pos]
                w = {k: v[pos] if k in per_instance else v
                     for k, v in w.items()}
                act = act[pos]
            zn, decn, stn = newton_step(w["t"], w["z"], w["ub"], w["c0"],
                                        w["J"], w["JJ"])
            w["z"] = torch.where(act[:, None], zn, w["z"])
            w["dec"] = torch.where(act, decn, w["dec"])
            w["stalled"] = torch.where(act, stn, w["stalled"])
            w["it"] = w["it"] + act.to(torch.long)
        if idx is None:
            return w["z"], w["it"]
        return (z_all.index_copy(0, idx, w["z"]),
                it_all.index_copy(0, idx, w["it"]))

    go = outer_cond(z, t, it_out)
    while bool(go.any()):
        z, it = inner_solve(t, z, go)
        n_newton = n_newton + it
        t = torch.where(go, pars.mu * t, t)
        it_out = it_out + go.to(torch.long)
        go = go & outer_cond(z, t, it_out)
    x = z[:, :n]
    return FeasibilityReport(
        x=x, s_max=z[:, n], slacks=z[:, n:],
        strictly_feasible=cnts.satisfied_strictly(x),
        eq_error=torch.zeros(B, dtype=dtype, device=dev), iters=n_newton)


def phase1_simple(cnts: ConstraintSet, x0, pars: SolverParams | None = None,
                  early_exit: bool = True) -> FeasibilityReport:
    """Basic phase-I without equalities: minimize the shared slack s.

    ``early_exit`` ends the inner Newton solves as soon as s < 0.
    All-linear sets take the exact low-rank solver; sets with quadratic or
    nonlinear blocks the generic barrier."""
    pars = pars or SolverParams()
    if all(isinstance(b, LinearBlock) for b in cnts.blocks):
        return _phase1_linear_structured(cnts, x0, pars)
    pars = dataclasses.replace(pars, kkt_method=pars.phase1_kkt_method)
    n = cnts.dim
    lifted = cnts.lift_phase1()
    xs0 = cnts.phase1_feasible_point(x0)
    obj = _slack_objective(n, xs0.dtype, xs0.device)

    def stop_inner(xs):
        return xs[:, n] < -pars.tol_feas

    sol = barrier_solve(obj, lifted, xs0, pars,
                        criterion=phase1_criterion(pars),
                        stop_inner=stop_inner if early_exit else None)
    x, s = sol.x[:, :n], sol.x[:, n]
    return FeasibilityReport(
        x=x, s_max=s, slacks=s[:, None],
        strictly_feasible=cnts.satisfied_strictly(x),
        eq_error=torch.zeros_like(s), iters=sol.iters)


def phase1_with_eqs_as_ineqs(cnts: ConstraintSet, eqs: EqualityConstraint,
                             x0, pars: SolverParams | None = None
                             ) -> FeasibilityReport:
    """Equalities as +/- inequalities with tolerance ``phase1_eq_tol``,
    then the simple analysis (ConstraintSet.scala:326-347)."""
    pars = pars or SolverParams()
    ext = cnts.add_blocks(eqs.as_inequalities(pars.phase1_eq_tol))
    rep = phase1_simple(ext, x0, pars)
    eq_err = eqs.error(rep.x)
    return FeasibilityReport(
        x=rep.x, s_max=rep.s_max, slacks=rep.slacks,
        strictly_feasible=(cnts.satisfied_strictly(rep.x)
                           & (eq_err < _eq_tol(pars, rep.x.dtype))),
        eq_error=eq_err, iters=rep.iters)


def phase1_by_reduction(cnts: ConstraintSet, eqs: EqualityConstraint, x0,
                        pars: SolverParams | None = None
                        ) -> FeasibilityReport:
    """Eliminate A x = b via x = z0 + F u and analyze in u
    (ConstraintSet.scala:424-477): exact, one QR for shared equalities."""
    pars = pars or SolverParams()
    ss = eqs.solution_space()
    rep_u = phase1_simple(cnts.affine_pullback(ss.z0, ss.F),
                          ss.parameter(x0), pars)
    x = ss.point(rep_u.x)
    eq_err = eqs.error(x)
    return FeasibilityReport(
        x=x, s_max=rep_u.s_max, slacks=rep_u.slacks,
        strictly_feasible=(cnts.satisfied_strictly(x)
                           & (eq_err < _eq_tol(pars, x.dtype))),
        eq_error=eq_err, iters=rep_u.iters)


def phase1_soi(cnts: ConstraintSet, x0, pars: SolverParams | None = None,
               eqs: EqualityConstraint | None = None) -> FeasibilityReport:
    """Sum-of-infeasibilities: minimize sum_i s_i with one slack per
    constraint (ConstraintSet.scala:511-545); when infeasible, the slacks
    localize the violated constraints."""
    pars = pars or SolverParams()
    n, p = cnts.dim, cnts.m
    lifted = cnts.lift_soi()
    xs0 = cnts.soi_feasible_point(x0)
    dtype, dev = xs0.dtype, xs0.device
    a = torch.cat([torch.zeros((n,), dtype=dtype, device=dev),
                   torch.ones((p,), dtype=dtype, device=dev)])
    obj = LinearObjective(a=a, r=torch.zeros((), dtype=dtype, device=dev))
    eqs_l = eqs.lift_phase1(extra=p) if eqs is not None else None
    sol = barrier_solve(obj, lifted, xs0, pars, eqs=eqs_l)
    x, s = sol.x[:, :n], sol.x[:, n:]
    eq_err = (eqs.error(x) if eqs is not None
              else torch.zeros(x.shape[0], dtype=dtype, device=dev))
    return FeasibilityReport(
        x=x, s_max=torch.amax(s, dim=-1), slacks=s,
        strictly_feasible=(cnts.satisfied_strictly(x)
                           & (eq_err < _eq_tol(pars, dtype))),
        eq_error=eq_err, iters=sol.iters)


def feasibility_analysis(cnts: ConstraintSet, x0,
                         pars: SolverParams | None = None,
                         eqs: EqualityConstraint | None = None,
                         method: str = "auto") -> FeasibilityReport:
    """Dispatch like ConstraintSet.phase_I_Analysis (:404-413).  method:
    "auto" (reduction with equalities, else simple), "simple",
    "eqs_as_ineqs", "reduction", "soi"."""
    pars = pars or SolverParams()
    if method == "soi":
        return phase1_soi(cnts, x0, pars, eqs)
    if eqs is None:
        return phase1_simple(cnts, x0, pars)
    if method in ("auto", "reduction"):
        return phase1_by_reduction(cnts, eqs, x0, pars)
    if method in ("simple", "eqs_as_ineqs"):
        return phase1_with_eqs_as_ineqs(cnts, eqs, x0, pars)
    raise ValueError(f"unknown phase-I method: {method!r}")


def find_feasible_point(cnts: ConstraintSet, x0,
                        pars: SolverParams | None = None,
                        eqs: EqualityConstraint | None = None,
                        method: str = "auto"):
    """Host gate: strictly feasible points (B, n), or InfeasibleProblemError
    when any instance is not feasible (ConstraintSet.scala:556-575); the
    listing names the first such instance's violations."""
    pars = pars or SolverParams()
    report = feasibility_analysis(cnts, x0, pars, eqs, method)
    ok = report.is_feasible(_eq_tol(pars, report.x.dtype))
    if not bool(ok.all()):
        i = int(torch.nonzero(~ok)[0, 0])
        raise InfeasibleProblemError(
            report, violations=report.violations(cnts, i=i))
    return report.x
