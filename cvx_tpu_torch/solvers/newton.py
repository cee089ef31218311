"""Damped-Newton minimization over an open convex set, batched.

Counterpart of ``cvx_tpu/solvers/newton.py`` (cvx/UnconstrainedSolver.
scala:22-209, cvx/EqualityConstrainedSolver.scala:18-170): the inner
engines of the barrier method.  The reference runs one instance in a
``lax.while_loop`` and is vmapped; here the instances are a leading axis
and the loop is masked: an instance whose loop has ended keeps its state,
and the loop runs while any instance is still in it, so each instance
gets the iterates, ``iters`` and flags of its own unbatched run.  The one
host read per iteration is that loop test.

Line search: every candidate step beta^k, k < ls_max_steps (exponents
compressed past 32), is tried at once and the largest acceptable one
wins: inside the set, finite, and Armijo f(x + t d) <= f + alpha t g.d.
A failed factorization gives a non-finite step, and the iterate is kept
by a true select.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..ops._batch import lead, mv
from ..ops.kkt import kkt_solve, sym_solve
from ..tree import exact_f32
from .types import NewtonResult, SolverParams


def ls_steps(pars: SolverParams, count: int, dtype, device):
    """beta^expo with expo = k for k < 32, then 32 + 3 (k - 32): the
    reference's candidate ladder (newton.py:56)."""
    kk = torch.arange(count, device=device)
    expo = torch.where(kk < 32, kk, 32 + 3 * (kk - 32)).to(dtype)
    return pars.beta ** expo


def _tol(pars, dtype):
    """max(tol, 50 eps): 1e-8 is below f32's resolution of the decrement."""
    return max(pars.tol, 50.0 * torch.finfo(dtype).eps)


def _by_candidate(fgh):
    """A value function over candidates (B, L, n) from ``fgh`` on (B, n),
    one candidate column at a time."""
    def value_fn(xs):
        return torch.stack([fgh(xs[:, j])[0] for j in range(xs.shape[1])],
                           dim=1)
    return value_fn


def _candidates(x, d, ts):
    return x[:, None, :] + ts[:, None] * d[:, None, :]


def _first(accept, ts):
    """(largest accepted t, any accepted) per instance."""
    idx = torch.argmax(accept.to(torch.int8), dim=1)
    return ts[idx], accept.any(dim=1)


def _no_stop(x):
    return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)


@dataclass
class NewtonProblem:
    """One inner solve's functions of points: ``fgh`` at (B, n), ``value_fn``
    at candidates (B, L, n), ``in_set`` and ``stop_fn`` at either, and the
    equality rows ``A`` (p, n) or (B, p, n), ``b`` (p,) or (B, p) of
    ``newton_minimize_eq``."""

    fgh: Callable
    in_set: Callable
    value_fn: Callable
    stop_fn: Callable
    A: torch.Tensor | None = None
    b: torch.Tensor | None = None

    def eq_diff(self, x):
        return lead(self.b, 1, x) - mv(self.A, x)


_RESULT = ("x", "dec", "ngrad", "eq_err", "it", "stalled")


def _cond(P, s, pars, tol, eq):
    opt = (s["dec"] > tol) & (s["ngrad"] > tol)
    if eq:
        opt = opt | (s["eq_err"] > tol)
    return (opt & (s["it"] < pars.max_iter) & ~s["stalled"]
            & ~P.stop_fn(s["x"]))


def _step(P, s, go, pars, tol, ts, eq):
    """One Newton step for the instances ``go`` of the state ``s``; the
    others keep theirs."""
    x, f, g, H = s["x"], s["f"], s["g"], s["H"]
    if eq:
        r = P.eq_diff(x)
        d, _, _ = kkt_solve(H, P.A, g, r, method=pars.kkt_method,
                            refine=pars.kkt_refine, delta=pars.chol_delta,
                            tol=pars.tol_eq_solve)
    else:
        # always-regularized solve (the reference's choleskySolve -> +1e-9
        # I -> symSolve ladder, UnconstrainedSolver.scala:54-67)
        d, _ = sym_solve(H, -g, method=pars.kkt_method,
                         refine=pars.kkt_refine, delta=pars.chol_delta,
                         tol=pars.tol_eq_solve)
    q = (d * g).sum(dim=-1)
    dec_n = -q / 2.0
    descent = dec_n > tol
    xt = _candidates(x, d, ts)
    ft = P.value_fn(xt)
    ok = P.in_set(xt) & torch.isfinite(ft)
    armijo = ft <= f[:, None] + pars.alpha * ts * q[:, None]
    if eq:
        # step for optimality OR feasibility progress; a pure feasibility
        # step is taken only if it shrinks ||Ax - b|| (else the residual is
        # at its floor and the instance stalls out)
        eq_err0 = torch.linalg.vector_norm(r, dim=-1)
        take = descent | (eq_err0 > tol)
        eq_improves = (torch.linalg.vector_norm(P.eq_diff(xt), dim=-1)
                       <= (1.0 - pars.alpha * ts) * eq_err0[:, None])
        accept = ok & torch.where(descent[:, None], armijo, eq_improves)
    else:
        take = descent
        accept = ok & armijo
    t, accepted = _first(accept, ts)
    # a failed factorization gives a non-finite step: keep x by a true
    # select (a blend would turn it into NaN through 0 * inf)
    accepted = accepted & torch.all(torch.isfinite(d), dim=-1)
    move = go & take & accepted
    x = torch.where(move[:, None], x + t[:, None] * d, x)
    f, g, H = P.fgh(x)
    out = dict(x=x, f=f, g=g, H=H,
               dec=torch.where(go, dec_n, s["dec"]),
               ngrad=torch.where(go, torch.linalg.vector_norm(g, dim=-1),
                                 s["ngrad"]),
               it=s["it"] + go.to(torch.long),
               stalled=torch.where(go, take & ~accepted, s["stalled"]))
    out["eq_err"] = (torch.where(go, torch.linalg.vector_norm(
        P.eq_diff(x), dim=-1), s["eq_err"]) if eq else s["eq_err"])
    return out


def _scatter(out, work, idx):
    if idx is None:
        return {k: work[k] for k in _RESULT}
    return {k: out[k].index_copy(0, idx, work[k]) for k in _RESULT}


def _run(P: NewtonProblem, x0, pars, active, restrict, eq) -> NewtonResult:
    """The masked Newton loop over the instances ``active`` (None: all;
    the others are left as they are).  Once at most half of the instances
    being stepped are still in the loop, and ``restrict(idx)`` gives the
    problem of the instances ``idx`` (a long tensor; None where it cannot),
    the loop goes on with those alone: the stragglers of a large batch
    then cost what they need."""
    dtype, dev = x0.dtype, x0.device
    B = x0.shape[0]
    tol = _tol(pars, dtype)
    ts = ls_steps(pars, pars.ls_max_steps, dtype, dev)
    x = x0
    f, g, H = P.fgh(x)
    nan = torch.full((B,), math.nan, dtype=dtype, device=dev)
    work = dict(x=x, f=f, g=g, H=H,
                dec=torch.full((B,), math.inf, dtype=dtype, device=dev),
                ngrad=torch.linalg.vector_norm(g, dim=-1),
                eq_err=(torch.linalg.vector_norm(P.eq_diff(x), dim=-1)
                        if eq else nan),
                it=torch.zeros(B, dtype=torch.long, device=dev),
                stalled=torch.zeros(B, dtype=torch.bool, device=dev))
    go = torch.ones(B, dtype=torch.bool, device=dev) if active is None \
        else active
    go = go & _cond(P, work, pars, tol, eq)
    idx, out = None, None
    while True:
        go_h = go.cpu()          # the loop test: one host read a step
        n_go = int(go_h.sum())
        if n_go == 0:
            break
        if restrict is not None and n_go <= go.numel() // 2:
            pos = torch.nonzero(go_h).flatten().to(dev)
            new_idx = pos if idx is None else idx[pos]
            Pn = restrict(new_idx)
            if Pn is None:
                restrict = None
            else:
                out = _scatter(out, work, idx)
                work = {k: v[pos] for k, v in work.items()}
                go, idx, P = go[pos], new_idx, Pn
        work = _step(P, work, go, pars, tol, ts, eq)
        go = go & _cond(P, work, pars, tol, eq)
    out = _scatter(out, work, idx)
    return NewtonResult(x=out["x"], newton_decrement=out["dec"],
                        norm_grad=out["ngrad"], eq_gap=out["eq_err"],
                        iters=out["it"], maxed_out=out["it"] >= pars.max_iter,
                        stalled=out["stalled"])


@exact_f32
def newton_minimize(fgh: Callable, in_set: Callable, x0, pars: SolverParams,
                    stop_fn: Callable | None = None,
                    value_fn: Callable | None = None) -> NewtonResult:
    """Minimize f over the open set C by damped Newton, per instance.

    ``fgh(x) -> (f (B,), g (B, n), H (B, n, n))`` at points (B, n);
    ``in_set(x)`` the strict-membership predicate and ``value_fn(x)`` the
    value at candidate points (B, L, n) (default: ``fgh`` on one candidate
    column at a time); ``stop_fn(x) -> bool (B,)`` ends an instance early
    (phase-I).  Loop test (UnconstrainedSolver.scala:47): iter < maxIter
    and decrement > tol and |grad| > tol.
    """
    P = NewtonProblem(fgh=fgh, in_set=in_set,
                      value_fn=value_fn or _by_candidate(fgh),
                      stop_fn=stop_fn or _no_stop)
    return _run(P, x0, pars, None, None, eq=False)


@exact_f32
def newton_minimize_eq(fgh: Callable, in_set: Callable, x0, A, b,
                       pars: SolverParams, stop_fn: Callable | None = None,
                       value_fn: Callable | None = None) -> NewtonResult:
    """Newton with equality constraints A x = b, infeasible start allowed
    (EqualityConstrainedSolver.scala:49-99): steps solve the KKT system
    [[H, A^T], [A, 0]] (d, w) = (-g, b - A x).  A (p, n) shared or
    (B, p, n), b (p,) or (B, p).  Loop test: (decrement > tol and |grad| >
    tol) or ||Ax - b|| > tol.  Arguments otherwise as ``newton_minimize``.
    """
    P = NewtonProblem(fgh=fgh, in_set=in_set,
                      value_fn=value_fn or _by_candidate(fgh),
                      stop_fn=stop_fn or _no_stop, A=A, b=b)
    return _run(P, x0, pars, None, None, eq=True)
