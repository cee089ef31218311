"""The certified route's per-instance Solution leaves.

K2 writes them in its epilogue (the stall flag by ``_stalled``'s rule, the
shared NaN leaf, ``iters`` and ``maxed_out``), so that a certified call on
the card launches K2 alone; its plain version returns the same extra
outputs, made by ``_stalled`` and the fills.  On the CPU, where the route
runs that plain version:

* ``kl_dual_fused_cert_plain``'s leaves equal ``_stalled`` on its own x,
  gap and residuals, and the fills;
* ``solve_certified_batch`` returns every Solution leaf equal in value and
  dtype to the torch rule applied to the same certificate
  (``_cert_solution`` without leaves), with one NaN tensor shared by the
  three leaves no certified route measures;

on feasible bounds, an infeasible instance (its gap runs to -inf), a gap
exactly at ``pars.tol`` and just above it, and a NaN planted in x where the
gap and residuals stay finite.  The card's own check of the kernel's flag
is ``tests/test_torch_cuda.py``.
"""

import math

import pytest
import torch

from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.models import dist_kl
from cvx_tpu_torch.ops import kl_dual
from cvx_tpu_torch.ops.kl_barrier import fused_final_t, fused_n_outer
from cvx_tpu_torch.ops.kl_dual import _stalled, kl_dual_fused_cert_plain
from cvx_tpu_torch.solvers.types import Solution

# one torch thread a test process (see test_torch_api_utilities.py)
torch.set_num_threads(1)

N = 12
# P(A) >= -u_0 on the first 3 outcomes, P(B) <= u_1 on the last 6:
# instances 0 and 3 feasible, 1 infeasible (P(B) <= -0.1), 2 feasible
U = torch.tensor([[-0.3, 0.7], [-0.3, -0.1], [-0.95, 0.01], [-0.4, 0.75]])
CASES = ["feasible", "infeasible", "gap_at_tol", "gap_above_tol",
         "nan_in_x"]


def _model():
    H = torch.zeros((2, N))
    H[0, :3] = -1.0
    H[1, N // 2:] = 1.0
    return DistKL.create(N, H=H, u=U[0], device="cpu")


def _case(case, monkeypatch):
    """(bounds, pars) of a case; ``nan_in_x`` plants a NaN in instance 3's
    x where the certificate is made, its gap and residuals unchanged."""
    u = U[[0, 2, 3]] if case == "feasible" else U
    pars = SolverParams()
    if case in ("gap_at_tol", "gap_above_tol"):
        g = abs(float(_model().solve_certified_batch(u).duality_gap[0]))
        pars = SolverParams(tol=g if case == "gap_at_tol"
                            else math.nextafter(g, -math.inf))
    if case == "nan_in_x":
        certify = kl_dual._certify_f64

        def planted(ctx, z):
            x, *rest = certify(ctx, z)
            x = x.clone()
            x[3, 5] = math.nan
            return (x, *rest)

        monkeypatch.setattr(kl_dual, "_certify_f64", planted)
    return u, pars


@pytest.mark.parametrize("case", CASES)
def test_plain_leaves_are_the_stall_rule_and_the_fills(case, monkeypatch):
    u, pars = _case(case, monkeypatch)
    H = _model().H
    x, z, gap, ineq, eq, stalled, nan, iters, maxed = \
        kl_dual_fused_cert_plain(H[None].expand(len(u), -1, -1), u,
                                 tol=pars.tol, tol_feas=pars.tol_feas)
    want = _stalled(x, gap, ineq, pars.tol, pars.tol_feas, eq=eq)
    assert stalled.dtype == torch.bool and torch.equal(stalled, want)
    assert nan.dtype == torch.float64 and bool(torch.isnan(nan).all())
    assert iters.dtype == torch.int64 and bool((iters == 18).all())
    assert maxed.dtype == torch.bool and not bool(maxed.any())
    # the instance each case is about, and its flag
    b, flag = {"feasible": (slice(None), False), "infeasible": (1, True),
               "gap_at_tol": (0, False), "gap_above_tol": (0, True),
               "nan_in_x": (3, True)}[case]
    assert bool((stalled[b] == flag).all())
    if case == "infeasible":
        assert float(gap[1]) < -1.0
    if case == "nan_in_x":
        assert bool(torch.isfinite(gap[3])) and float(ineq[3]) <= 1e-7


@pytest.mark.parametrize("case", CASES)
def test_certified_solution_leaves_are_the_torch_rule(case, monkeypatch):
    u, pars = _case(case, monkeypatch)
    sol = _model().solve_certified_batch(u, pars=pars)
    cert = dist_kl.KLCertificate(x=sol.x, gap=sol.duality_gap,
                                 ineq_res=sol.ineq_res, eq_res=sol.eq_gap,
                                 lam=sol.lam, nu=sol.nu)
    want = dist_kl._cert_solution(cert, pars, 18)
    for name in ("stalled", "iters", "maxed_out", "newton_decrement",
                 "norm_grad", "norm_dual_residual"):
        got, ref = getattr(sol, name), getattr(want, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    assert sol.newton_decrement is sol.norm_grad is sol.norm_dual_residual


# ---------------------------------------------------------------------------
# Every KL batched route's Solution, leaf by leaf, against its assembly
# written out here: each route's arrays, then the NaN leaf, iters, maxed_out,
# eq_gap and the stall rule as the route sets them.
F32_PARS = SolverParams(max_iter=3, mu=55.0, tol=1e-8)
NAN_LEAVES = ("newton_decrement", "norm_grad", "norm_dual_residual")
LEAVES = ("x", "lam", "nu", "duality_gap", "eq_gap", "ineq_res", "iters",
          "maxed_out", "stalled") + NAN_LEAVES


def _past16():
    """A model of dual dim 17: ``_model``'s two rows and 14 loose ones."""
    H = torch.zeros((16, N))
    H[0, :3] = -1.0
    H[1, N // 2:] = 1.0
    H[2 + torch.arange(14), torch.arange(14) % N] = 1.0     # x_j <= 0.9
    return DistKL.create(N, H=H, u=torch.full((16,), 0.9), device="cpu")


def _u16(u):
    return torch.cat([u, torch.full((len(u), 14), 0.9)], dim=1)


def _x0(u):
    """Positive starts summing to one; strictly feasible where the bounds
    allow: weight -u_A + 0.05 on the first 3 outcomes."""
    w = torch.clamp(-u[:, :1] + 0.05, 0.1, 0.9)
    inside = torch.zeros(N, dtype=u.dtype)
    inside[:3] = 1.0
    return (w / 3) * inside + ((1 - w) / (N - 3)) * (1 - inside)


def _nan_of(m, B):
    return torch.full((B,), math.nan, dtype=m.H.dtype, device=m.H.device)


def _sqrt_eps(x):
    return math.sqrt(torch.finfo(x.dtype).eps)


def _written_dual_newton(m, u, pars, steps=30, r=None):
    d = m.neg_dual_objective(u, r)
    k, B = m.num_ineq_dual, u.shape[0]
    z0 = torch.full((B, m.dual_dim), pars.dual_start, dtype=m.H.dtype)
    z = dist_kl._polish_dual(d, z0, num_ineq=k, steps=steps)
    y = d._y(z)
    x = y / torch.sum(y, dim=-1, keepdim=True)
    gap = m.objective.value(x) + d.value(z)
    ineq = m._ineq_res(x, u)
    tol = _sqrt_eps(x)
    nan = _nan_of(m, B)
    return Solution(
        x=x, lam=z[:, :k], nu=z[:, k:], newton_decrement=nan,
        duality_gap=gap, eq_gap=torch.abs(torch.sum(x, dim=-1) - 1.0),
        norm_grad=torch.linalg.vector_norm(d.grad(z), dim=-1),
        norm_dual_residual=nan, iters=torch.full((B,), steps),
        maxed_out=torch.zeros(B, dtype=torch.bool),
        stalled=_stalled(x, gap, ineq, tol, tol), ineq_res=ineq)


def _written_dual_fused(m, u, pars, steps=16, r=None):
    k, m_eq = m.H.shape[0], m.A.shape[0]
    if k + m_eq < 1 or k + 1 + m_eq > 16:
        return _written_dual_newton(m, u, pars, r=r)
    B = u.shape[0]
    x, gap, z = dist_kl.kl_dual_fused(
        m.H[None].expand(B, k, m.n), u, None, None, log_prior=None,
        n_steps=steps, z0=float(pars.dual_start))
    tol = _sqrt_eps(x)
    ineq = m._ineq_res(x, u)
    nan = _nan_of(m, B)
    return Solution(
        x=x, lam=z[:, :k], nu=z[:, k:], newton_decrement=nan,
        duality_gap=gap, eq_gap=torch.abs(torch.sum(x, dim=-1) - 1.0),
        norm_grad=nan, norm_dual_residual=nan,
        iters=torch.full((B,), steps),
        maxed_out=torch.zeros(B, dtype=torch.bool),
        stalled=_stalled(x, gap, ineq, tol, tol), ineq_res=ineq)


def _written_cert(x, z, gap, ineq, eq, k, pars, steps, leaves=None):
    if leaves is None:
        leaves = (_stalled(x, gap, ineq, pars.tol, pars.tol_feas, eq=eq),
                  torch.full(gap.shape, math.nan, dtype=torch.float64),
                  torch.full(gap.shape, steps),
                  torch.zeros(gap.shape, dtype=torch.bool))
    stalled, nan, iters, maxed = leaves
    return Solution(
        x=x, lam=z[:, :k], nu=z[:, k:], newton_decrement=nan,
        duality_gap=gap, eq_gap=eq, norm_grad=nan, norm_dual_residual=nan,
        iters=iters, maxed_out=maxed, stalled=stalled, ineq_res=ineq)


def _written_certified(m, u, pars, fused_cert=None):
    k, B = m.H.shape[0], u.shape[0]
    fits = k + 1 <= 16
    if fused_cert is None:
        fused_cert = fits and m.H.dtype == torch.float32
    if fused_cert:
        x, z, gap, ineq, eq, *leaves = dist_kl.kl_dual_fused_cert(
            m.H[None].expand(B, k, m.n), u, None, None,
            log_prior=m._log_prior64, n_steps=16, polish_steps=2,
            z0=float(pars.dual_start), tol=pars.tol, tol_feas=pars.tol_feas)
        return _written_cert(x, z, gap, ineq, eq, k, pars, 18, leaves)
    steps = 16 if fits else 30
    sol = (_written_dual_fused if fits else _written_dual_newton)(
        m, u, pars, steps)
    b = torch.cat([u.new_ones((B, 1)), m.r[None].expand(B, 0)], dim=1)
    c = dist_kl.kl_certify(m.H, u, m.equalities.A, b, sol.x,
                           z0=torch.cat([sol.lam, sol.nu], 1),
                           polish_steps=2, prior=m.prior,
                           compare_input=False)
    return _written_cert(c.x, torch.cat([c.lam, c.nu], 1), c.gap,
                         c.ineq_res, c.eq_res, k, pars, steps + 2)


def _written_fused(m, u, x0, pars):
    k, n, B = m.H.shape[0], m.n, u.shape[0]
    ones = torch.ones((1, 1, n), dtype=m.H.dtype)
    n_inner = min(int(pars.max_iter), 8)
    x = dist_kl.kl_barrier_fused(
        m.H[None].expand(B, k, n), u, ones.expand(B, 1, n),
        ones[0, :, :1].expand(B, 1), x0, mu=float(pars.mu),
        tol=float(pars.tol), n_inner=n_inner)
    n_outer = fused_n_outer(k + n, mu=float(pars.mu), tol=float(pars.tol))
    t_final = fused_final_t(k + n, mu=float(pars.mu), tol=float(pars.tol),
                            n_outer=n_outer)
    gap, z = dist_kl.kl_dual_gap(m.H, u, ones[0],
                                 ones[0, :, :1].expand(B, 1), x,
                                 prior=m.prior)
    eps = torch.finfo(x.dtype).eps
    ineq = m._ineq_res(x, u)
    nan = _nan_of(m, B)
    return Solution(
        x=x, lam=torch.cat([z[:, :k], 1.0 / (t_final * x)], dim=1),
        nu=z[:, k:], newton_decrement=nan, duality_gap=gap,
        eq_gap=torch.abs(torch.sum(x, dim=-1) - 1.0), norm_grad=nan,
        norm_dual_residual=nan, iters=torch.full((B,), n_outer * n_inner),
        maxed_out=torch.zeros(B, dtype=torch.bool),
        stalled=_stalled(x, gap, ineq, math.sqrt(eps), math.sqrt(eps)),
        ineq_res=ineq)


def _f64_model():
    m = _model()
    return DistKL.create(N, H=m.H.double(), u=m.u.double(), device="cpu")


# route -> (model, its call, its written-out assembly, where a NaN is
# planted in x: (module, function, position of x in its outputs))
ROUTES = {
    "certified": (_model, lambda m, u: m.solve_certified_batch(u),
                  lambda m, u: _written_certified(m, u, SolverParams()),
                  (kl_dual, "_certify_f64", 0)),
    "certified_fused_cert_false": (
        _model, lambda m, u: m.solve_certified_batch(u, fused_cert=False),
        lambda m, u: _written_certified(m, u, SolverParams(), False),
        (dist_kl, "_certify_f64", 0)),
    "certified_f64": (_f64_model,
                      lambda m, u: m.solve_certified_batch(u.double()),
                      lambda m, u: _written_certified(m, u.double(),
                                                      SolverParams()),
                      (dist_kl, "_certify_f64", 0)),
    "certified_past_dim16": (
        _past16, lambda m, u: m.solve_certified_batch(_u16(u)),
        lambda m, u: _written_certified(m, _u16(u), SolverParams()),
        (dist_kl, "_certify_f64", 0)),
    "dual_fast": (_model, lambda m, u: m.solve_jittable_batch(
        u, None, method="dual_fast"),
        lambda m, u: _written_dual_newton(m, u, SolverParams()),
        (dist_kl, "_polish_dual", None)),
    "dual_fused": (_model, lambda m, u: m.solve_jittable_batch(
        u, None, method="dual_fused"),
        lambda m, u: _written_dual_fused(m, u, SolverParams()),
        (dist_kl, "kl_dual_fused", 0)),
    "dual_fused_cert": (_model, lambda m, u: m.solve_jittable_batch(
        u, None, method="dual_fused_cert"),
        lambda m, u: _written_certified(m, u, SolverParams(), False),
        (dist_kl, "_certify_f64", 0)),
    "fused": (_model, lambda m, u: m.solve_jittable_batch(
        u, _x0(u), method="fused", pars=F32_PARS),
        lambda m, u: _written_fused(m, u, _x0(u), F32_PARS),
        (dist_kl, "kl_barrier_fused", None)),
}


def _plant(monkeypatch, module, name, at):
    """A NaN in instance 3's x where ``module.name`` makes it (``at``: the
    position of x among its outputs; None: the output itself, or z for
    ``_polish_dual``, whose instance 3 then has no finite x)."""
    made = getattr(module, name)

    def planted(*args, **kw):
        out = made(*args, **kw)
        x = (out if at is None else out[at]).clone()
        x[3, min(5, x.shape[1] - 1)] = math.nan
        return x if at is None else (*out[:at], x, *out[at + 1:])

    monkeypatch.setattr(module, name, planted)


@pytest.mark.parametrize("case", ["feasible", "infeasible", "nan_in_x"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_kl_route_solution_is_the_written_out_assembly(route, case,
                                                       monkeypatch):
    make, call, written, plant = ROUTES[route]
    u = U[[0, 2, 3, 0]] if case == "feasible" else U
    if case == "nan_in_x":
        _plant(monkeypatch, *plant)
    got, want = call(make(), u), written(make(), u)
    for name in LEAVES:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    for i, a in enumerate(NAN_LEAVES):
        for b in NAN_LEAVES[i + 1:]:
            assert (getattr(got, a) is getattr(got, b)) == \
                (getattr(want, a) is getattr(want, b)), (a, b)
    if case == "infeasible":
        assert bool(got.stalled[1])
    if case == "nan_in_x":
        assert not bool(torch.isfinite(got.x[3]).all()) and \
            bool(got.stalled[3])
