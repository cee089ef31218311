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
from cvx_tpu_torch.ops.kl_dual import _stalled, kl_dual_fused_cert_plain

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
