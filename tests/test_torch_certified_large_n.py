"""The certified 1e-8 contract of ``cvx_tpu_torch`` on its plain (CPU)
path, at the flagship n = 100 and at n = 1,000 and n = 10,000.

Contract tests: no reference run.  Each mirrors a test of the JAX package
and holds the port to the same bounds: a measured duality gap in [-1e-12,
1e-8] (SolverParams.scala:41, one tolerance with no n in it), measured
residuals <= 1e-10, nothing stalled.  ``device="cpu"`` runs the kernels'
plain versions: the auto route is K2's algebra (f32 solve, f64 polish and
certificate), ``fused_cert=False`` K1's plus the f64 finishing pass.
"""

import numpy as np
import pytest
import torch

from cvx_tpu_torch import DistKL

GAP_HI, GAP_LO, RES = 1e-8, -1e-12, 1e-10


def _scenario(n):
    """P(A) >= pA with |A| = 3, P(B) <= pB with B the upper half
    (tests/test_round3.py::_scenario)."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    return torch.tensor(np.stack([-I_A, I_B]), dtype=torch.float32)


def _fleet(n, pA, pB):
    """The problem and the (B, 2) bounds u = (-pA, pB) in f32."""
    prob = DistKL.create(n, H=_scenario(n), u=torch.zeros(2), device="cpu")
    u = torch.tensor(np.column_stack([-pA, pB]), dtype=torch.float32)
    return prob, u


def _holds(sol, gap_hi=GAP_HI):
    gap = sol.duality_gap
    assert sol.x.dtype == torch.float64
    assert float(gap.max()) <= gap_hi and float(gap.min()) >= GAP_LO, (
        float(gap.min()), float(gap.max()))
    assert float(sol.ineq_res.max()) <= RES
    assert float(sol.eq_gap.max()) <= RES
    assert not bool(sol.stalled.any())


class TestCertified1e8:
    """tests/test_round3.py::TestCertified1e8 at n = 100."""

    def test_single_instance_certified(self):
        # mirrors test_single_instance_certified
        prob = DistKL.create(100, H=_scenario(100),
                             u=torch.tensor([-0.4, 0.7]), device="cpu")
        _holds(prob.solve(method="dual_fused_cert"))

    def test_batched_certified_contract(self):
        # mirrors test_batched_certified_contract: 128 varied instances
        # (active and inactive constellations) through the route that
        # solve_certified takes, K1 plus the f64 finishing pass
        prob, u = _fleet(100, np.linspace(0.05, 0.5, 128),
                         np.linspace(0.45, 0.95, 128))
        sol = prob.solve_certified_batch(u, fused_cert=False)
        assert tuple(sol.x.shape) == (128, 100)
        _holds(sol)

    def test_batched_certified_entry(self):
        # mirrors test_batched_certified_entry: the production shape, one
        # K2 call over the batch
        prob, u = _fleet(100, np.linspace(0.05, 0.5, 64),
                         np.linspace(0.45, 0.95, 64))
        sol = prob.solve_certified_batch(u)
        assert tuple(sol.x.shape) == (64, 100)
        _holds(sol)


class TestCertifiedShapeIndependent:
    """tests/test_round4.py::TestCertifiedShapeIndependent."""

    @pytest.mark.parametrize("fused_cert", [None, False],
                             ids=["auto", "k1_f64_finish"])
    @pytest.mark.parametrize("n,B", [(1000, 4), (10000, 2)])
    def test_certified_contract_large_n(self, n, B, fused_cert):
        # mirrors test_certified_contract_large_n (_kl_fixture's bounds),
        # on both certified routes
        prob, u = _fleet(n, np.linspace(0.25, 0.45, B),
                         np.linspace(0.6, 0.75, B))
        sol = prob.solve_certified_batch(u, fused_cert=fused_cert)
        assert tuple(sol.x.shape) == (B, n)
        _holds(sol)

    def test_two_polish_steps_suffice_from_f32_start(self):
        # mirrors test_two_polish_steps_suffice_from_f32_start: from the
        # f32 solve's ~1e-5..1e-6 start two f64 Newton steps land far below
        # the contract, and a third buys nothing beyond the rounding floor
        prob, u = _fleet(1000, np.linspace(0.25, 0.45, 4),
                         np.linspace(0.6, 0.75, 4))
        s2 = prob.solve_certified_batch(u, polish_steps=2)
        s3 = prob.solve_certified_batch(u, polish_steps=3)
        _holds(s2, gap_hi=1e-10)
        g2 = float(s2.duality_gap.abs().max())
        assert float(s3.duality_gap.abs().max()) <= max(1e-12, 10 * g2)
