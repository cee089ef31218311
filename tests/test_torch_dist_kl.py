"""Port parity for the model layer: ``cvx_tpu_torch.models.DistKL`` against
``cvx_tpu.models.DistKL`` — the KL zoo through solve(method="dual_fused"),
``create``'s errors, the certified routes (K2 and K1 + the f64 finishing
pass) against the reference's fused_cert=True kernel and its
fused_cert=False route, the infeasible-fleet stall flags, and the warm
``kl_certify``.  Inputs are made with numpy from fixed seeds; the
reference's kernels run in interpret mode, as its own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.models.dist_kl import kl_certify as ref_kl_certify
from cvx_tpu_torch import DistKL, Solution, SolverParams
from cvx_tpu_torch.interop import distkl_from_numpy, solution_to_numpy
from cvx_tpu_torch.models import kl_certify

F64_TOL = 1e-9      # K1 in f64: summation order only
CERT_DX = 1e-11     # certified x: both ends polished to f64 rounding
CERT_DGAP = 1e-10   # certified gaps: both ~1e-14, measured


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float64))
                            ).to(dtype)


def _kl_value(x):
    x = np.maximum(x, 1e-300)
    return float(np.sum(x * np.log(len(x) * x)))


def _zoo(name, n):
    """tests/test_kl.py's zoo (OptimizationProblems.scala:131-405): kl_1 /
    kl_1A are P(A) >= .36, P(B) <= .1 (|A| = 3, B the upper half) at
    n <= 15, where the P(A) row is slack, and at n > 15, where it binds;
    kl_2 / kl_2A the same bounds as equalities; infeasible_kl_1 is
    P(A), P(B) >= .51."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    if name.startswith("kl_1"):
        return dict(H=np.stack([-I_A, I_B]), u=np.array([-0.36, 0.1]))
    if name.startswith("kl_2"):
        return dict(A=np.stack([I_A, I_B]), r=np.array([0.36, 0.1]))
    return dict(H=np.stack([-I_A, -I_B]), u=np.array([-0.51, -0.51]))


def _analytic(name, n):
    """OptimizationProblems.scala:136-141 (kl_1 at n <= 15) and :249-251."""
    x = np.zeros(n)
    x[n // 2:] = 0.2 / n
    if name == "kl_1" and n <= 15:
        x[: n // 2] = 1.8 / n
        return x
    x[:3] = 0.12
    x[3: n // 2] = 1.08 / (n - 6)
    return x


class TestZoo:
    @pytest.mark.timeout(60)
    @pytest.mark.parametrize("name,n", [("kl_1", 10), ("kl_1A", 20),
                                        ("kl_2", 10), ("kl_2A", 20),
                                        ("infeasible_kl_1", 20)])
    def test_dual_fused_matches_reference(self, name, n):
        data = _zoo(name, n)
        ref = RefDistKL.create(n, **{k: jnp.asarray(v)
                                     for k, v in data.items()})
        port = DistKL.create(n, **{k: _t(v) for k, v in data.items()},
                             device="cpu")
        s_ref = ref.solve(method="dual_fused")
        s = port.solve(method="dual_fused")
        x = s.x.numpy()
        assert np.max(np.abs(x - np.asarray(s_ref.x))) <= F64_TOL
        assert bool(s.stalled) == bool(s_ref.stalled)
        assert abs(float(s.duality_gap) - float(s_ref.duality_gap)) <= 1e-8
        if name == "infeasible_kl_1":
            assert bool(s.stalled)          # flagged, never certified
            return
        assert not bool(s.stalled)
        assert abs(_kl_value(x) - _kl_value(_analytic(name, n))) < 1e-2
        if name.startswith("kl_2"):
            assert abs(x[:3].sum() - 0.36) < 1e-4
        else:
            assert x[:3].sum() >= 0.36 - 1e-4
        assert abs(x[n // 2:].sum() - 0.1) < 1e-4
        assert abs(x.sum() - 1.0) < 1e-12

    @pytest.mark.timeout(60)
    @pytest.mark.parametrize("name", ["kl_1A", "kl_2A"])
    def test_dual_fused_cert_matches_reference(self, name):
        # kl_2A has no inequality row (k = 0): the equality system of the
        # f64 finish is then [1'; A] alone
        data = _zoo(name, 20)
        ref = RefDistKL.create(20, **{k: jnp.asarray(v)
                                      for k, v in data.items()})
        port = DistKL.create(20, **{k: _t(v) for k, v in data.items()},
                             device="cpu")
        s_ref = ref.solve(method="dual_fused_cert")
        s = port.solve(method="dual_fused_cert")
        assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) <= CERT_DX
        assert abs(float(s.duality_gap)) <= 1e-8
        assert abs(float(s.duality_gap) - float(s_ref.duality_gap)) \
            <= CERT_DGAP
        assert float(s.eq_gap) <= 1e-10 and float(s.ineq_res) <= 1e-10
        assert bool(s.stalled) == bool(s_ref.stalled) is False


class TestCreate:
    CASES = {
        "H without u": dict(H=np.zeros((1, 8))),
        "A without r": dict(H=np.zeros((1, 8)), u=np.zeros(1),
                            A=np.zeros((1, 8))),
        "no constraint": dict(),
        "wrong columns": dict(H=np.zeros((1, 7)), u=np.zeros(1)),
        "prior shape": dict(H=np.zeros((1, 8)), u=np.zeros(1),
                            prior=np.ones(7)),
        "prior sign": dict(H=np.zeros((1, 8)), u=np.zeros(1),
                           prior=np.r_[np.ones(7), 0.0]),
    }

    @pytest.mark.timeout(30)
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_same_value_errors(self, case):
        kw = self.CASES[case]
        with pytest.raises(ValueError) as ref_err:
            RefDistKL.create(8, **{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError) as err:
            DistKL.create(8, **{k: _t(v) for k, v in kw.items()},
                          device="cpu")
        assert str(err.value) == str(ref_err.value)

    @pytest.mark.timeout(30)
    def test_fields_and_prior(self):
        w = np.random.default_rng(0).uniform(0.5, 2.0, 8)
        kw = dict(H=np.eye(2, 8), u=np.array([0.3, 0.4]), prior=w)
        ref = RefDistKL.create(8, **{k: jnp.asarray(v) for k, v in kw.items()})
        port = DistKL.create(8, **{k: _t(v) for k, v in kw.items()},
                             device="cpu")
        port2 = distkl_from_numpy(ref, device="cpu")
        for p in (port, port2):
            assert p.dual_dim == ref.dual_dim == 3
            assert p.num_ineq_dual == ref.num_ineq_dual == 2
            assert p.H.dtype == torch.float64
            for f in ("H", "u", "A", "r", "prior"):
                assert np.allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-15)
            assert np.allclose(p._R().numpy(), np.asarray(ref._R()),
                               rtol=1e-15, atol=0)
        z = np.array([0.2, 0.0, -1.1])
        d, d_ref = port.neg_dual_objective(), ref.neg_dual_objective()
        for f in ("value", "grad", "hess"):
            assert np.allclose(getattr(d, f)(_t(z)).numpy(),
                               np.asarray(getattr(d_ref, f)(jnp.asarray(z))),
                               rtol=0, atol=1e-14), f
        assert np.allclose(port.primal_optimum(_t(z)).numpy(),
                           np.asarray(ref.primal_optimum(jnp.asarray(z))),
                           rtol=0, atol=1e-15)
        assert DistKL.create(8, H=_t(kw["H"], torch.float32),
                             u=[0.0, 0.0], device="cpu"
                             ).H.dtype == torch.float32

    @pytest.mark.timeout(30)
    def test_default_device_is_the_card(self):
        # no device argument: the card, never a quiet CPU run; without a
        # CUDA device the call raises
        kw = dict(H=np.eye(2, 8), u=np.array([0.3, 0.4]))
        ref = RefDistKL.create(8, **{k: jnp.asarray(v) for k, v in kw.items()})
        calls = (lambda: DistKL.create(8, **kw), lambda: distkl_from_numpy(ref))
        for call in calls:
            if torch.cuda.is_available():
                p = call()
                assert {t.device.type for t in (p.H, p.u, p.A, p.r)} == \
                    {"cuda"}
            else:
                with pytest.raises((RuntimeError, AssertionError)):
                    call()
        assert DistKL.create(8, **kw, device="cpu").H.device.type == "cpu"

    @pytest.mark.timeout(60)
    def test_unported_routes_raise(self):
        # every route of the reference runs on the CPU through the generic
        # core: the methods once left unported return a finite x, with
        # phase-I where no feasible point is given; an unknown method
        # still raises ValueError
        port = DistKL.create(8, **{k: _t(v) for k, v in
                                   dict(H=np.eye(2, 8), u=[0.3, 0.4]).items()},
                             device="cpu")
        sols = [port.solve(method=m) for m in
                ("dual", "dual_BR", "dual_PD", "BR", "PD", "BR_fast", "fused")]
        sols.append(port.solve_jittable(np.full(8, 0.125), method="BR"))
        for s in sols:
            assert s.x.shape == (8,) and bool(torch.isfinite(s.x).all())
            assert abs(float(s.x.sum()) - 1.0) < 1e-6
        with pytest.raises(ValueError, match="unknown method"):
            port.solve(method="nope")
        with pytest.raises(ValueError, match="unknown method"):
            port.solve_jittable(np.full(8, 0.125), method="nope")
        # dual dim 17, past the fused kernels: the dual_fast fallback
        wide = DistKL.create(24, H=_t(np.eye(16, 24)), u=_t(np.ones(16)),
                             device="cpu")
        s = wide.solve(method="dual_fused")
        assert torch.equal(s.x, wide.solve(method="dual_fast").x)
        assert not bool(s.stalled) and int(s.iters) == 30


def _cert_fixture(B=8, n=32, seed=3):
    """tests/test_round4.py::TestFusedCertKernel."""
    I_A = np.zeros(n); I_A[:2] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B]).astype(np.float32)
    rng = np.random.default_rng(seed)
    pA = rng.uniform(0.2, 0.5, B); pB = rng.uniform(0.55, 0.8, B)
    return H, np.stack([-pA, pB], axis=1).astype(np.float32)


class TestCertified:
    @pytest.mark.timeout(120)
    def test_k2_matches_reference_kernel(self):
        n, B = 32, 8
        H, U = _cert_fixture(B, n)
        ref = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.zeros((2,)),
                               dtype=jnp.float32)
        s_ref = ref.solve_certified_batch(jnp.asarray(U), steps=10,
                                          polish_steps=2, fused_cert=True)
        port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(2),
                             device="cpu")
        s = port.solve_certified_batch(torch.from_numpy(U), steps=10,
                                       polish_steps=2, fused_cert=True)
        x, gap = s.x.numpy(), s.duality_gap.numpy()
        assert s.x.dtype == torch.float64
        assert np.max(np.abs(x - np.asarray(s_ref.x))) <= CERT_DX
        assert np.max(np.abs(gap)) <= 1e-10
        assert np.max(np.abs(gap - np.asarray(s_ref.duality_gap))) <= 1e-10
        # the gap is MEASURED: an independent host f64 f(x) - g(z)
        lp = -np.log(np.float64(n))
        Bmat = np.concatenate([H.astype(np.float64), np.ones((1, n))])
        z = np.concatenate([s.lam.numpy(), s.nu.numpy()], axis=1)
        for i in range(B):
            w = np.concatenate([U[i].astype(np.float64), [1.0]])
            g = -(w @ z[i] + np.sum(np.exp(lp - Bmat.T @ z[i] - 1.0)))
            f = np.sum(x[i] * (np.log(np.maximum(x[i], 1e-300)) - lp))
            assert abs((f - g) - gap[i]) < 1e-12
        assert np.max(s.ineq_res.numpy()) < 1e-10
        assert np.max(s.eq_gap.numpy()) < 1e-10
        assert not bool(s.stalled.any())

    @pytest.mark.timeout(120)
    @pytest.mark.parametrize("k,mE", [(7, 0), (11, 0)])
    def test_matches_reference_xla_route(self, k, mE):
        # test_round4.py::test_certified_contract_dim6_8 and
        # test_round5.py::test_certified_contract_dim12_16: the
        # reference's off-TPU auto route is K1 + the XLA f64 finish
        n, B = 24, 3
        rng = np.random.default_rng(1)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        u = H @ x0 + rng.uniform(0.05, 0.15, k)
        U = np.stack([u * s for s in (1.0, 1.05, 1.1)]).astype(np.float32)
        H = H.astype(np.float32)
        ref = RefDistKL.create(n, H=jnp.asarray(H),
                               u=jnp.zeros((k,), jnp.float32),
                               dtype=jnp.float32)
        s_ref = ref.solve_certified_batch(jnp.asarray(U))
        port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(k),
                             device="cpu")
        for fused in (None, False):         # auto = K2; K1 + f64 finish
            s = port.solve_certified_batch(torch.from_numpy(U),
                                           fused_cert=fused)
            assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) \
                <= CERT_DX
            assert np.max(np.abs(s.duality_gap.numpy())) <= 1e-8
            assert np.max(np.abs(s.duality_gap.numpy()
                                 - np.asarray(s_ref.duality_gap))) \
                <= CERT_DGAP
            assert np.max(s.ineq_res.numpy()) <= 1e-10
            assert np.array_equal(s.stalled.numpy(),
                                  np.asarray(s_ref.stalled))

    @pytest.mark.timeout(60)
    def test_equalities_only_batch(self):
        # k = 0, mE = 2 (kl_2's rows, per-instance r): both certified
        # routes against the reference's fused_cert=False route
        n, B = 20, 4
        A = _zoo("kl_2", n)["A"].astype(np.float32)
        R = np.stack([[0.36 * s, 0.1 * s] for s in (0.8, 0.9, 1.0, 1.1)]
                     ).astype(np.float32)
        U = np.zeros((B, 0), np.float32)
        ref = RefDistKL.create(n, A=jnp.asarray(A),
                               r=jnp.zeros((2,), jnp.float32),
                               dtype=jnp.float32)
        s_ref = ref.solve_certified_batch(jnp.asarray(U), r=jnp.asarray(R),
                                          fused_cert=False)
        port = DistKL.create(n, A=torch.from_numpy(A), r=torch.zeros(2),
                             device="cpu")
        for fused in (None, False):
            s = port.solve_certified_batch(torch.from_numpy(U),
                                           r=torch.from_numpy(R),
                                           fused_cert=fused)
            assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) \
                <= CERT_DX
            assert np.max(np.abs(s.duality_gap.numpy())) <= 1e-8
            assert np.max(s.eq_gap.numpy()) <= 1e-10
            assert np.array_equal(s.stalled.numpy(),
                                  np.asarray(s_ref.stalled))
            assert not s.stalled.any()

    @pytest.mark.timeout(60)
    def test_infeasible_fleet_flags_exactly(self):
        # test_round5.py::TestBatchedInfeasibility: P(A) >= pA and
        # P(A) <= qA with qA < pA on every fourth instance
        n, B = 32, 20
        rng = np.random.default_rng(0)
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A]).astype(np.float32)
        pA = rng.uniform(0.3, 0.5, B)
        qA = pA + rng.uniform(0.05, 0.2, B)
        bad = np.zeros(B, bool); bad[::4] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        U = np.stack([-pA, qA], axis=1).astype(np.float32)
        ref = RefDistKL.create(n, H=jnp.asarray(H),
                               u=jnp.zeros((2,), jnp.float32),
                               dtype=jnp.float32)
        flags_ref = np.asarray(
            ref.solve_certified_batch(jnp.asarray(U)).stalled)
        assert np.array_equal(flags_ref, bad)
        port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(2),
                             device="cpu")
        for fused in (None, False):
            s = port.solve_certified_batch(torch.from_numpy(U),
                                           fused_cert=fused)
            assert np.array_equal(s.stalled.numpy(), flags_ref)
            assert np.array_equal(s.status.numpy(),
                                  np.where(bad, Solution.STATUS_STALLED,
                                           Solution.STATUS_OK))
            assert np.max(np.abs(s.duality_gap.numpy()[~bad])) <= 1e-8

    @pytest.mark.timeout(30)
    def test_fused_cert_needs_f32(self):
        # test_round5.py::TestFusedCertDtypeGuard
        port = DistKL.create(16, H=_t(np.eye(2, 16)), u=_t(np.zeros(2)),
                             device="cpu")
        U = _t(np.full((2, 2), 0.5))
        with pytest.raises(ValueError, match="f32"):
            port.solve_certified_batch(U, fused_cert=True)
        ref = RefDistKL.create(16, H=jnp.asarray(np.eye(2, 16)),
                               u=jnp.zeros((2,), jnp.float64))
        with pytest.raises(ValueError, match="f32"):
            ref.solve_certified_batch(jnp.asarray(np.full((2, 2), 0.5)),
                                      fused_cert=True)
        # auto on f64 data: K1 + the f64 finish, never the f32 error
        s = port.solve_certified_batch(U)
        assert s.duality_gap.dtype == torch.float64

    @pytest.mark.timeout(60)
    def test_solve_certified_with_prior_and_equality(self):
        # test_round3.py::test_fused_active_constraints_dim5 plus a prior:
        # dual_fused_cert certifies one instance end to end
        n = 100
        IA = np.zeros(n); IA[:3] = 1.0
        IB = np.zeros(n); IB[n // 2:] = 1.0
        IC = np.zeros(n); IC[10:30] = 1.0
        p = np.random.default_rng(4).uniform(0.5, 1.5, n)
        data = dict(H=np.stack([-IA, IB, IC]), u=np.array([-0.3, 0.7, 0.4]),
                    A=np.linspace(0.2, 0.8, n)[None], r=np.array([0.52]),
                    prior=p)
        ref = RefDistKL.create(n, **{k: jnp.asarray(v)
                                     for k, v in data.items()})
        port = DistKL.create(n, **{k: _t(v) for k, v in data.items()},
                             device="cpu")
        s_ref = ref.solve(method="dual_fused_cert")
        s = port.solve(method="dual_fused_cert")
        assert float(s.duality_gap) <= 1e-8
        assert float(s.ineq_res) <= 1e-10 and float(s.eq_gap) <= 1e-10
        assert not bool(s.stalled)
        assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) <= CERT_DX
        assert int(s.iters) == int(s_ref.iters) == 18
        leaves = solution_to_numpy(s)
        assert leaves["x"].shape == (n,) and np.isnan(leaves["norm_grad"])


class TestKLCertify:
    @pytest.mark.timeout(60)
    @pytest.mark.parametrize("compare_input", [True, False])
    def test_warm_branch_matches_reference(self, compare_input):
        n, B = 24, 4
        rng = np.random.default_rng(11)
        I_A = np.zeros(n); I_A[:4] = 1.0
        H = (-I_A)[None]
        u = -rng.uniform(0.3, 0.5, (B, 1))
        A = np.ones((1, n)); b = np.ones((B, 1))
        # rough warm starts: a perturbed optimum-ish dual and its primal
        z0 = np.column_stack([rng.uniform(1.0, 2.0, B),
                              rng.uniform(-0.8, -0.6, B)])
        y = np.exp(-(z0 @ np.vstack([H, A])) - 1.0) / n
        x = y / y.sum(axis=1, keepdims=True)
        ref = jax.vmap(lambda ui, bi, xi, zi: ref_kl_certify(
            jnp.asarray(H), ui, jnp.asarray(A), bi, xi, polish_steps=3,
            z0=zi, compare_input=compare_input))(
                jnp.asarray(u), jnp.asarray(b), jnp.asarray(x),
                jnp.asarray(z0))
        got = kl_certify(_t(H), _t(u), _t(A), _t(b), _t(x), z0=_t(z0),
                         polish_steps=3, compare_input=compare_input)
        for f in ("x", "gap", "ineq_res", "eq_res", "lam", "nu"):
            assert np.max(np.abs(getattr(got, f).numpy()
                                 - np.asarray(getattr(ref, f)))) <= 1e-12, f
        # the cold branch (z0=None) against the reference's
        ref = jax.vmap(lambda ui, bi, xi: ref_kl_certify(
            jnp.asarray(H), ui, jnp.asarray(A), bi, xi, polish_steps=3,
            compare_input=compare_input))(
                jnp.asarray(u), jnp.asarray(b), jnp.asarray(x))
        got = kl_certify(_t(H), _t(u), _t(A), _t(b), _t(x), polish_steps=3,
                         compare_input=compare_input)
        for f in ("x", "gap", "ineq_res", "eq_res", "lam", "nu"):
            assert np.max(np.abs(getattr(got, f).numpy()
                                 - np.asarray(getattr(ref, f)))) <= 1e-12, f

    @pytest.mark.timeout(30)
    def test_solver_params_defaults(self):
        pars = SolverParams()
        assert (pars.tol, pars.tol_feas, pars.dual_start) == (1e-8, 1e-7,
                                                             1e-3)
