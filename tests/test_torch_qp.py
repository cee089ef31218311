"""Port parity for the QP model family: ``cvx_tpu_torch.models.qp`` (QP,
DiagQP, LP, qp_certify) against ``cvx_tpu.models.qp`` on the same numpy
data.  Mirrors ``tests/test_qp_model.py`` (all), ``tests/test_round3.py::
TestQPCertified`` (:1249-1376) and the QP cases of ``tests/test_fuzz.py``
(TestQPRoutesAgree, its seeds as parameters).

The port solves a batch at once (P, G, A shared; a, h, b per instance);
the reference is vmapped over the same numpy instances.

Tolerances: x to 1e-8 in f64 and 1e-5 in f32 (relative to 1 + |x|),
``iters``, ``stalled`` and ``maxed_out`` exactly, the certified gap and
residuals to 1e-10 in f64 (both are measured f64 values near 0), the
reference's own contracts (|gap| <= 1e-8, residuals) on both.  At the
default tol = 1e-8 the barrier's last stopping decisions compare Newton
decrements at their rounding level, so an instance may take a step more
or fewer than the reference's (79 against 78 on the equality case, x
within 2e-16; 2 of the 8 batch instances): where a test runs at the
default, ``iters`` is compared exactly in a second run at tol = 1e-6, as
``tests/test_torch_structured.py`` does.

Two cases compare less than x at the end, and say so where they do:

* the LP member (c = 0): its barrier Hessian is diag(1/x^2), so rounding
  is amplified as the iterates approach the vertex.  The two
  trajectories agree to 2e-13 for three stages; from the fourth the
  Newton decrements near tol are rounding (both packages' compiled
  arithmetic differs by host CPU), and the step counts part (33 against
  31 through stage four of the n = 12 LP at tol 1e-10, mu 20).  The
  port's Schur step corrects A dx to rhs once a step, so its sum(x) stays
  within 2.2e-16 of 1 at every stage; the reference's drifts to -1.1e-7
  at tol 1e-10 (its objective ends 1.1e-7 below the optimum 1, the
  port's 2.1e-11 above it).  ``_lp_parity`` holds x to 1e-8 and
  ``iters`` exactly over the first three stages, the flags exactly, and
  the final objectives to 2e-7 (1.1e-7 measured);
* f32 solves at their resolution floor: the primal-dual method stops by a
  failed line search, a rounding decision (the reference at step 11, the
  port at 21, both stalled at gap 8.7e-5), so f32 ``iters`` are not
  compared; the certified x are (to 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.models.qp import LP as RefLP
from cvx_tpu.models.qp import QP as RefQP
from cvx_tpu.models.qp import DiagQP as RefDiagQP
from cvx_tpu.models.qp import qp_certify as ref_qp_certify
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import interop
from cvx_tpu_torch.models import LP, QP, DiagQP, qp_certify
from cvx_tpu_torch.solvers import SolverParams

# Tier-1 runs six test processes on the CPU's cores, and every process
# imports every test file: one torch thread a process keeps torch's
# intra-op pools from oversubscribing the cores (the port's test files on
# 8 cores: 726 s with torch's default threads, 104 s with one)
torch.set_num_threads(1)

X64, X32 = 1e-8, 1e-5
CERT = 1e-10


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b) / (1.0 + np.abs(b)), initial=0.0)
    assert err <= tol, err


def _same(a, b):
    assert np.array_equal(_np(a), _np(b)), (_np(a), _np(b))


def _spd(rng, n, cond):
    """ops.random_spd's recipe in numpy: Haar U, spectrum exp(-j rho)."""
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.exp(-np.log(cond) / n * np.arange(n))
    return (U * d) @ U.T


def _box(seed, n=8):
    """TestQP._box_qp: -1 <= x <= 1."""
    rng = np.random.default_rng(seed)
    P = _spd(rng, n, 100.0)
    a = rng.standard_normal(n)
    I = np.eye(n)
    return P, a, np.concatenate([I, -I]), np.ones(2 * n)


def _same_iters(rq, qp, n, method):
    """iters exactly at tol = 1e-6 from the reference's phase-I point."""
    from cvx_tpu.solvers.phase1 import find_feasible_point

    fp = find_feasible_point(rq.inequalities, jnp.zeros(n), RefParams(),
                             rq.equalities)
    ref = rq.solve_jittable(fp, method, RefParams(tol=1e-6))
    sol = qp.solve_jittable(torch.tensor(np.asarray(fp)), method,
                            SolverParams(tol=1e-6))
    _close(sol.x, ref.x, X64)
    _same(sol.iters, ref.iters)


def _lp_parity(rlp, lp, x0, pars=None):
    """x to 1e-8 and iters exactly over the first three stages of the
    continuation, the flags exactly, and the final objective to 2e-7;
    returns the port's final Solution."""
    pars = pars or {}
    r5 = rlp.solve_jittable(jnp.asarray(x0), RefParams(**pars,
                                                        outer_max_iter=3))
    s5 = lp.solve_jittable(torch.tensor(x0), SolverParams(**pars,
                                                          outer_max_iter=3))
    _close(s5.x, r5.x, X64)
    _same(s5.iters, r5.iters)
    ref = rlp.solve_jittable(jnp.asarray(x0), RefParams(**pars))
    sol = lp.solve_jittable(torch.tensor(x0), SolverParams(**pars))
    _same(sol.stalled, ref.stalled)
    _same(sol.maxed_out, ref.maxed_out)
    f_ref = float(rlp.value(ref.x))
    assert abs(float(lp.value(sol.x[None])[0]) - f_ref) < 2e-7
    return sol


def _vmap(fn, *arrays):
    return jax.vmap(fn)(*(jnp.asarray(v) for v in arrays))


class TestQP:
    """test_qp_model.py::TestQP."""

    @pytest.mark.parametrize("method", ["BR", "PD"])
    def test_box_qp_kkt(self, method):
        P, a, G, h = _box(0)
        ref = RefQP.create(P=P, a=a, G=G, h=h).solve(method=method)
        qp = QP.create(P=P, a=a, G=G, h=h, device="cpu")
        sol = qp.solve(method=method)
        _close(sol.x, ref.x, X64)
        _close(sol.lam, ref.lam, 1e-6)
        _same(sol.iters, ref.iters)
        _same(sol.stalled, ref.stalled)
        # KKT stationarity with box duals (the reference test's check)
        res = qp.objective.grad(sol.x[None])[0] + qp.G.T @ sol.lam
        assert float(torch.linalg.vector_norm(res)) < 1e-4
        assert float(torch.max(torch.abs(sol.x))) <= 1.0 + 1e-8

    def test_with_equalities(self):
        n = 6
        P, a, G, h = _box(1, n)
        A, b = np.ones((1, n)), np.ones(1)
        ref = RefQP.create(P=P, a=a, G=G, h=h, A=A, b=b).solve(method="BR")
        qp = QP.create(P=P, a=a, G=G, h=h, A=A, b=b, device="cpu")
        sol = qp.solve(method="BR")
        _close(sol.x, ref.x, X64)
        _same(sol.stalled, ref.stalled)
        _same_iters(RefQP.create(P=P, a=a, G=G, h=h, A=A, b=b), qp, n, "BR")
        assert abs(float(sol.x.sum()) - 1.0) < 1e-6

    def test_unconstrained_check(self):
        n = 5
        rng = np.random.default_rng(2)
        P = _spd(rng, n, 10.0)
        a = rng.standard_normal(n)
        I = np.eye(n)
        G, h = np.concatenate([I, -I]), np.full(2 * n, 100.0)
        ref = RefQP.create(P=P, a=a, G=G, h=h).solve(method="BR")
        sol = QP.create(P=P, a=a, G=G, h=h, device="cpu").solve(method="BR")
        _close(sol.x, ref.x, X64)
        assert float(np.max(np.abs(_np(sol.x) + np.linalg.solve(P, a)))) \
            < 1e-4

    def test_vmap_batch(self):
        """The reference vmaps QP.create over shifted a; the port takes
        the (B, n) linear terms as one batched QP."""
        n, B = 6, 8
        P, a, G, h = _box(3, n)
        A_b = a[None, :] + np.linspace(0.0, 1.0, B)[:, None]

        def solve_one(ai):
            return RefQP.create(P=jnp.asarray(P), a=ai, G=jnp.asarray(G),
                                h=jnp.asarray(h)).solve_jittable(
                jnp.zeros(n), method="BR")

        def solve_one_1e6(ai):
            return RefQP.create(P=jnp.asarray(P), a=ai, G=jnp.asarray(G),
                                h=jnp.asarray(h)).solve_jittable(
                jnp.zeros(n), method="BR", pars=RefParams(tol=1e-6))

        qp = QP.create(P=P, a=A_b, G=G, h=h, device="cpu")
        assert qp.batch == B
        x0 = torch.zeros(n, dtype=torch.float64)
        sol = qp.solve_jittable(x0, "BR")
        ref = _vmap(solve_one, A_b)
        assert tuple(sol.x.shape) == (B, n)
        _close(sol.x, ref.x, X64)
        _same(sol.stalled, ref.stalled)
        sol = qp.solve_jittable(x0, "BR", SolverParams(tol=1e-6))
        ref = _vmap(solve_one_1e6, A_b)
        _close(sol.x, ref.x, X64)
        _same(sol.iters, ref.iters)


class TestDiagQP:
    """test_qp_model.py::TestDiagQP and ::TestLP."""

    def test_matches_dense(self):
        n = 10
        c = np.linspace(1.0, 3.0, n)
        a = -np.ones(n)
        U = np.ones((1, n)) * np.linspace(0, 1, n)[None]
        ub, A, b = np.array([10.0]), np.ones((1, n)), np.ones(1)
        x0 = np.full(n, 1.0 / n)
        ref = RefDiagQP(c=jnp.asarray(c), a=jnp.asarray(a),
                        U=jnp.asarray(U), ub=jnp.asarray(ub),
                        A=jnp.asarray(A), b=jnp.asarray(b)
                        ).solve_jittable(jnp.asarray(x0))
        dq = DiagQP.create(c, a, U, ub, A, b, device="cpu")
        sol = dq.solve_jittable(torch.tensor(x0))
        _close(sol.x, ref.x, X64)
        _same(sol.iters, ref.iters)
        G = np.concatenate([U, -np.eye(n)])
        h = np.concatenate([ub, np.zeros(n)])
        dense = QP.create(P=np.diag(c), a=a, G=G, h=h, A=A, b=b,
                          device="cpu").solve_jittable(torch.tensor(x0), "BR")
        assert float(torch.max(torch.abs(sol.x - dense.x))) < 1e-4

    def test_simplex_lp(self):
        n = 8
        a = np.linspace(2.0, 1.0, n)
        A, b = np.ones((1, n)), np.ones(1)
        x0 = np.full(n, 1.0 / n)
        sol = _lp_parity(RefLP(jnp.asarray(a), A=jnp.asarray(A),
                               b=jnp.asarray(b)),
                         LP(a, A=A, b=b, device="cpu"), x0)
        assert float(sol.x[-1]) > 0.999
        assert float(sol.duality_gap) < 1e-8

    def test_lp_with_dense_row(self):
        n = 6
        a = np.linspace(2.0, 1.0, n)
        U = np.zeros((1, n)); U[0, n - 1] = 1.0
        x0 = np.full(n, 1.0 / n)
        kw = dict(U=U, ub=np.array([0.3]), A=np.ones((1, n)), b=np.ones(1))
        sol = _lp_parity(RefLP(jnp.asarray(a), **{k: jnp.asarray(v) for k, v
                                                   in kw.items()}),
                         LP(a, device="cpu", **kw), x0)
        assert abs(float(sol.x[-1]) - 0.3) < 1e-3
        assert float(sol.x[-2]) > 0.69

    def test_lp_follows_inputs_and_card_default(self):
        """test_round3.py::TestDtypeFollowsInputs::test_lp_follows_inputs;
        the device default is the card."""
        lp = LP(np.ones(4, np.float32), A=np.ones((1, 4), np.float32),
                b=np.ones(1, np.float32), device="cpu")
        assert lp.a.dtype == torch.float32 and lp.c.dtype == torch.float32
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                LP(np.ones(4), A=np.ones((1, 4)), b=np.ones(1))


def _cert_qp(seed, n=12, m=20, p=2, dtype=np.float32):
    """TestQPCertified._qp from a numpy seed: P = M M' + I, optimum near a
    random z, 0 strictly feasible."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    P = M @ M.T + np.eye(n)
    a = -(P @ rng.standard_normal(n))
    G = rng.standard_normal((m, n)) / np.sqrt(n)
    h = rng.uniform(0.1, 0.6, m)
    A = rng.standard_normal((p, n)) / np.sqrt(n)
    return [v.astype(dtype) for v in (P, a, G, h, A, np.zeros(p))]


class TestQPCertified:
    """test_round3.py::TestQPCertified."""

    def test_certified_f32_reaches_1e8(self):
        data = _cert_qp(0)
        pars = dict(tol=1e-5, kkt_method="chol")
        ref = RefQP.create(*data, dtype=jnp.float32).solve_certified(
            jnp.zeros(12, jnp.float32), RefParams(**pars))
        qp = QP.create(*data, dtype=torch.float32, device="cpu")
        x0 = torch.zeros(12, dtype=torch.float32)
        sol = qp.solve_certified(x0, SolverParams(**pars))
        raw = qp.solve_jittable(x0, "PD", SolverParams(**pars))
        assert sol.x.dtype == torch.float64
        _close(sol.x, ref.x, X32)
        _same(sol.stalled, ref.stalled)
        assert abs(float(sol.duality_gap)) < 1e-8
        assert float(sol.ineq_res) < 1e-10 and float(sol.eq_gap) < 1e-10
        assert not bool(sol.stalled)
        cert_raw = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, raw.x,
                              raw.lam, raw.nu, polish_steps=0)
        assert abs(float(sol.duality_gap)) < abs(float(cert_raw.gap))

    def test_certificate_is_valid_bound(self):
        data = _cert_qp(1, dtype=np.float64)
        pars = dict(tol=1e-10, kkt_method="chol")
        qp = QP.create(*data, device="cpu")
        sol = qp.solve_jittable(torch.zeros(12, dtype=torch.float64), "PD",
                                SolverParams(**pars))
        rsol = RefQP.create(*data).solve_jittable(jnp.zeros(12), "PD",
                                                  RefParams(**pars))
        _close(sol.x, rsol.x, X64)
        lam_bad = _np(sol.lam) * 1.7 + 0.05
        for steps in (0, 4):
            cert = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, sol.x,
                              torch.tensor(lam_bad), sol.nu,
                              polish_steps=steps)
            rc = ref_qp_certify(*(jnp.asarray(v) for v in data),
                                jnp.asarray(_np(sol.x)), jnp.asarray(lam_bad),
                                jnp.asarray(_np(sol.nu)), polish_steps=steps)
            _close(cert.x, rc.x, X64)
            assert abs(float(cert.gap) - float(rc.gap)) < CERT
            _close(cert.lam, rc.lam, 1e-8)
            if steps == 0:
                assert float(cert.gap) >= -1e-12
            else:
                assert abs(float(cert.gap)) < 1e-9

    def test_active_constraints(self):
        n = 6
        P, a = np.eye(n), -np.ones(n)
        G, h = np.eye(n)[:2], np.array([0.3, 0.5])
        pars = dict(tol=1e-8, kkt_method="chol")
        qp = QP.create(P, a, G, h, device="cpu")
        sol = qp.solve_jittable(torch.zeros(n, dtype=torch.float64), "PD",
                                SolverParams(**pars))
        cert = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, sol.x,
                          sol.lam, sol.nu)
        rq = RefQP.create(P, a, G, h)
        rs = rq.solve_jittable(jnp.zeros(n), "PD", RefParams(**pars))
        rc = ref_qp_certify(rq.P, rq.a, rq.G, rq.h, rq.A, rq.b, rs.x,
                            rs.lam, rs.nu)
        _close(cert.x, rc.x, X64)
        assert abs(float(cert.gap)) < 1e-10
        assert float(torch.min(cert.lam)) > 0.1
        assert abs(float(cert.x[0]) - 0.3) < 1e-9
        assert abs(float(cert.x[1]) - 0.5) < 1e-9

    def test_vmapped_certified_batch(self):
        """m + p > n: the dual Hessian is singular; the active-set passes
        still certify every instance of the batch to 1e-8."""
        P, a, G, h, A, b = _cert_qp(2, n=10, m=25, p=2)
        B = 6
        A_b = (a[None, :] + np.linspace(0.0, 0.5, B)[:, None]).astype(
            np.float32)
        pars = dict(tol=1e-5, kkt_method="chol")

        def solve_one(ai):
            q2 = RefQP.create(P, ai, G, h, A, b, dtype=jnp.float32)
            sol = q2.solve_jittable(jnp.zeros((10,), jnp.float32), "PD",
                                    RefParams(**pars))
            return ref_qp_certify(q2.P, q2.a, q2.G, q2.h, q2.A, q2.b,
                                  sol.x, sol.lam, sol.nu)

        ref = _vmap(solve_one, A_b)
        qp = QP.create(P, A_b, G, h, A, b, device="cpu")
        sol = qp.solve_jittable(torch.zeros(10, dtype=torch.float32), "PD",
                                SolverParams(**pars))
        certs = qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, sol.x,
                           sol.lam, sol.nu)
        _close(certs.x, ref.x, X32)
        assert float(torch.max(torch.abs(certs.gap))) < 1e-8
        assert float(torch.max(certs.ineq_res)) < 1e-10
        assert float(torch.max(certs.eq_res)) < 1e-10

    def test_diagqp_certified(self):
        n, k = 24, 2
        rng = np.random.default_rng(3)
        c = 0.5 + rng.random(n)
        a = rng.standard_normal(n)
        U = rng.random((k, n))
        x_ref = np.full(n, 0.5)
        ub = U @ x_ref + 0.2
        A, b = np.ones((1, n)), np.array([n / 2.0])
        rq = RefDiagQP(c=jnp.asarray(c), a=jnp.asarray(a), U=jnp.asarray(U),
                       ub=jnp.asarray(ub), A=jnp.asarray(A),
                       b=jnp.asarray(b))
        rcert = rq.solve_certified(jnp.asarray(x_ref))
        dq = interop.diagqp_from_numpy(rq, device="cpu")
        sol = dq.solve(SolverParams(tol=1e-9, kkt_method="chol"))
        cert = dq.solve_certified(torch.tensor(x_ref))
        _close(cert.x, rcert.x, X64)
        _same(cert.stalled, rcert.stalled)
        assert abs(float(cert.duality_gap)) < 1e-8
        assert float(cert.ineq_res) < 1e-10 and float(cert.eq_gap) < 1e-10
        assert not bool(cert.stalled)
        assert float(torch.max(torch.abs(cert.x - sol.x))) < 1e-5

    def test_lp_certified_raises(self):
        lp = LP(np.ones(4), A=np.ones((1, 4)), b=np.ones(1), device="cpu")
        with pytest.raises(ValueError, match="singular"):
            lp.solve_certified(torch.full((4,), 0.25, dtype=torch.float64))


class TestQPRoutesAgree:
    """test_fuzz.py::TestQPRoutesAgree, each seed against the reference."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_br_vs_pd(self, seed):
        rng = np.random.default_rng(100 + seed)
        n, m, p = 20, 12, 3
        M = rng.normal(size=(n, n)) / np.sqrt(n)
        data = dict(P=M @ M.T + np.eye(n), a=rng.normal(size=n),
                    G=rng.normal(size=(m, n)) / np.sqrt(n),
                    h=rng.uniform(0.5, 1.5, size=m),
                    A=rng.normal(size=(p, n)) / np.sqrt(n), b=np.zeros(p))
        rq = RefQP.create(**data)
        qp = interop.qp_from_numpy(rq, device="cpu")
        x0 = torch.zeros(n, dtype=torch.float64)
        f = {}
        for method in ("BR", "PD"):
            sol = qp.solve_jittable(x0, method, SolverParams(tol=1e-9))
            ref = rq.solve_jittable(jnp.zeros(n), method, RefParams(tol=1e-9))
            _close(sol.x, ref.x, X64)
            f[method] = float(qp.objective.value(sol.x[None])[0])
        assert abs(f["BR"] - f["PD"]) < 1e-6, f

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_structured_vs_dense(self, seed):
        from cvx_tpu_torch.problem import (ConstraintSet, EqualityConstraint,
                                           positivity, rows_leq)
        from cvx_tpu_torch.solvers import barrier_solve

        rng = np.random.default_rng(200 + seed)
        n, k = 24, 2
        c = rng.uniform(0.5, 2.0, size=n)
        a = rng.normal(size=n)
        U = np.abs(rng.normal(size=(k, n))) / np.sqrt(n)
        A, b = np.ones((1, n)), np.ones(1)
        x0 = np.full(n, 1.0 / n)
        ub = U @ x0 + rng.uniform(0.3, 0.8, size=k)
        pars = dict(tol=1e-10, mu=20.0, kkt_method="chol")
        rdq = RefDiagQP(c=jnp.asarray(c), a=jnp.asarray(a), U=jnp.asarray(U),
                        ub=jnp.asarray(ub), A=jnp.asarray(A),
                        b=jnp.asarray(b))
        ref = rdq.solve_jittable(jnp.asarray(x0), RefParams(**pars))
        dq = DiagQP.create(c, a, U, ub, A, b, device="cpu")
        sol_s = dq.solve_jittable(torch.tensor(x0), SolverParams(**pars))
        _close(sol_s.x, ref.x, X64)

        class Dense:
            def value(self, x):
                return dq.value(x)

            def grad(self, x):
                return dq.grad(x)

            def hess(self, x):
                return torch.diag_embed(dq.hess_diag(x))

        t = torch.tensor
        cnts = ConstraintSet(blocks=(rows_leq(t(U), t(ub)), positivity(n)))
        sol_d = barrier_solve(Dense(), cnts, t(x0)[None],
                              SolverParams(tol=1e-10, mu=20.0),
                              eqs=EqualityConstraint(A=t(A), b=t(b)))
        f_s = float(dq.value(sol_s.x[None])[0])
        f_d = float(dq.value(sol_d.x)[0])
        assert abs(f_s - f_d) < 1e-7, (f_s, f_d)

    def test_lp_structured(self):
        n = 12
        a = np.linspace(1.0, 2.0, n)
        x0 = np.full(n, 1.0 / n)
        lp = LP(a, A=np.ones((1, n)), b=np.ones(1), device="cpu")
        sol = _lp_parity(RefLP(jnp.asarray(a), A=jnp.ones((1, n)),
                               b=jnp.ones((1,))), lp, x0,
                         dict(tol=1e-10, mu=20.0))
        assert float(sol.x[0]) > 0.999
        assert abs(float(lp.value(sol.x[None])[0]) - a[0]) < 1e-3


class TestStructuredEquality:
    """The structured route's equality rows stage by stage on the n = 12 LP
    of ``TestQPRoutesAgree::test_lp_structured`` (tol 1e-10, mu 20).

    The first three stages take the reference's step counts (3, 10, 23) and
    x.  Through stage four the port takes 31 steps, pinned; the reference
    takes 33 where XLA's CPU code fuses multiply-adds and 32 where it
    cannot (``--xla_cpu_max_isa=AVX``), as its stop there is decided by
    rounding, so the two are held within 2 steps.  At every later stage and
    at exit the port's |sum(x) - 1| is within 10x of the reference's and at
    rounding level (2.2e-16 measured; the reference's 1.4e-12 after stage
    four, 1.1e-7 at exit)."""

    def test_lp_stages_hold_equality(self):
        n = 12
        a = np.linspace(1.0, 2.0, n)
        x0 = np.full(n, 1.0 / n)
        rlp = RefLP(jnp.asarray(a), A=jnp.ones((1, n)), b=jnp.ones((1,)))
        lp = LP(a, A=np.ones((1, n)), b=np.ones(1), device="cpu")
        for stages in (1, 2, 3, 4, 5, 6, 8, None):
            kw = dict(tol=1e-10, mu=20.0)
            if stages is not None:
                kw["outer_max_iter"] = stages
            ref = rlp.solve_jittable(jnp.asarray(x0), RefParams(**kw))
            sol = lp.solve_jittable(torch.tensor(x0), SolverParams(**kw))
            res = abs(float(sol.x.sum()) - 1.0)
            ref_res = abs(float(jnp.sum(ref.x)) - 1.0)
            if stages is not None and stages <= 3:
                _same(sol.iters, ref.iters)
                _close(sol.x, ref.x, 1e-12)
            if stages == 4:
                assert int(sol.iters) == 31
                assert abs(int(sol.iters) - int(ref.iters)) <= 2, (
                    int(sol.iters), int(ref.iters))
            assert res <= max(10.0 * ref_res, 1e-15), (stages, res, ref_res)
            assert not bool(sol.stalled)
        # exit: feasible to rounding, and on the optimum f* = a[0] = 1
        f = float(lp.value(sol.x[None])[0])
        assert res <= 1e-15 and 0.0 <= f - a[0] < 1e-9, (res, f - a[0])


class TestAbsSum:
    """test_qp_model.py::TestAbsSum (the port's block against the
    reference's; also in test_torch_problem_modeling.py)."""

    def test_rows(self):
        from cvx_tpu import problem as rpb
        from cvx_tpu_torch import problem as pb

        blk, rblk = pb.abs_sum_bounded(4, 1, 3, 2.0), \
            rpb.abs_sum_bounded(4, 1, 3, 2.0)
        assert blk.m == 4
        x = np.array([[5.0, 1.0, -0.5, 7.0], [0.0, 1.5, -1.0, 0.0]])
        _close(blk.value(torch.tensor(x)), _vmap(rblk.value, x), 0.0)
        ok = torch.all(blk.value(torch.tensor(x)) <= blk.ub, dim=-1)
        assert ok.tolist() == [True, False]
