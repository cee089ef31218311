"""Port parity for the problem API and the auxiliary layer: ``minimize``
(the problem zoo), ``ops.scalar``, ``ops.reduction``, ``ops.testmat``,
``testing``, ``diagnostics`` (solve_stats, barrier_history, trace),
``tree`` and its exact-f32 guard, against ``cvx_tpu`` on the same numpy
data.  Mirrors ``tests/test_problems_zoo.py`` (all),
``tests/test_utilities.py`` (all), ``tests/test_round3.py::
TestStructuredFrontDoor::test_minimize_dispatches_br_fast`` /
``test_minimize_br_fast_rejects_unstructured`` (:363-402),
``::TestInfraReviewFixes::test_barrier_history_single_stage_params``
(:1097) and ``tests/test_fuzz.py::TestKLRoutesAgree`` (its seeds as
parameters).

Tolerances: the zoo's x to 1e-8 (f64; the reference's acceptance |f -
f*| < 1e-2 on the port's result too) and the flags exactly at the
default tol = 1e-8, and ``iters`` exactly in a second run at tol = 1e-6
(at 1e-8 the last stopping decisions compare a Newton decrement at its
rounding level: 75 against 72 steps on the first zoo problem, x equal to
1e-16); the scalar roots to 1e-12; the reduced KKT solve to the
reference test's residuals; the sign-combination matrices exactly and
``decaying_spectrum`` to one unit in the last place (XLA's exp is not the
C library's: 2 of 12 entries differ by one ulp);
``random_spd``'s eigenvalues within 1e-10 of the prescribed spectrum and
its kernel dimension exact (a ``torch.Generator`` cannot give
``jax.random``'s bits, so the random draws are held to properties); the
five KL routes within 1e-6 of each other and of the reference's dual
barrier (the fuzz test's bound).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu import minimize as ref_minimize
from cvx_tpu import problem as rpb
from cvx_tpu import testing as rtesting
from cvx_tpu.ops import testmat as rtestmat
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import DistKL, diagnostics, minimize, testing, tree
from cvx_tpu_torch import problem as pb
from cvx_tpu_torch.ops import kkt_solve, testmat
from cvx_tpu_torch.ops.reduction import (UnsolvableSystemError,
                                         free_coordinates, pad_solution,
                                         reduce_kkt)
from cvx_tpu_torch.ops.scalar import bisect, newton_1d
from cvx_tpu_torch.solvers import (SolverParams, barrier_solve,
                                   phase1_by_reduction, phase1_simple)

# Tier-1 runs six test processes on the CPU's cores, and every process
# imports every test file: one torch thread a process keeps torch's
# intra-op pools from oversubscribing the cores (the port's test files on
# 8 cores: 726 s with torch's default threads, 104 s with one)
torch.set_num_threads(1)

TOL = 1e-2          # |f - f*| acceptance (Runner.scala:30)
X64 = 1e-8
METHODS = ["BR", "PD"]


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _both(method, robj, rcnts, obj, cnts, x0, reqs=None, eqs=None,
          x_star=None):
    """minimize through both packages from the same x0: x to 1e-8, the
    flags exactly and the zoo's own |f - f*| check at the default
    tolerance; iters exactly at tol = 1e-6 (at 1e-8 the last stopping
    decisions compare a decrement at its rounding level)."""
    ref = ref_minimize(robj, rcnts, reqs, x0=jnp.asarray(x0), method=method)
    sol = minimize(obj, cnts, eqs, x0=_t(x0), method=method, device="cpu")
    assert tuple(sol.x.shape) == np.asarray(ref.x).shape
    err = float(np.max(np.abs(_np(sol.x) - np.asarray(ref.x))))
    assert err <= X64, err
    for f in ("stalled", "maxed_out"):
        assert np.array_equal(_np(getattr(sol, f)),
                              np.asarray(getattr(ref, f))), f
    r6 = ref_minimize(robj, rcnts, reqs, x0=jnp.asarray(x0), method=method,
                      pars=RefParams(tol=1e-6))
    s6 = minimize(obj, cnts, eqs, x0=_t(x0), method=method, device="cpu",
                  pars=SolverParams(tol=1e-6))
    assert int(s6.iters) == int(r6.iters), (int(s6.iters), int(r6.iters))
    if x_star is not None:
        f_star = float(obj.value(_t(x_star)))
        assert abs(float(obj.value(sol.x)) - f_star) < TOL
    return sol


class TestProblemZoo:
    """tests/test_problems_zoo.py, one case per class and method."""

    @pytest.mark.parametrize("method", METHODS)
    def test_min_dot_product(self, method):
        n = 8
        a = np.ones(n)
        _both(method,
              rpb.LinearObjective(a=-jnp.asarray(a), r=jnp.zeros(())),
              rpb.ConstraintSet(blocks=(rpb.abs_bounded(jnp.asarray(a)),)),
              pb.LinearObjective(a=-_t(a), r=_t(0.0)),
              pb.ConstraintSet(blocks=(pb.abs_bounded(_t(a)),)),
              2.0 * a, x_star=a)

    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("p", [2.2, 4.0])
    def test_min_p_norm(self, method, p):
        n = 8
        _both(method, rpb.p_norm_p(n, p),
              rpb.ConstraintSet(blocks=(rpb.positivity(n),)),
              pb.p_norm_p(n, p), pb.ConstraintSet(blocks=(pb.positivity(n),)),
              np.zeros(n), reqs=rpb.sum_to_one(n), eqs=pb.sum_to_one(n),
              x_star=np.full(n, 1.0 / n))

    @pytest.mark.parametrize("method", METHODS)
    def test_rank_one_simplex(self, method):
        n = 6
        a = np.linspace(1.0, 2.0, n)
        P = 2.0 * np.outer(a, a)
        x_star = np.zeros(n); x_star[0] = 1.0
        _both(method,
              rpb.QuadraticObjective(P=jnp.asarray(P), a=jnp.zeros(n),
                                     r=jnp.zeros(())),
              rpb.ConstraintSet(blocks=(rpb.positivity(n),)),
              pb.QuadraticObjective(P=_t(P), a=_t(np.zeros(n)), r=_t(0.0)),
              pb.ConstraintSet(blocks=(pb.positivity(n),)),
              np.full(n, 1.0 / n), reqs=rpb.sum_to_one(n),
              eqs=pb.sum_to_one(n), x_star=x_star)

    @pytest.mark.parametrize("method", METHODS)
    def test_rank_one_sphere(self, method):
        n = 6
        a = np.linspace(1.0, 2.0, n)
        P = 2.0 * np.outer(a, a)
        _both(method,
              rpb.QuadraticObjective(P=jnp.asarray(P), a=jnp.zeros(n),
                                     r=jnp.zeros(())),
              rpb.ConstraintSet(blocks=(rpb.half_norm2_bounded(n, 0.5),
                                        rpb.positivity(n))),
              pb.QuadraticObjective(P=_t(P), a=_t(np.zeros(n)), r=_t(0.0)),
              pb.ConstraintSet(blocks=(pb.half_norm2_bounded(n, 0.5),
                                       pb.positivity(n))),
              np.full(n, 1.0 / n), x_star=np.zeros(n))

    @pytest.mark.parametrize("method", METHODS)
    def test_free_variables(self, method):
        n = 8
        G = np.zeros((1, n)); G[0, 0] = 1.0
        x_star = np.zeros(n); x_star[0] = -1.0
        _both(method, rpb.norm_squared(n),
              rpb.ConstraintSet(blocks=(rpb.LinearBlock(
                  G=jnp.asarray(G), c=jnp.zeros(1),
                  ub=jnp.array([-1.0])),)),
              pb.norm_squared(n),
              pb.ConstraintSet(blocks=(pb.LinearBlock(
                  G=_t(G), c=_t(np.zeros(1)), ub=_t([-1.0])),)),
              np.ones(n), x_star=x_star)

    @pytest.mark.parametrize("method", METHODS)
    def test_jopt_p1(self, method):
        n = 6
        _both(method, rpb.LinearObjective(a=jnp.ones(n), r=jnp.zeros(())),
              rpb.ConstraintSet(blocks=(rpb.half_norm2_bounded(n, 0.5),)),
              pb.LinearObjective(a=_t(np.ones(n)), r=_t(0.0)),
              pb.ConstraintSet(blocks=(pb.half_norm2_bounded(n, 0.5),)),
              np.full(n, 2.0), x_star=np.full(n, -1.0 / np.sqrt(n)))

    @pytest.mark.parametrize("method", METHODS)
    def test_jopt_p2(self, method):
        P = 2 * np.array([[1.0, 0.4], [0.4, 1.0]])
        _both(method,
              rpb.QuadraticObjective(P=jnp.asarray(P), a=jnp.zeros(2),
                                     r=jnp.zeros(())),
              rpb.ConstraintSet(blocks=(rpb.positivity(2),)),
              pb.QuadraticObjective(P=_t(P), a=_t(np.zeros(2)), r=_t(0.0)),
              pb.ConstraintSet(blocks=(pb.positivity(2),)),
              np.full(2, 2.0), reqs=rpb.sum_to_one(2), eqs=pb.sum_to_one(2),
              x_star=np.array([0.5, 0.5]))

    @pytest.mark.parametrize("method", METHODS)
    def test_probability_simplex(self, method):
        n = 6
        a = np.ones(n)
        sol = _both(method,
                    rpb.QuadraticObjective(P=jnp.asarray(np.outer(a, a)),
                                           a=-jnp.asarray(a),
                                           r=jnp.asarray(0.5)),
                    rpb.ConstraintSet(blocks=(rpb.positivity(n),)),
                    pb.QuadraticObjective(P=_t(np.outer(a, a)), a=-_t(a),
                                          r=_t(0.5)),
                    pb.ConstraintSet(blocks=(pb.positivity(n),)),
                    np.full(n, 2.0))
        assert float(sol.x.min()) > -1e-8

    @pytest.mark.parametrize("method", METHODS)
    def test_distance_from_origin(self, method):
        n = 5
        dim = n + 1
        e = np.zeros(dim); e[n] = 1.0

        def qc(m):
            return m.QuadBlock(P=_a(m, np.eye(dim)[None]),
                               a=_a(m, (-2.0 * e)[None]),
                               r=_a(m, [1.5]), ub=_a(m, np.zeros(1)))

        _both(method, rpb.norm_squared(dim),
              rpb.ConstraintSet(blocks=(qc(rpb),)), pb.norm_squared(dim),
              pb.ConstraintSet(blocks=(qc(pb),)), np.zeros(dim), x_star=e)

    def test_distance_from_origin_n80(self):
        """TestCapabilityEnvelope: the reference (Scala) fails n >= 80."""
        n = 80
        dim = n + 1
        e = np.zeros(dim); e[n] = 1.0
        I = np.eye(dim)[:n]
        G = np.concatenate([-(I + e[None, :]), I - e[None, :]], axis=0)

        def cnts(m):
            return m.ConstraintSet(blocks=(
                m.QuadBlock(P=_a(m, np.eye(dim)[None]),
                            a=_a(m, (-2.0 * e)[None]), r=_a(m, [1.5]),
                            ub=_a(m, np.zeros(1))),
                m.LinearBlock(G=_a(m, G), c=_a(m, np.zeros(2 * n)),
                              ub=_a(m, np.full(2 * n, -1.0)))))

        sol = _both("BR", rpb.norm_squared(dim), cnts(rpb),
                    pb.norm_squared(dim), cnts(pb), np.zeros(dim))
        assert abs(float(pb.norm_squared(dim).value(sol.x)) - 0.5) < TOL

    def test_batched_points_and_card_default(self):
        """Points (B, n) solve B instances; the default device is the
        card (without one the move raises)."""
        n = 8
        obj, cnts = pb.norm_squared(n), pb.ConstraintSet(
            blocks=(pb.positivity(n),))
        X0 = _t(np.full((3, n), 0.5))
        sol = minimize(obj, cnts, pb.sum_to_one(n), feasible_point=X0,
                       device="cpu")
        assert tuple(sol.x.shape) == (3, n)
        one = minimize(obj, cnts, pb.sum_to_one(n), feasible_point=X0[0],
                       device="cpu")
        assert torch.equal(one.x, sol.x[0])
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                minimize(obj, cnts, pb.sum_to_one(n), feasible_point=X0)

    def test_unconstrained_and_bad_method(self):
        """OptimizationProblem.scala:101-115: no inequality set runs the
        (equality-constrained) Newton engine; a bogus method raises."""
        n = 5
        P = np.diag(np.arange(1.0, n + 1))
        a = np.ones(n)
        A, b = np.ones((1, n)), np.ones(1)
        ref = ref_minimize(rpb.QuadraticObjective(
            P=jnp.asarray(P), a=jnp.asarray(a), r=jnp.zeros(())),
            equalities=rpb.EqualityConstraint(A=jnp.asarray(A),
                                              b=jnp.asarray(b)),
            x0=jnp.zeros(n))
        sol = minimize(pb.QuadraticObjective(P=_t(P), a=_t(a), r=_t(0.0)),
                       equalities=pb.EqualityConstraint(A=_t(A), b=_t(b)),
                       x0=_t(np.zeros(n)), device="cpu")
        assert float(np.max(np.abs(_np(sol.x) - np.asarray(ref.x)))) <= X64
        assert int(sol.iters) == int(ref.iters)
        with pytest.raises(ValueError, match="unknown solver method"):
            minimize(pb.norm_squared(n), x0=_t(np.zeros(n)), method="XX",
                     device="cpu")


def _a(m, v):
    return jnp.asarray(np.asarray(v, np.float64)) if m is rpb else _t(v)


class TestStructuredFrontDoor:
    """test_round3.py::TestStructuredFrontDoor, the minimize dispatch."""

    def _diag(self, m, n=10):
        rng = np.random.default_rng(5)
        c = 0.5 + rng.random(n)
        a = rng.standard_normal(n)
        U = rng.random((2, n))
        ub = U @ np.full(n, 1.0 / n) + 0.3
        cnts = m.ConstraintSet(blocks=(m.rows_leq(_a(m, U), _a(m, ub)),
                                       m.positivity(n)))
        return c, a, cnts, m.sum_to_one(n)

    def test_minimize_dispatches_br_fast(self):
        from cvx_tpu.models.qp import DiagQP as RefDiagQP
        from cvx_tpu_torch.models import DiagQP

        n = 10
        c, a, rcnts, reqs = self._diag(rpb)
        _, _, cnts, eqs = self._diag(pb)
        robj = RefDiagQP(c=jnp.asarray(c), a=jnp.asarray(a),
                         U=jnp.zeros((0, n)), ub=jnp.zeros(0),
                         A=jnp.zeros((0, n)), b=jnp.zeros(0))
        obj = DiagQP.create(c, a, device="cpu")
        x0 = np.full(n, 1.0 / n)
        ref = ref_minimize(robj, rcnts, reqs, feasible_point=jnp.asarray(x0),
                           method="BR_fast")
        sol = minimize(obj, cnts, eqs, feasible_point=_t(x0),
                       method="BR_fast", device="cpu")
        assert float(np.max(np.abs(_np(sol.x) - np.asarray(ref.x)))) <= X64
        assert bool(sol.stalled) == bool(ref.stalled)
        r6 = ref_minimize(robj, rcnts, reqs, feasible_point=jnp.asarray(x0),
                          method="BR_fast", pars=RefParams(tol=1e-6))
        s6 = minimize(obj, cnts, eqs, feasible_point=_t(x0),
                      method="BR_fast", device="cpu",
                      pars=SolverParams(tol=1e-6))
        assert int(s6.iters) == int(r6.iters)
        dense = minimize(pb.QuadraticObjective(P=_t(np.diag(c)), a=_t(a),
                                               r=_t(0.0)), cnts, eqs,
                         feasible_point=_t(x0), method="BR", device="cpu")
        assert float(torch.max(torch.abs(sol.x - dense.x))) < 1e-5

    def test_minimize_br_fast_rejects_unstructured(self):
        n = 6
        obj = pb.norm_squared(n)
        quad = pb.ConstraintSet(blocks=(pb.half_norm2_bounded(n, 1.0),
                                        pb.positivity(n)))
        with pytest.raises(ValueError, match="all-linear"):
            minimize(obj, quad, feasible_point=_t(np.full(n, 0.1)),
                     method="BR_fast", device="cpu")
        from cvx_tpu_torch.models import DiagQP

        no_pos = pb.ConstraintSet(blocks=(pb.rows_leq(
            _t(np.ones((1, n))), _t([1.0])),))
        with pytest.raises(ValueError, match="positivity"):
            minimize(DiagQP.create(np.ones(n), np.ones(n), device="cpu"),
                     no_pos, feasible_point=_t(np.full(n, 0.1)),
                     method="BR_fast", device="cpu")


class TestScalar:
    """test_utilities.py::TestScalar."""

    def test_bisect(self):
        root = bisect(lambda x: x * x - 2.0, 0.0, 2.0)
        from cvx_tpu.ops.scalar import bisect as rbisect
        ref = rbisect(lambda x: x * x - 2.0, 0.0, 2.0)
        assert abs(float(root) - np.sqrt(2)) < 1e-10
        assert abs(float(root) - float(ref)) < 1e-12

    def test_newton_1d(self):
        root = newton_1d(lambda x: torch.cos(x) - x, 1.0)
        assert abs(float(torch.cos(root) - root)) < 1e-12
        from cvx_tpu.ops.scalar import newton_1d as rnewton
        ref = rnewton(lambda x: jnp.cos(x) - x, 1.0)
        assert abs(float(root) - float(ref)) < 1e-12

    def test_batched(self):
        """test_jittable: the reference jits/vmaps one root; the port takes
        a batch of brackets, each with its own loop."""
        lo = _t([0.0, 1.0, 1.5])
        hi = _t([3.0, 2.0, 1.8])
        roots = bisect(lambda x: x ** 3 - 5.0, lo, hi)
        assert float(torch.max(torch.abs(roots - 5 ** (1 / 3)))) < 1e-10
        starts = newton_1d(lambda x: x ** 3 - 5.0, _t([1.0, 2.0, 4.0]))
        assert float(torch.max(torch.abs(starts - 5 ** (1 / 3)))) < 1e-12


class TestReduction:
    """test_utilities.py::TestReduction (KktTest.scala:52-104)."""

    def _data(self):
        n, p = 10, 3
        rng = np.random.default_rng(0)
        U, _ = np.linalg.qr(rng.standard_normal((n, n)))
        H = (U * np.exp(-np.log(100.0) / n * np.arange(n))) @ U.T
        A = rng.standard_normal((p, n))
        dead = np.array([2, 7])
        H[dead, :] = 0.0
        H[:, dead] = 0.0
        A[:, dead] = 0.0
        x0 = rng.standard_normal(n); x0[dead] = 0.0
        q = -(H @ x0 + A.T @ np.ones(p))
        return H, A, q, A @ x0

    def test_roundtrip(self):
        from cvx_tpu.ops.reduction import reduce_kkt as rreduce

        H, A, q, b = self._data()
        n = H.shape[0]
        free = free_coordinates(_t(H), _t(A))
        assert list(np.nonzero(free)[0]) == [2, 7]
        Hr, Ar, qr, keep = reduce_kkt(_t(H), _t(A), _t(q))
        rHr, rAr, rqr, rkeep = rreduce(H, A, q)
        assert np.array_equal(keep, rkeep)
        for got, want in ((Hr, rHr), (Ar, rAr), (qr, rqr)):
            assert np.array_equal(_np(got), np.asarray(want))
        xr, wr, res = kkt_solve(Hr, Ar, qr, _t(b), method="chol")
        assert float(res) < 1e-8
        x = pad_solution(xr, keep, n)
        assert float(torch.linalg.vector_norm(
            _t(H) @ x + _t(A).T @ wr + _t(q))) < 1e-7
        assert float(torch.linalg.vector_norm(_t(A) @ x - _t(b))) < 1e-8

    def test_unsolvable(self):
        H = np.zeros((3, 3)); H[0, 0] = 1.0
        with pytest.raises(UnsolvableSystemError):
            reduce_kkt(_t(H), _t(np.zeros((0, 3))), _t([0.0, 1.0, 0.0]))


class TestTestmat:
    """ops/testmat.py: the deterministic functions exactly, the random
    ones by their properties."""

    @pytest.mark.parametrize("dim_kernel", [0, 3])
    def test_decaying_spectrum(self, dim_kernel):
        got = _np(testmat.decaying_spectrum(12, 1e4, dim_kernel))
        want = np.asarray(rtestmat.decaying_spectrum(12, 1e4, dim_kernel))
        ulp = np.spacing(np.abs(want))
        assert np.all(np.abs(got - want) <= ulp)
        assert np.array_equal(got == 0.0, want == 0.0)

    def test_sign_combinations(self):
        assert np.array_equal(testmat.sign_combination_matrix(3),
                              rtestmat.sign_combination_matrix(3))
        assert np.array_equal(
            testmat.sign_combination_matrix_padded(7, 2, 5),
            rtestmat.sign_combination_matrix_padded(7, 2, 5))

    @pytest.mark.parametrize("dim_kernel", [0, 2])
    def test_random_spd_spectrum(self, dim_kernel):
        n, cond = 16, 1e3
        gen = torch.Generator().manual_seed(0)
        S = testmat.random_spd(gen, n, cond, dim_kernel)
        assert torch.equal(S, S.T) or float(torch.max(torch.abs(S - S.T))) \
            < 1e-15
        ev = np.sort(np.linalg.eigvalsh(_np(S)))[::-1]
        want = np.sort(np.asarray(rtestmat.decaying_spectrum(
            n, cond, dim_kernel)))[::-1]
        assert float(np.max(np.abs(ev - want))) < 1e-10
        assert int(np.sum(np.abs(ev) < 1e-10)) == dim_kernel
        Q = testmat.random_orthogonal(gen, n)
        assert float(torch.max(torch.abs(Q.T @ Q - torch.eye(
            n, dtype=Q.dtype)))) < 1e-13

    def test_nasty_rhs_is_solvable(self):
        n = 10
        gen = torch.Generator().manual_seed(1)
        U = testmat.random_orthogonal(gen, n)
        d = testmat.decaying_spectrum(n, 1e6, 2)
        b = testmat.nasty_rhs(gen, d, U)
        w = U.T @ b
        assert float(torch.max(torch.abs(w[d == 0]))) < 1e-12
        assert bool(torch.all((w[d > 0] >= 1.0 - 1e-12)
                              & (w[d > 0] <= 3.0 + 1e-12)))


class TestOraclesAndFixtures:
    """test_utilities.py::TestOraclesAndFixtures."""

    def test_known_minimizer(self):
        obj = pb.norm_squared(4)
        km = testing.KnownMinimizer(x_star=_t(np.zeros(4)), objective=obj)
        assert km.is_minimizer(_t(np.full(4, 1e-3)))
        assert not km.is_minimizer(_t(np.ones(4)))
        assert "OK" in km.report(_t(np.zeros(4)))
        rkm = rtesting.KnownMinimizer(x_star=jnp.zeros(4),
                                      objective=rpb.norm_squared(4))
        assert km.report(_t(np.full(4, 0.1))) == rkm.report(
            jnp.full(4, 0.1))

    def test_prob_ab_feasible_iff(self):
        n = 12
        I_A = np.zeros(n); I_A[:3] = 1
        I_B = np.zeros(n); I_B[n // 2:] = 1
        feasible = testing.prob_ab(n, I_A, 0.4, -1.0, I_B, 0.5, -1.0)
        rfeas = rtesting.prob_ab(n, I_A, 0.4, -1.0, I_B, 0.5, -1.0)
        for blk, rblk in zip(feasible.blocks, rfeas.blocks):
            assert np.array_equal(_np(blk.G), np.asarray(rblk.G))
            assert np.array_equal(_np(blk.ub), np.asarray(rblk.ub))
        rep = phase1_simple(feasible, _t(np.full((1, n), 1.0 / n)))
        assert bool(rep.strictly_feasible[0])
        infeasible = testing.prob_ab(n, I_A, 0.6, -1.0, I_B, 0.55, -1.0)
        rep2 = phase1_by_reduction(infeasible, pb.sum_to_one(n),
                                   _t(np.full((1, n), 1.0 / n)))
        assert not bool(rep2.strictly_feasible[0])

    def test_random_feasible_constraints(self):
        n = 8
        gen = torch.Generator().manual_seed(0)
        x0 = torch.randn(n, generator=gen, dtype=torch.float64)
        cs = testing.random_feasible_constraints(gen, n, x0)
        assert bool(cs.satisfied_strictly(x0[None])[0])
        assert cs.m == 5 and float(torch.min(cs.margins(x0[None]))) > 0.99


class TestDiagnostics:
    """test_utilities.py::TestDiagnostics and test_round3.py::
    TestInfraReviewFixes::test_barrier_history_single_stage_params."""

    def test_solve_stats(self):
        from cvx_tpu import diagnostics as rdiag
        from cvx_tpu.models import DistKL as RefDistKL

        n = 12
        I_A = np.zeros(n); I_A[:3] = 1
        x0 = np.where(np.arange(n) < 3, 0.35 / 3, 0.65 / 9)
        prob = DistKL.create(n, H=_t(-I_A[None]), u=_t([-0.3]), device="cpu")
        rprob = RefDistKL.create(n, H=jnp.asarray(-I_A[None]),
                                 u=jnp.asarray([-0.3]))
        stats = diagnostics.solve_stats(prob.solve_jittable(_t(x0), "BR"))
        assert stats["newton_iters_total"] > 0
        assert stats["gap_max"] < 1e-7
        # every counter equal at tol = 1e-6 (see the module docstring)
        pars = dict(tol=1e-6)
        stats = diagnostics.solve_stats(prob.solve_jittable(
            _t(x0), "BR", SolverParams(**pars)))
        rstats = rdiag.solve_stats(rprob.solve_jittable(
            jnp.asarray(x0), "BR", RefParams(**pars)))
        assert stats == rstats

    def test_barrier_history(self):
        from cvx_tpu import diagnostics as rdiag

        obj = pb.norm_squared(4)
        cnts = pb.ConstraintSet(blocks=(pb.half_norm2_bounded(4, 8.0),))
        hist = diagnostics.barrier_history(obj, cnts, _t(np.full(4, 0.1)))
        rhist = rdiag.barrier_history(
            rpb.norm_squared(4),
            rpb.ConstraintSet(blocks=(rpb.half_norm2_bounded(4, 8.0),)),
            jnp.full(4, 0.1))
        assert len(hist) == len(rhist) >= 2
        for h, r in zip(hist, rhist):
            assert h["newton_iters"] == r["newton_iters"]
            assert abs(h["gap"] - r["gap"]) <= 1e-12 * r["gap"]
            assert abs(h["obj"] - r["obj"]) < 1e-12
        gaps = [h["gap"] for h in hist]
        assert gaps[-1] < 1e-8
        assert all(g2 < g1 for g1, g2 in zip(gaps, gaps[1:]))
        assert hist[-1]["obj"] < 1e-8

    def test_barrier_history_single_stage_params(self):
        n = 8
        I_A = np.zeros(n); I_A[:2] = 1.0
        prob = DistKL.create(n, H=_t(-I_A)[None], u=_t([-0.3]), device="cpu")
        x0 = 0.35 * I_A / 2 + 0.65 * (1 - I_A) / (n - 2)
        hist = diagnostics.barrier_history(prob.objective, prob.inequalities,
                                           _t(x0), eqs=prob.equalities,
                                           max_stages=25)
        assert hist[-1]["gap"] < 1e-6

    def test_trace_writes_chrome_trace(self, tmp_path):
        import json
        import os

        with diagnostics.trace(str(tmp_path)) as d:
            pb.norm_squared(3).value(_t(np.ones((2, 3))))
        with open(os.path.join(d, "trace.json")) as f:
            assert "traceEvents" in json.load(f)


class TestTree:
    """tree.py: flatten / unflatten / to over the port's records, static
    fields, and the exact-f32 guard (fault 1: the reference's mxu_exact
    wraps every solver entry, tree.py:54-74)."""

    def test_flatten_roundtrip_and_static(self):
        from cvx_tpu_torch.models import QP

        qp = QP.create(np.eye(3), np.ones((2, 3)), device="cpu")
        leaves, spec = tree.tree_flatten(qp)
        assert len(leaves) == 6          # P, a, G, h, A, b; n is static
        back = tree.tree_unflatten(spec, leaves)
        assert back.n == 3 and back == dataclasses.replace(qp)
        moved = tree.to(qp, "cpu", dtype=torch.float32)
        assert moved.P.dtype == torch.float32 and moved.n == 3
        leaves = tree.tree_leaves({"c": (1, _t(2.0)), "a": None,
                                   "b": _t(1.0)})   # dict keys sorted
        assert [v.item() for v in leaves] == [1.0, 2.0]

    def test_exact_f32_guard(self):
        """A CustomObjective records the matmul precision the solver sees:
        "highest" inside barrier_solve, the caller's setting after, also
        when the solve raises."""
        seen = []

        def fn(params, x):
            seen.append(torch.get_float32_matmul_precision())
            return 0.5 * torch.sum(x * x)

        obj = pb.CustomObjective(fn=fn)
        cnts = pb.ConstraintSet(blocks=(pb.half_norm2_bounded(
            3, 2.0, dtype=torch.float32),))
        x0 = torch.full((1, 3), 0.1)
        saved = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        try:
            torch.set_float32_matmul_precision("high")
            torch.backends.cuda.matmul.allow_tf32 = True
            sol = barrier_solve(obj, cnts, x0, SolverParams(tol=1e-4))
            assert seen and set(seen) == {"highest"}
            assert float(torch.max(torch.abs(sol.x))) < 1e-2
            assert torch.get_float32_matmul_precision() == "high"
            assert torch.backends.cuda.matmul.allow_tf32
            with pytest.raises(AttributeError):
                barrier_solve(obj, None, x0)
            assert torch.get_float32_matmul_precision() == "high"
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.set_float32_matmul_precision(saved[0])
            torch.backends.cuda.matmul.allow_tf32 = saved[1]
            torch.backends.cudnn.allow_tf32 = saved[2]


class TestKLRoutesAgree:
    """test_fuzz.py::TestKLRoutesAgree: dual (barrier), dual_fast,
    dual_fused (K1's plain version), BR_fast and BR on a random 2-row
    instance, all objectives within 1e-6, and of the reference's dual
    barrier."""

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_five_routes(self, seed):
        from cvx_tpu.models import DistKL as RefDistKL

        rng = np.random.default_rng(seed)
        n = 40
        nA = rng.integers(2, 6)
        idx = rng.permutation(n)
        I_A = np.zeros(n); I_A[idx[:nA]] = 1.0
        I_B = np.zeros(n); I_B[idx[nA:nA + n // 2]] = 1.0
        pA = float(rng.uniform(0.15, 0.45))
        pB = float(rng.uniform(0.55, 0.85))
        H, u = np.stack([-I_A, I_B]), np.array([-pA, pB])
        prob = DistKL.create(n, H=_t(H), u=_t(u), device="cpu")
        w = pA + 0.05
        x0 = _t((w / nA) * I_A + ((1 - w) / (n - nA)) * (1 - I_A))

        def kl(x):
            x = np.maximum(_np(x), 1e-300)
            return float(np.sum(x * np.log(n * x)))

        vals = {m: kl(prob.solve(method=m).x)
                for m in ("dual", "dual_fast", "dual_fused")}
        vals["BR_fast"] = kl(prob.solve_jittable(
            x0, method="BR_fast",
            pars=SolverParams(tol=1e-10, mu=30.0, kkt_method="chol")).x)
        vals["BR"] = kl(prob.solve_jittable(x0, method="BR",
                                            pars=SolverParams(tol=1e-9)).x)
        vals["reference dual"] = kl(RefDistKL.create(
            n, H=jnp.asarray(H), u=jnp.asarray(u)).solve(method="dual").x)
        lo, hi = min(vals.values()), max(vals.values())
        assert hi - lo < 1e-6, vals
