"""Port parity for the barrier solver, the primal-dual solver and phase-I:
``cvx_tpu_torch.solvers`` against ``cvx_tpu.solvers``, mirroring
``tests/test_barrier_phase1.py`` and its flagship minX1_no_FP
(SimpleOptimizationProblems.scala:89-137): minimize x0 subject to
x1 >= exp(x0) and x1 <= r + k x0, optimum (-1, 1/e).

The port runs a batch in one masked loop; the reference is vmapped over
the same numpy data.  At ``tol = 1e-6`` in f64: x to 1e-10, the duality
gap to 1e-10, lam to 1e-8 relative to 1 + |lam| (lam = 1/(t d) divides
by margins d ~ 1/t, so rounding of d at 1e-16 becomes ~1e-9 of lam), and
``iters``, ``maxed_out``, ``stalled`` and the feasibility flags exactly.
At the default ``tol = 1e-8``: x to 1e-8 and the flags exactly.
Phase-I stops at the first point with slack below -tol_feas, so its
candidate is compared to 1e-8 and its flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu import problem as rpb
from cvx_tpu import solvers as rsv
from cvx_tpu_torch import problem as pb
from cvx_tpu_torch import solvers as sv

E = float(np.e)
R0, K0 = 0.5 * (E + 1 / E), 0.5 * (E - 1 / E)
TOL_SOLUTION = 1e-2   # |f(x) - f*| acceptance (Runner.scala:30)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _minx1(shift=0.0):
    """minX1's constraints in both packages; ``shift`` (B,) moves the
    linear row's bound per instance."""
    shift = np.atleast_1d(np.asarray(shift, np.float64))
    port = pb.ConstraintSet(blocks=(
        pb.NonlinearBlock(fn=lambda p, x: torch.stack([torch.exp(x[0])
                                                       - x[1]]),
                          ub=_t([0.0]), num=1, in_dim=2),
        pb.LinearBlock(G=_t([[-K0, 1.0]]), c=_t([0.0]),
                       ub=_t(R0 + shift[:, None]))))

    def ref(s):
        return rpb.ConstraintSet(blocks=(
            rpb.NonlinearBlock(fn=lambda p, x: jnp.array([jnp.exp(x[0])
                                                          - x[1]]),
                               params=None, ub=jnp.zeros(1), num=1, in_dim=2),
            rpb.LinearBlock(G=jnp.array([[-K0, 1.0]]), c=jnp.zeros(1),
                            ub=jnp.array([R0]) + s)))

    return port, ref, shift


def _objs():
    return (pb.LinearObjective(a=_t([1.0, 0.0]), r=_t(0.0)),
            rpb.LinearObjective(a=jnp.array([1.0, 0.0]), r=jnp.zeros(())))


def _same(sol, ref, xtol=1e-10, tight=True):
    """x within ``xtol`` and the flags exactly; ``tight`` (tol = 1e-6 from
    the same start) also lam and the duality gap."""
    assert np.max(np.abs(sol.x.numpy() - np.asarray(ref.x))) <= xtol
    if tight:
        lam, rlam = sol.lam.numpy(), np.asarray(ref.lam)
        assert np.max(np.abs(lam - rlam) / (1.0 + np.abs(rlam))) <= 1e-8
        assert np.max(np.abs(sol.duality_gap.numpy()
                             - np.asarray(ref.duality_gap))) <= 1e-10
    for flag in ("iters", "maxed_out", "stalled"):
        assert np.array_equal(getattr(sol, flag).numpy(),
                              np.asarray(getattr(ref, flag))), flag


def _same_report(rep, ref, xtol=1e-8):
    assert np.max(np.abs(rep.x.numpy() - np.asarray(ref.x))) <= xtol
    assert np.array_equal(rep.strictly_feasible.numpy(),
                          np.asarray(ref.strictly_feasible))
    assert np.array_equal(rep.s_max.numpy() > 0, np.asarray(ref.s_max) > 0)


class TestPhase1:
    def test_simple_finds_feasible_point(self):
        cnts, ref, _ = _minx1()
        rep = sv.phase1_simple(cnts, _t(np.zeros((1, 2))))
        rrep = rsv.phase1_simple(ref(0.0), jnp.zeros(2))
        assert bool(rep.strictly_feasible[0]) and float(rep.s_max[0]) < 0
        assert bool(cnts.satisfied_strictly(rep.x)[0])
        _same_report(rep, jax.tree_util.tree_map(lambda a: a[None], rrep))

    def test_detects_infeasibility(self):
        G, ub = np.array([[1.0], [-1.0]]), np.array([-1.0, -1.0])
        cnts = pb.ConstraintSet(blocks=(pb.LinearBlock(
            G=_t(G), c=_t(np.zeros(2)), ub=_t(ub)),))
        rep = sv.phase1_simple(cnts, _t(np.zeros((1, 1))))
        rrep = rsv.phase1_simple(rpb.ConstraintSet(blocks=(rpb.LinearBlock(
            G=jnp.asarray(G), c=jnp.zeros(2), ub=jnp.asarray(ub)),)),
            jnp.zeros(1))
        assert not bool(rep.strictly_feasible[0]) and float(rep.s_max[0]) > 0
        assert abs(float(rep.s_max[0]) - float(rrep.s_max)) <= 1e-10
        with pytest.raises(sv.InfeasibleProblemError, match="violated"):
            sv.find_feasible_point(cnts, _t(np.zeros((1, 1))))

    def test_soi_localizes_violation(self):
        G = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]])
        ub = np.array([-1.0, -1.0, 5.0])
        cnts = pb.ConstraintSet(blocks=(pb.LinearBlock(
            G=_t(G), c=_t(np.zeros(3)), ub=_t(ub)),))
        rep = sv.phase1_soi(cnts, _t(np.zeros((1, 2))))
        rrep = rsv.phase1_soi(rpb.ConstraintSet(blocks=(rpb.LinearBlock(
            G=jnp.asarray(G), c=jnp.zeros(3), ub=jnp.asarray(ub)),)),
            jnp.zeros(2))
        s = rep.slacks[0].numpy()
        assert not bool(rep.strictly_feasible[0])
        assert s[0] + s[1] > 0.5 and s[2] < 1e-4
        assert np.max(np.abs(s - np.asarray(rrep.slacks))) <= 1e-8

    @pytest.mark.parametrize("method", ["reduction", "eqs_as_ineqs"])
    def test_with_equalities(self, method):
        # x >= 0 with sum(x) = 1, from two starts
        n = 6
        X0 = np.stack([np.zeros(n), np.linspace(-1.0, 2.0, n)])
        rep = sv.feasibility_analysis(pb.ConstraintSet(
            blocks=(pb.positivity(n),)), _t(X0), eqs=pb.sum_to_one(n),
            method=method)
        rrep = jax.vmap(lambda x0: rsv.feasibility_analysis(
            rpb.ConstraintSet(blocks=(rpb.positivity(n),)), x0,
            eqs=rpb.sum_to_one(n), method=method))(jnp.asarray(X0))
        _same_report(rep, rrep)
        assert float(rep.x.min()) > 0
        assert float(rep.eq_error.max()) < (1e-8 if method == "reduction"
                                            else 1e-4)


class TestBarrierEndToEnd:
    @pytest.mark.parametrize("tol", [1e-6, 1e-8])
    def test_minx1_batch_with_feasible_point(self, tol):
        # ::test_minx1_with_feasible_point and ::test_whole_solve_jits_
        # and_vmaps: a batch of shifted bounds in one call
        cnts, ref, shift = _minx1(np.linspace(0.0, 0.5, 4))
        obj, robj = _objs()
        sol = sv.barrier_solve(obj, cnts, _t(np.tile([0.0, 1.01], (4, 1))),
                               sv.SolverParams(tol=tol))
        rsol = jax.vmap(lambda s: rsv.barrier_solve(
            robj, ref(s), jnp.array([0.0, 1.01]), rsv.SolverParams(tol=tol)))(
            jnp.asarray(shift))
        if tol == 1e-6:
            _same(sol, rsol)
        else:
            _same(sol, rsol, xtol=1e-8, tight=False)
        assert abs(float(sol.x[0, 0]) + 1.0) < TOL_SOLUTION
        assert abs(float(sol.x[0, 1]) - 1 / E) < TOL_SOLUTION
        assert float(sol.duality_gap.max()) < tol
        assert float(sol.x[-1, 0]) < float(sol.x[0, 0])

    def test_minx1_no_feasible_point(self):
        """The minimum end-to-end slice: phase-I, then the barrier."""
        cnts, ref, _ = _minx1()
        obj, robj = _objs()
        x0 = sv.find_feasible_point(cnts, _t(np.zeros((1, 2))))
        sol = sv.barrier_solve(obj, cnts, x0)
        rx0 = rsv.find_feasible_point(ref(0.0), jnp.zeros(2))
        rsol = rsv.barrier_solve(robj, ref(0.0), rx0)
        assert np.max(np.abs(x0.numpy()[0] - np.asarray(rx0))) <= 1e-8
        assert abs(float(obj.value(sol.x)[0]) + 1.0) < TOL_SOLUTION
        assert abs(float(sol.x[0, 1]) - 1 / E) < TOL_SOLUTION
        assert np.max(np.abs(sol.x.numpy()[0] - np.asarray(rsol.x))) <= 1e-8
        assert bool(sol.stalled[0]) == bool(rsol.stalled)

    def test_simplex_quadratic_with_equalities(self):
        # joptP2 (SimpleOptimizationProblems.scala:347-371): min x'Px on
        # the simplex, x* = (.5, .5); phase-I by reduction, then the barrier
        # with the equality-constrained Newton
        P = np.array([[1.0, 0.4], [0.4, 1.0]])
        obj = pb.QuadraticObjective(P=_t(2 * P), a=_t(np.zeros(2)),
                                    r=_t(0.0))
        cnts, eqs = pb.ConstraintSet(blocks=(pb.positivity(2),)), \
            pb.sum_to_one(2)
        x0 = sv.find_feasible_point(cnts, _t(np.full((1, 2), 2.0)), eqs=eqs)
        sol = sv.barrier_solve(obj, cnts, x0, eqs=eqs)
        assert float((sol.x - 0.5).abs().max()) < TOL_SOLUTION
        robj = rpb.QuadraticObjective(P=jnp.asarray(2 * P), a=jnp.zeros(2),
                                      r=jnp.zeros(()))
        rcnts = rpb.ConstraintSet(blocks=(rpb.positivity(2),))
        rsol = rsv.barrier_solve(robj, rcnts, jnp.asarray(x0.numpy()[0]),
                                 eqs=rpb.sum_to_one(2))
        _same(sol, jax.tree_util.tree_map(lambda a: a[None], rsol), 1e-8,
              tight=False)

    def test_primal_dual_matches_reference(self):
        # the primal-dual method (PrimalDualSolver.scala) on minX1's batch
        cnts, ref, shift = _minx1(np.linspace(0.0, 0.5, 3))
        obj, robj = _objs()
        pars = sv.SolverParams(tol=1e-6)
        sol = sv.primal_dual_solve(obj, cnts, _t(np.tile([0.0, 1.01], (3, 1))),
                                   pars)
        rsol = jax.vmap(lambda s: rsv.primal_dual_solve(
            robj, ref(s), jnp.array([0.0, 1.01]), rsv.SolverParams(tol=1e-6)))(
            jnp.asarray(shift))
        _same(sol, rsol)
        assert abs(float(sol.x[0, 0]) + 1.0) < TOL_SOLUTION

    def test_mixed_dtypes_promote(self):
        # an f32 start against f64 constraint data computes in f64, as the
        # reference's promotion (barrier.py:49-52)
        cnts, _, _ = _minx1()
        obj, _ = _objs()
        x0 = torch.tensor([[0.0, 1.01]], dtype=torch.float32)
        for solve in (sv.barrier_solve, sv.primal_dual_solve):
            sol = solve(obj, cnts, x0, sv.SolverParams(tol=1e-6))
            assert sol.x.dtype == torch.float64
            assert abs(float(sol.x[0, 0]) + 1.0) < TOL_SOLUTION
