"""Port parity for the problem-modeling layer: ``cvx_tpu_torch.problem``
against ``cvx_tpu.problem``, mirroring ``tests/test_problem_modeling.py``:
objectives (autodiff-derived against hand formulas), constraint blocks,
the fused barrier assembly against a per-constraint fold and against the
reference, the phase-I lifts, equalities, domains, and the ``interop``
helpers that carry the reference's records across.

The port evaluates at a batch of points (B, n); the reference is vmapped
over the same numpy points.  A user function (``CustomObjective``,
``NonlinearBlock``) is given twice, a ``jnp`` body for the reference and
a ``torch`` body for the port.  Every value, gradient and Hessian agrees
to 1e-12 (f64 summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, vmap

from cvx_tpu import problem as rpb
from cvx_tpu_torch import interop
from cvx_tpu_torch import problem as pb

TOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b), initial=0.0) <= tol


def _sets(seed=0, n=5):
    """The reference test's set: 3 linear rows, ||x||^2/2 <= 50 and
    positivity, in both packages."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((3, n))
    ref = rpb.ConstraintSet(blocks=(
        rpb.LinearBlock(G=jnp.asarray(G), c=jnp.zeros(3), ub=jnp.ones(3) * 10),
        rpb.half_norm2_bounded(n, 50.0), rpb.positivity(n)))
    port = pb.ConstraintSet(blocks=(
        pb.LinearBlock(G=_t(G), c=_t(np.zeros(3)), ub=_t(np.ones(3) * 10)),
        pb.half_norm2_bounded(n, 50.0), pb.positivity(n)))
    return ref, port


def _exp_blocks(dim=2):
    """The minX1 constraint exp(x0) - x1 <= 0 in both packages."""
    ref = rpb.NonlinearBlock(fn=lambda p, x: jnp.array([jnp.exp(x[0]) - x[1]]),
                             params=None, ub=jnp.zeros(1), num=1, in_dim=dim)
    port = pb.NonlinearBlock(fn=lambda p, x: torch.stack([torch.exp(x[0])
                                                          - x[1]]),
                             ub=_t([0.0]), num=1, in_dim=dim)
    return ref, port


class TestObjectives:
    def test_quadratic_matches_custom(self):
        rng = np.random.default_rng(1)
        n = 7
        P = 2.0 * np.eye(n) + 0.5
        a = rng.standard_normal(n)
        X = rng.standard_normal((4, n))
        quad = pb.QuadraticObjective(P=_t(P), a=_t(a), r=_t(1.5))
        cust = pb.CustomObjective(
            fn=lambda prm, x: 1.5 + prm[1] @ x + 0.5 * x @ (prm[0] @ x),
            params=(_t(P), _t(a)))
        ref = rpb.QuadraticObjective(P=jnp.asarray(P), a=jnp.asarray(a),
                                     r=jnp.asarray(1.5))
        for f in ("value", "grad", "hess"):
            got = getattr(quad, f)(_t(X))
            _close(got, getattr(cust, f)(_t(X)), 1e-12)
            _close(got, jax.vmap(getattr(ref, f))(jnp.asarray(X)))

    def test_p_norm_and_power(self):
        rng = np.random.default_rng(2)
        X = np.abs(rng.standard_normal((3, 5))) + 0.1
        obj = pb.p_norm_p(5, 4.0)
        _close(obj.value(_t(X)), np.sum(X ** 4, axis=1))
        _close(obj.grad(_t(X)), 4 * X ** 3, 1e-11)
        ref = rpb.p_norm_p(5, 4.0)
        _close(obj.hess(_t(X)), jax.vmap(ref.hess)(jnp.asarray(X)), 1e-10)
        pw = pb.power_objective(_t(np.eye(3)), _t(np.ones(3)), q=2.0)
        assert float(pw.value(_t(np.zeros((1, 3))))[0]) == 0.0
        x = np.array([[1.0, -2.0, 0.5]])
        _close(pw.value(_t(x)), np.sum(x ** 4, axis=1))

    def test_affine_pullback_structured(self):
        rng = np.random.default_rng(3)
        n, k = 6, 3
        P = np.eye(n) + 0.1
        a = rng.standard_normal(n)
        z, F = rng.standard_normal(n), rng.standard_normal((n, k))
        U = rng.standard_normal((4, k))
        obj = pb.QuadraticObjective(P=_t(P), a=_t(a), r=_t(0.7))
        pulled = pb.affine_pullback(obj, _t(z), _t(F))
        assert isinstance(pulled, pb.QuadraticObjective)
        X = z + U @ F.T
        _close(pulled.value(_t(U)), obj.value(_t(X)))
        _close(pulled.grad(_t(U)), obj.grad(_t(X)) @ _t(F))
        lin = pb.affine_pullback(pb.LinearObjective(a=_t(a), r=_t(0.2)),
                                 _t(z), _t(F))
        _close(lin.value(_t(U)), 0.2 + X @ a)
        # the generic pullback of a custom objective
        cust = pb.affine_pullback(pb.CustomObjective(
            fn=lambda prm, x: torch.sum(x ** 4)), _t(z), _t(F))
        ref = rpb.affine_pullback(rpb.CustomObjective(
            fn=lambda prm, x: jnp.sum(x ** 4)), jnp.asarray(z), jnp.asarray(F))
        for f in ("value", "grad", "hess"):
            _close(getattr(cust, f)(_t(U)),
                   jax.vmap(getattr(ref, f))(jnp.asarray(U)), 1e-10)

    def test_per_instance_objective(self):
        # a leaf with a leading batch axis: one linear objective per instance
        rng = np.random.default_rng(4)
        a, r, X = (rng.standard_normal((3, 5)), rng.standard_normal(3),
                   rng.standard_normal((3, 5)))
        obj = pb.LinearObjective(a=_t(a), r=_t(r))
        _close(obj.value(_t(X)), r + np.sum(a * X, axis=1))
        cand = _t(np.repeat(X[:, None], 2, axis=1))
        _close(obj.value(cand), np.repeat((r + np.sum(a * X, 1))[:, None], 2,
                                          axis=1))


class TestBlocks:
    def test_linear_block(self):
        rng = np.random.default_rng(5)
        G = rng.standard_normal((4, 6))
        blk = pb.LinearBlock(G=_t(G), c=_t(np.arange(4.0)), ub=_t(np.ones(4)))
        X = np.ones((2, 6))
        _close(blk.value(_t(X)), np.arange(4.0) + X @ G.T)
        _close(blk.jac(_t(X)), G)
        _close(blk.whess(_t(X), _t(np.ones((2, 4)))), np.zeros((2, 6, 6)))

    def test_quad_block_vs_autodiff_and_reference(self):
        rng = np.random.default_rng(6)
        m, n = 3, 5
        P = rng.standard_normal((m, n, n))
        P = 0.5 * (P + np.swapaxes(P, 1, 2))
        a = rng.standard_normal((m, n))
        X = rng.standard_normal((2, n))
        W = np.array([[1.0, -2.0, 0.5], [0.3, 0.2, -1.0]])
        blk = pb.QuadBlock(P=_t(P), a=_t(a), r=_t(np.zeros(m)),
                           ub=_t(np.ones(m)))
        ref = rpb.QuadBlock(P=jnp.asarray(P), a=jnp.asarray(a),
                            r=jnp.zeros(m), ub=jnp.ones(m))
        _close(blk.value(_t(X)), jax.vmap(ref.value)(jnp.asarray(X)))
        _close(blk.jac(_t(X)), vmap(torch.func.jacfwd(
            lambda x: blk.value(x[None])[0]))(_t(X)))
        _close(blk.whess(_t(X), _t(W)),
               jax.vmap(ref.whess)(jnp.asarray(X), jnp.asarray(W)))

    def test_nonlinear_block_autodiff(self):
        ref, blk = _exp_blocks()
        X = np.array([[0.3, 2.0], [-0.4, 1.0]])
        W = np.array([[2.0], [0.5]])
        _close(blk.value(_t(X)), jax.vmap(ref.value)(jnp.asarray(X)))
        _close(blk.jac(_t(X)), jax.vmap(ref.jac)(jnp.asarray(X)))
        _close(blk.whess(_t(X), _t(W)),
               jax.vmap(ref.whess)(jnp.asarray(X), jnp.asarray(W)))
        _close(blk.jac(_t(X))[0], [[np.exp(0.3), -1.0]])
        # values at line-search candidates (B, L, n)
        assert blk.value(_t(X)[:, None].expand(2, 3, 2)).shape == (2, 3, 1)

    def test_lifts(self):
        lifted = pb.positivity(3).lift_phase1()
        assert lifted.dim == 4
        xs = np.array([[-1.0, 2.0, 3.0, 5.0]])
        _close(lifted.value(_t(xs)), -xs[:, :3] - 5.0)
        soi = pb.positivity(2).lift_soi(n_total=2, offset=0)
        _close(soi.value(_t([[-1.0, 2.0, 3.0, 4.0]])),
               [[1.0 - 3.0, -2.0 - 4.0]])
        ref, blk = _exp_blocks()
        xs = np.array([[0.3, 2.0, 0.7]])
        _close(blk.lift_phase1().value(_t(xs)),
               jax.vmap(ref.lift_phase1().value)(jnp.asarray(xs)))
        xs = np.array([[0.3, 2.0, 0.7, 0.1]])
        _close(blk.lift_soi(2, 1).value(_t(xs)),
               jax.vmap(ref.lift_soi(2, 1).value)(jnp.asarray(xs)))

    def test_abs_sum_bounded_matches_reference(self):
        """tests/test_qp_model.py::TestAbsSum: the 2^(q-p) sign rows on
        coordinates [p, q), against the reference's block."""
        blk, ref = pb.abs_sum_bounded(4, 1, 3, 2.0), rpb.abs_sum_bounded(
            4, 1, 3, 2.0)
        assert blk.m == ref.m == 4
        _close(blk.G, ref.G, 0.0)
        _close(blk.ub, ref.ub, 0.0)
        xs = np.array([[5.0, 1.0, -0.5, 7.0], [0.0, 1.5, -1.0, 0.0]])
        _close(blk.value(_t(xs)), jax.vmap(ref.value)(jnp.asarray(xs)), 0.0)
        # |x_1| + |x_2| = 1.5 <= 2 whatever the other coordinates; 2.5 > 2
        assert torch.all(blk.value(_t(xs)) <= blk.ub, dim=-1).tolist() == \
            [True, False]


class TestConstraintSet:
    def test_views(self):
        _, cs = _sets()
        assert cs.m == 3 + 1 + 5
        X = _t(np.full((2, 5), 0.5))
        assert cs.value(X).shape == (2, 9)
        assert cs.jac(X).shape == (2, 9, 5)
        assert cs.satisfied_strictly(X).tolist() == [True, True]
        assert bool(torch.all(cs.lambda_init(X) > 0))

    def test_barrier_assembly_vs_fold_and_reference(self):
        """The fused barrier equals the per-constraint fold
        (BarrierSolver.scala:280-316) and the reference's assembly."""
        ref, cs = _sets()
        obj, robj = pb.norm_squared(5), rpb.norm_squared(5)
        X = np.stack([np.full(5, 0.5), np.linspace(0.1, 0.9, 5)])
        t = np.array([3.0, 0.5])
        val, g, H = cs.barrier_value_grad_hess(obj, _t(t), _t(X))
        for i in range(2):
            d = cs.margins(_t(X))[i].numpy()
            G = cs.jac(_t(X))[i].numpy()
            g_ref, H_ref = t[i] * X[i], t[i] * np.eye(5)
            for j in range(cs.m):
                g_ref = g_ref + G[j] / d[j]
                H_ref = H_ref + np.outer(G[j], G[j]) / d[j] ** 2
            H_ref = H_ref + np.eye(5) / d[3]
            _close(g[i], g_ref, 1e-12)
            _close(H[i], H_ref, 1e-10)
        rv, rg, rH = jax.vmap(lambda tt, x: ref.barrier_value_grad_hess(
            robj, tt, x))(jnp.asarray(t), jnp.asarray(X))
        _close(val, rv)
        _close(g, rg)
        _close(H, rH, 1e-10)

    def test_barrier_grad_hess_vs_autodiff(self):
        _, cs = _sets()
        obj = pb.norm_squared(5)
        X = _t(np.full((1, 5), 0.5))
        _, g, H = cs.barrier_value_grad_hess(obj, 2.0, X)

        def f(x):
            return cs.barrier_value(obj, 2.0, x[None])[0]

        _close(g[0], grad(f)(X[0]), 1e-10)
        _close(H[0], hessian(f)(X[0]), 1e-8)

    def test_phase1_and_soi_sets(self):
        ref, cs = _sets()
        X0 = _t(np.full((1, 5), 20.0))     # infeasible for the quad row
        assert not bool(cs.satisfied_strictly(X0)[0])
        xs = cs.phase1_feasible_point(X0)
        assert xs.shape == (1, 6)
        assert bool(cs.lift_phase1().satisfied_strictly(xs)[0])
        _close(xs[0], ref.phase1_feasible_point(jnp.full(5, 20.0)))
        xs = cs.soi_feasible_point(X0)
        assert xs.shape == (1, 5 + 9)
        assert bool(cs.lift_soi().satisfied_strictly(xs)[0])
        _close(xs[0], ref.soi_feasible_point(jnp.full(5, 20.0)))

    def test_per_instance_bounds(self):
        # test_problem_modeling.py::TestConstraintSet::test_vmap_over_
        # instances: per-instance rows (B, m, n) and per-instance bounds
        # (B, m) against one set of points, as the reference's vmap
        rng = np.random.default_rng(7)
        n, B = 4, 8
        G = rng.standard_normal((B, 2, n))
        ub = rng.uniform(1.0, 2.0, (B, 2))
        cs = pb.ConstraintSet(blocks=(pb.LinearBlock(G=_t(G), c=_t(
            np.zeros(2)), ub=_t(ub)), pb.positivity(n)))
        X = np.full((B, n), 0.1)
        val, g, H = cs.barrier_value_grad_hess(pb.norm_squared(n), 1.0, _t(X))

        def one(Gi, ui, x):
            c = rpb.ConstraintSet(blocks=(
                rpb.LinearBlock(G=Gi, c=jnp.zeros(2), ub=ui),
                rpb.positivity(n)))
            return c.barrier_value_grad_hess(rpb.norm_squared(n), 1.0, x)

        rv, rg, rH = jax.vmap(one)(*(jnp.asarray(v) for v in (G, ub, X)))
        _close(val, rv)
        _close(g, rg)
        _close(H, rH, 1e-10)
        assert cs.barrier_value(pb.norm_squared(n), 1.0, _t(X)[:, None]
                                .expand(B, 3, n)).shape == (B, 3)


class TestEquality:
    def test_stack_error_pullback_lift(self):
        n = 6
        w = np.arange(n, dtype=np.float64)
        eq = pb.sum_to_one(n).stack(pb.expectation_eq(_t(w), 2.0))
        assert eq.p == 2
        x = np.full((1, n), 1.0 / n)
        assert float(eq.error(_t(x))[0]) == pytest.approx(
            abs(w.sum() / n - 2.0), abs=1e-12)
        ss = eq.solution_space()
        assert float(eq.error(ss.z0[None])[0]) < 1e-12
        assert eq.as_inequalities(1e-6).m == 4
        lifted = pb.sum_to_one(4).lift_phase1()
        assert lifted.A.shape == (1, 5) and float(lifted.A[0, 4]) == 0.0
        rng = np.random.default_rng(8)
        z, F = rng.standard_normal(n), rng.standard_normal((n, 3))
        pulled = eq.affine_pullback(_t(z), _t(F))
        u = rng.standard_normal((2, 3))
        _close(pulled.error(_t(u)), eq.error(_t(z + u @ F.T)), 1e-12)


class TestSetsAndInterop:
    def test_domains(self):
        dom = pb.positive_orthant(3)
        X = _t([[1.0, 2.0, 3.0], [1.0, -1.0, 2.0]])
        assert dom.contains(X).tolist() == [True, False]
        lifted = dom.lift(2)
        assert lifted.contains(_t([[1.0, 1.0, 1.0, -5.0, -5.0]])).tolist() \
            == [True]
        assert lifted.sample.shape == (5,)
        prod = pb.cartesian_product(dom, pb.whole_space(2), 3)
        assert prod.contains(_t([[1.0, 1.0, 1.0, -5.0, 2.0]])).tolist() == \
            [True]
        _, cs = _sets()
        sfs = pb.strictly_feasible_set(cs, _t(np.full(5, 0.5)))
        assert sfs.contains(_t(np.full((1, 5), 0.5))).tolist() == [True]
        with pytest.raises(ValueError, match="strictly"):
            pb.strictly_feasible_set(cs, _t(np.full(5, 20.0)))

    def test_interop_carries_reference_records(self):
        ref, _ = _sets()
        cs = interop.constraint_set_from_numpy(ref, device="cpu")
        X = np.array([[0.5, 0.4, 0.3, 0.2, 0.1]])
        _close(cs.value(_t(X)), jax.vmap(ref.value)(jnp.asarray(X)))
        eq = interop.equality_from_numpy(rpb.sum_to_one(5), device="cpu")
        assert float(eq.error(_t(X))[0]) == pytest.approx(0.5, abs=1e-15)
        lo = interop.linear_objective_from_numpy(
            rpb.LinearObjective(a=jnp.arange(5.0), r=jnp.asarray(1.0)),
            device="cpu")
        _close(lo.value(_t(X)), 1.0 + X @ np.arange(5.0))
        qo = interop.quadratic_objective_from_numpy(rpb.norm_squared(5),
                                                    device="cpu")
        _close(qo.value(_t(X)), 0.5 * np.sum(X * X, axis=1))
        nl_ref, _ = _exp_blocks()
        with pytest.raises(TypeError, match="torch fn"):
            interop.constraint_set_from_numpy(
                rpb.ConstraintSet(blocks=(nl_ref,)), device="cpu")
