"""Port parity for the Newton engines: ``cvx_tpu_torch.solvers.newton``
against ``cvx_tpu.solvers.newton``, mirroring ``tests/test_newton.py``
(OptimizationProblems.scala normSquared / powerProblems).

The port runs a batch of instances in one masked loop; the reference is
vmapped over the same numpy starts.  Each instance must get the iterate
of its own unbatched run: x to 1e-10 and ``iters``, ``maxed_out`` and
``stalled`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvx_tpu import problem as rpb
from cvx_tpu.solvers.newton import newton_minimize as ref_newton
from cvx_tpu.solvers.newton import newton_minimize_eq as ref_newton_eq
from cvx_tpu.solvers.types import SolverParams as RefParams
from cvx_tpu_torch import problem as pb
from cvx_tpu_torch.solvers.newton import newton_minimize, newton_minimize_eq
from cvx_tpu_torch.solvers.types import SolverParams


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _fgh(obj):
    return lambda x: (obj.value(x), obj.grad(x), obj.hess(x))


def _free(x):
    return torch.ones(x.shape[:-1], dtype=torch.bool)


def _ref_free(x):
    return jnp.asarray(True)


def _same(res, ref, xtol=1e-10):
    assert np.max(np.abs(res.x.numpy() - np.asarray(ref.x))) <= xtol
    for flag in ("iters", "maxed_out", "stalled"):
        assert np.array_equal(getattr(res, flag).numpy(),
                              np.asarray(getattr(ref, flag))), flag


class TestUnconstrained:
    def test_norm_squared_batch(self):
        # test_newton.py::test_norm_squared and ::test_jit_and_vmap
        rng = np.random.default_rng(0)
        X0 = np.concatenate([1.0 + np.arange(6.0)[None],
                             5.0 * rng.standard_normal((7, 6))])
        obj, robj = pb.norm_squared(6), rpb.norm_squared(6)
        res = newton_minimize(_fgh(obj), _free, _t(X0), SolverParams(),
                              value_fn=obj.value)
        ref = jax.vmap(lambda x0: ref_newton(_fgh(robj), _ref_free, x0,
                                             RefParams()))(jnp.asarray(X0))
        _same(res, ref)
        assert float(res.x.abs().max()) < 1e-6
        assert int(res.iters.max()) <= 3 and not bool(res.stalled.any())

    def test_power_problems(self):
        # ::test_power_problem_identity and ::test_power_problem_
        # nontrivial_kernel, the objective given as a torch function
        rng = np.random.default_rng(1)
        cases = [(np.eye(2), np.ones(2), 2.0,
                  np.array([[-10.0, -10.0 + np.sqrt(2.0)], [3.0, -1.0]]), 200),
                 (np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0]]), np.ones(2),
                  1.5, 3.0 * rng.standard_normal((3, 3)), 500)]
        for A, alpha, q, X0, max_iter in cases:
            obj = pb.power_objective(_t(A), _t(alpha), q)
            robj = rpb.power_objective(jnp.asarray(A), jnp.asarray(alpha), q)
            res = newton_minimize(_fgh(obj), _free, _t(X0),
                                  SolverParams(max_iter=max_iter))
            ref = jax.vmap(lambda x0: ref_newton(
                _fgh(robj), _ref_free, x0, RefParams(max_iter=max_iter)))(
                jnp.asarray(X0))
            _same(res, ref)
            assert float(obj.value(res.x).max()) < 1e-7

    def test_early_stop(self):
        # phase-I style early exit: stop as soon as f < 10, per instance
        obj, robj = pb.norm_squared(4), rpb.norm_squared(4)
        X0 = np.stack([np.full(4, 100.0), np.full(4, 1.0)])
        res = newton_minimize(_fgh(obj), _free, _t(X0), SolverParams(),
                              stop_fn=lambda x: obj.value(x) < 10.0,
                              value_fn=obj.value)
        ref = jax.vmap(lambda x0: ref_newton(
            _fgh(robj), _ref_free, x0, RefParams(),
            stop_fn=lambda x: robj.value(x) < 10.0))(jnp.asarray(X0))
        _same(res, ref)
        assert float(obj.value(res.x)[0]) < 10.0
        assert int(res.iters[1]) == 0          # stopped before a step

    def test_failed_factorization_keeps_the_iterate(self):
        # a NaN Hessian gives a NaN step and a NaN decrement: the instance
        # takes no step (the true select keeps x) and its loop ends, as in
        # the reference; the other instance converges
        obj, robj = pb.norm_squared(3), rpb.norm_squared(3)

        def fgh(x):
            H = obj.hess(x).clone()
            H[1] = float("nan")
            return obj.value(x), obj.grad(x), H

        def ref_fgh(x, poisoned):
            H = jnp.where(poisoned, jnp.nan, robj.hess(x))
            return robj.value(x), robj.grad(x), H

        X0 = _t(np.ones((2, 3)))
        res = newton_minimize(fgh, _free, X0, SolverParams(),
                              value_fn=obj.value)
        ref = jax.vmap(lambda x0, p: ref_newton(
            lambda x: ref_fgh(x, p), _ref_free, x0, RefParams()))(
            jnp.ones((2, 3)), jnp.asarray([False, True]))
        _same(res, ref)
        assert torch.equal(res.x[1], X0[1])
        assert float(res.x[0].abs().max()) < 1e-6


class TestEqualityConstrained:
    def test_norm_squared_on_simplex(self):
        n = 8
        obj, eq = pb.norm_squared(n), pb.sum_to_one(n)
        X0 = np.stack([np.zeros(n), np.linspace(0.0, 1.0, n)])
        res = newton_minimize_eq(_fgh(obj), _free, _t(X0), eq.A, eq.b,
                                 SolverParams(), value_fn=obj.value)
        robj, req = rpb.norm_squared(n), rpb.sum_to_one(n)
        ref = jax.vmap(lambda x0: ref_newton_eq(
            _fgh(robj), _ref_free, x0, req.A, req.b, RefParams()))(
            jnp.asarray(X0))
        _same(res, ref)
        assert float((res.x - 1.0 / n).abs().max()) < 1e-8
        assert float(res.eq_gap.max()) < 1e-10

    def test_quadratic_with_equalities(self):
        rng = np.random.default_rng(2)
        n, p = 12, 3
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        P = (Q * np.logspace(0, -4, n)) @ Q.T
        P = 0.5 * (P + P.T)
        a = rng.standard_normal(n)
        A = rng.standard_normal((p, n))
        # per-instance right-hand sides against the shared rows
        b = np.stack([np.ones(p), np.linspace(-1.0, 1.0, p)])
        obj = pb.QuadraticObjective(P=_t(P), a=_t(a), r=_t(0.0))
        res = newton_minimize_eq(_fgh(obj), _free, _t(np.zeros((2, n))),
                                 _t(A), _t(b), SolverParams(),
                                 value_fn=obj.value)
        robj = rpb.QuadraticObjective(P=jnp.asarray(P), a=jnp.asarray(a),
                                      r=jnp.zeros(()))
        ref = jax.vmap(lambda bi: ref_newton_eq(
            _fgh(robj), _ref_free, jnp.zeros(n), jnp.asarray(A), bi,
            RefParams()))(jnp.asarray(b))
        _same(res, ref, 1e-9)
        for i in range(2):
            x = res.x[i].numpy()
            g = P @ x + a
            nu = np.linalg.lstsq(A.T, -g, rcond=None)[0]
            assert np.linalg.norm(A.T @ nu + g) < 1e-6
            assert np.linalg.norm(A @ x - b[i]) < 1e-8
