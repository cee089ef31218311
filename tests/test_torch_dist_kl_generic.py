"""Port parity for ``DistKL`` through the generic core: every
``solve`` method, ``solve_jittable(_batch)`` with the generic methods,
``feasibility`` and ``feasibility_batch``, against ``cvx_tpu.models
.DistKL`` on the same numpy data.  Mirrors ``tests/test_kl.py``
(TestKL1, TestKL2, TestInfeasible, TestDualGap), ``tests/test_round2.py``
(:270-300, the dual route's polish) and ``tests/test_round5.py::
TestBatchedInfeasibility`` (:289-345, its ``_mixed_batch`` at :293).

Tolerances, f64:

* at ``tol = 1e-6`` from the same feasible point: x and the duality gap
  to 1e-10, lam to 1e-8 relative to 1 + |lam| (lam = 1/(t d), and the
  margins d ~ 1/t carry rounding of ~1e-16 absolute), ``iters``,
  ``maxed_out`` and ``stalled`` exactly;
* through phase-I (no feasible point given): the phase-I point agrees to
  1e-8 (it is the first point with slack below -tol_feas, and the
  nullspace basis comes from another LAPACK's QR), x to 1e-8 and the
  flags exactly;
* the dual routes: the barrier on the dual to 1e-12 before the polish;
  after it x to 1e-8 (the polish accepts a step by comparing values at
  their rounding level, so the two may take another step along a flat
  direction: 6e-9 measured on the mixed batch);
* at the default ``tol = 1e-8``: x to 1e-8 and the flags exactly;
* f32: x to 1e-4 relative to max |x|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.duality import solve_dual as ref_solve_dual
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu.solvers.phase1 import feasibility_analysis as ref_feasibility
from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.duality import solve_dual
from cvx_tpu_torch.solvers import InfeasibleProblemError
from cvx_tpu_torch.solvers.phase1 import feasibility_analysis

TOL_SOLUTION = 1e-2   # |f - f*| acceptance (Runner.scala:30)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a, np.float64)).to(dtype)


def _kl_value(x):
    x = np.maximum(np.asarray(x), 1e-300)
    return float(np.sum(x * np.log(len(x) * x)))


def _data(name, n=20):
    """kl_1A / kl_2A of OptimizationProblems.scala:217-244, 341-369 and
    infeasible_kl_1 (:379-405): A = {0,1,2}, B the upper half."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    if name == "kl1":
        return dict(H=np.stack([-I_A, I_B]), u=np.array([-0.36, 0.1]))
    if name == "kl2":
        return dict(A=np.stack([I_A, I_B]), r=np.array([0.36, 0.1]))
    return dict(H=np.stack([-I_A, -I_B]), u=np.array([-0.51, -0.51]))


def _analytic(name, n=20):
    """OptimizationProblems.scala:136-141 and :249-251 at n > 15."""
    x = np.zeros(n)
    x[:3] = 0.12
    x[3: n // 2] = 1.08 / (n - 6)
    x[n // 2:] = 0.2 / n
    return x


def _both(name, n=20, dtype=torch.float64):
    data = _data(name, n)
    ref = RefDistKL.create(n, **{k: jnp.asarray(v) for k, v in data.items()})
    port = DistKL.create(n, **{k: _t(v, dtype) for k, v in data.items()},
                         device="cpu")
    return ref, port


def _leaves(sol, ref, xtol, tight, fields=("x",), iters=None):
    """``fields`` within ``xtol``, the flags exactly; ``tight`` also lam
    and the gap; ``iters`` (default: ``tight``) the Newton step count."""
    for f in fields:
        a, b = getattr(sol, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert np.max(np.abs(a - b), initial=0.0) <= xtol, f
    if tight:
        lam, rlam = sol.lam.numpy(), np.asarray(ref.lam)
        assert np.max(np.abs(lam - rlam) / (1.0 + np.abs(rlam)),
                      initial=0.0) <= 1e-8
        ga, gb = sol.duality_gap.numpy(), np.asarray(ref.duality_gap)
        assert np.array_equal(np.isnan(ga), np.isnan(gb))
        assert np.nanmax(np.abs(ga - gb), initial=0.0) <= 1e-10
    flags = ("maxed_out", "stalled") + (
        ("iters",) if (tight if iters is None else iters) else ())
    for flag in flags:
        assert np.array_equal(getattr(sol, flag).numpy(),
                              np.asarray(getattr(ref, flag))), flag


class TestKL1:
    @pytest.mark.parametrize("method", ["dual", "dual_BR", "dual_PD", "BR",
                                        "PD", "fused", "BR_fast"])
    def test_matches_reference_and_analytic(self, method):
        # test_kl.py::TestKL1::test_matches_analytic (n = 20), every route
        # with phase-I where it is primal
        ref, port = _both("kl1")
        sol = port.solve(method=method)
        rsol = ref.solve(method=method)
        x = sol.x.numpy()
        assert abs(_kl_value(x) - _kl_value(_analytic("kl1"))) < TOL_SOLUTION
        assert x[:3].sum() >= 0.36 - 1e-4 and x[10:].sum() <= 0.1 + 1e-4
        assert abs(x.sum() - 1.0) < 1e-4
        _leaves(sol, rsol, 1e-8, False)

    def test_primal_dual_cross_check(self):
        _, port = _both("kl1")
        f_br = _kl_value(port.solve(method="BR").x.numpy())
        f_dual = _kl_value(port.solve(method="dual").x.numpy())
        assert abs(f_br - f_dual) < TOL_SOLUTION


class TestKL2:
    @pytest.mark.parametrize("method", ["dual", "BR", "PD"])
    def test_matches_reference_and_analytic(self, method):
        ref, port = _both("kl2")
        sol = port.solve(method=method)
        x = sol.x.numpy()
        assert abs(_kl_value(x) - _kl_value(_analytic("kl2"))) < TOL_SOLUTION
        assert abs(x[:3].sum() - 0.36) < 1e-4 and abs(x[10:].sum() - 0.1) \
            < 1e-4
        _leaves(sol, ref.solve(method=method), 1e-8, False)


class TestTightParity:
    @pytest.mark.parametrize("name", ["kl1", "kl2"])
    @pytest.mark.parametrize("method", ["BR", "PD"])
    def test_from_the_same_feasible_point(self, name, method):
        # the same strictly feasible start at tol = 1e-6: P(A) = .4 and
        # P(B) = .05 (kl1), or P(A) = .36 and P(B) = .1 exactly (kl2)
        ref, port = _both(name)
        pars, rpars = SolverParams(tol=1e-6), RefParams(tol=1e-6)
        pA, pB = (0.4, 0.05) if name == "kl1" else (0.36, 0.1)
        x0 = np.full(20, (1.0 - pA - pB) / 7)
        x0[:3], x0[10:] = pA / 3, pB / 10
        sol = port.solve(method, pars, feasible_point=_t(x0))
        rsol = ref.solve(method, rpars, feasible_point=jnp.asarray(x0))
        _leaves(sol, rsol, 1e-10, True)

    @pytest.mark.parametrize("name", ["kl1", "kl2"])
    def test_dual_barrier_before_and_after_the_polish(self, name):
        ref, port = _both(name)
        for steps, xtol in ((0, 1e-12), (3, 1e-8)):
            sol = solve_dual(port.neg_dual_objective(), port.num_ineq_dual,
                             port.dual_dim, port.primal_optimum,
                             pars=SolverParams(tol=1e-6), polish_steps=steps)
            rsol = ref_solve_dual(ref.neg_dual_objective(), ref.num_ineq_dual,
                                  ref.dual_dim, ref.primal_optimum,
                                  pars=RefParams(tol=1e-6),
                                  polish_steps=steps)
            _leaves(sol, jax.tree_util.tree_map(lambda a: a[None], rsol),
                    xtol, False, fields=("x", "lam", "nu"), iters=True)


class TestInfeasible:
    def test_infeasible_kl_detected(self):
        # test_kl.py::TestInfeasible: P(A), P(B) >= .51 on disjoint sets
        ref, port = _both("infeasible")
        rep = port.feasibility()
        rrep = ref.feasibility()
        assert not bool(rep.strictly_feasible)
        assert bool(rep.strictly_feasible) == bool(rrep.strictly_feasible)
        assert abs(float(rep.s_max) - float(rrep.s_max)) <= 1e-8
        with pytest.raises(InfeasibleProblemError):
            port.solve(method="BR")

    def test_feasible_report(self):
        ref, port = _both("kl1")
        rep, rrep = port.feasibility(), ref.feasibility()
        assert bool(rep.strictly_feasible) and bool(rrep.strictly_feasible)
        assert np.max(np.abs(rep.x.numpy() - np.asarray(rrep.x))) <= 1e-8


class TestDualGap:
    def test_dual_route_tight_gap(self):
        # test_kl.py::TestDualGap
        _, port = _both("kl1")
        sol = port.solve(method="dual")
        z = torch.cat([sol.lam, sol.nu])
        dual_val = -float(port.neg_dual_objective().value(z))
        assert abs(_kl_value(sol.x.numpy()) - dual_val) < 1e-5

    def test_polish_improves_f64_gap(self):
        # test_round2.py:270-300 on bench.py's family at n = 30
        n = 30
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        port = DistKL.create(n, H=_t(np.stack([-I_A, I_B])),
                             u=_t([-0.3, 0.7]), device="cpu")
        d = port.neg_dual_objective()
        raw = solve_dual(d, port.num_ineq_dual, port.dual_dim,
                         port.primal_optimum, polish_steps=0)
        sol = port.solve(method="dual")
        z_raw = torch.cat([raw.lam, raw.nu], dim=1)[0]
        z = torch.cat([sol.lam, sol.nu])
        v_raw, v_pol = float(d.value(z_raw)), float(d.value(z))
        assert v_pol <= v_raw
        gap_pol = abs(float(sol.x @ torch.log(n * sol.x)) + v_pol)
        assert gap_pol < 1e-8
        x_raw = raw.x[0]
        assert abs(float(x_raw @ torch.log(n * x_raw)) + v_raw) > gap_pol


def _mixed_batch(n=32, B=20, frac_infeasible=0.25, seed=0):
    """test_round5.py::TestBatchedInfeasibility::_mixed_batch: P(A) >= pA,
    P(A) <= qA, with qA < pA on every 4th instance."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    H = np.stack([-I_A, I_A])
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[:: int(1 / frac_infeasible)] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return H, np.stack([-pA, qA], axis=1), bad


class TestBatchedInfeasibility:
    def test_feasibility_analysis_flags_exactly(self):
        n, B = 32, 20
        H, u, bad = _mixed_batch(n, B)
        port = DistKL.create(n, H=_t(H), u=_t(np.zeros(2)), device="cpu")
        rep = feasibility_analysis(port._inequalities(_t(u)),
                                   _t(np.full((B, n), 1.0 / n)),
                                   SolverParams(), port.equalities)
        assert np.array_equal(rep.s_max.numpy() > 0.0, bad)
        assert np.array_equal(rep.strictly_feasible.numpy(), ~bad)

        def one(ui):
            prob = RefDistKL.create(n, H=jnp.asarray(H), u=ui)
            r = ref_feasibility(prob.inequalities, jnp.full((n,), 1.0 / n),
                                RefParams(), prob.equalities)
            return r.s_max, r.x

        s_ref, x_ref = jax.vmap(one)(jnp.asarray(u))
        assert np.max(np.abs(rep.s_max.numpy() - np.asarray(s_ref))) <= 1e-8
        assert np.max(np.abs(rep.x.numpy() - np.asarray(x_ref))) <= 1e-8

    def test_feasibility_batch_flags_exactly(self):
        n, B = 32, 20
        H, u, bad = _mixed_batch(n, B)
        port = DistKL.create(n, H=_t(H), u=_t(np.zeros(2)), device="cpu")
        pars = SolverParams(tol=1e-6, max_iter=60)
        s_max, strict = port.feasibility_batch(_t(u), pars)
        assert np.array_equal(s_max.numpy() > 0.0, bad)
        assert np.array_equal(strict.numpy(), ~bad)
        ref = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.zeros(2))
        rs, rstrict = ref.feasibility_batch(jnp.asarray(u),
                                            RefParams(tol=1e-6, max_iter=60))
        assert np.max(np.abs(s_max.numpy() - np.asarray(rs))) <= 1e-8
        assert np.array_equal(strict.numpy(), np.asarray(rstrict))


class TestBatchedRoutes:
    def _fleet(self, n=32, B=6):
        H, u, bad = _mixed_batch(n, 4 * B // 3 + 2)
        U = u[~bad][:B]
        w = -U[:, 0] + 0.5 * (U[:, 1] + U[:, 0])   # mid-band P(A)
        I_A = np.zeros(n); I_A[:3] = 1.0
        X0 = (w / 3)[:, None] * I_A + ((1 - w) / (n - 3))[:, None] * (1 - I_A)
        return H, U, X0

    @pytest.mark.parametrize("method,tight", [("BR", True), ("PD", True),
                                              ("dual", False),
                                              ("dual_PD", False)])
    def test_solve_jittable_batch(self, method, tight):
        # the written-out batch axis of the reference's vmap over
        # solve_jittable, at tol = 1e-6
        n = 32
        H, U, X0 = self._fleet(n)
        port = DistKL.create(n, H=_t(H), u=_t(np.zeros(2)), device="cpu")
        sol = port.solve_jittable_batch(_t(U), _t(X0), method,
                                        SolverParams(tol=1e-6))
        ref0 = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.zeros(2))
        rsol = jax.vmap(lambda ui, x0: dataclasses.replace(ref0, u=ui)
                        .solve_jittable(x0, method, RefParams(tol=1e-6)))(
            jnp.asarray(U), jnp.asarray(X0))
        _leaves(sol, rsol, 1e-10 if tight else 1e-8, tight, iters=True)
        assert not bool(sol.stalled.any())
        one = DistKL.create(n, H=_t(H), u=_t(U[0]), device="cpu") \
            .solve_jittable(_t(X0[0]), method, SolverParams(tol=1e-6))
        _leaves(one, jax.tree_util.tree_map(lambda a: a[0], rsol),
                1e-10 if tight else 1e-8, tight, iters=True)

    def test_default_tolerance(self):
        n = 32
        H, U, X0 = self._fleet(n)
        port = DistKL.create(n, H=_t(H), u=_t(np.zeros(2)), device="cpu")
        sol = port.solve_jittable_batch(_t(U), _t(X0), "BR")
        ref0 = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.zeros(2))
        rsol = jax.vmap(lambda ui, x0: dataclasses.replace(ref0, u=ui)
                        .solve_jittable(x0, "BR"))(jnp.asarray(U),
                                                   jnp.asarray(X0))
        _leaves(sol, rsol, 1e-8, False)
        assert float(sol.duality_gap.max()) < 1e-8

    def test_f32(self):
        n = 32
        H, U, X0 = self._fleet(n, B=3)
        port = DistKL.create(n, H=_t(H, torch.float32),
                             u=_t(np.zeros(2), torch.float32), device="cpu")
        ref0 = RefDistKL.create(n, H=jnp.asarray(H, jnp.float32),
                                u=jnp.zeros(2, jnp.float32))
        for method in ("BR", "dual"):
            sol = port.solve_jittable_batch(_t(U, torch.float32),
                                            _t(X0, torch.float32), method)
            assert sol.x.dtype == torch.float32
            rsol = jax.vmap(lambda ui, x0: dataclasses.replace(ref0, u=ui)
                            .solve_jittable(x0, method))(
                jnp.asarray(U, jnp.float32), jnp.asarray(X0, jnp.float32))
            rx = np.asarray(rsol.x)
            assert np.max(np.abs(sol.x.numpy() - rx)) <= 1e-4 * np.abs(rx).max()
