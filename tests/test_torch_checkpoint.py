"""Port parity for checkpoint / resume: ``cvx_tpu_torch.checkpoint``
(save_pytree, load_pytree, resume_barrier, resume_structured) against
``cvx_tpu.checkpoint`` on the same numpy data.  Mirrors
``tests/test_checkpoint.py`` (all), ``tests/test_round3.py::
TestResumeProduction`` (:457-525), ``::TestBatchedBarrierResume``
(:1378-1407), ``::TestCheckpointValidation`` (:581-601) and
``::TestInfraReviewFixes::test_checkpoint_suffix_roundtrip`` /
``test_batched_resume_structured`` (:960-999).  One test crosses the
packages: a batched ``Solution`` written by ``cvx_tpu.checkpoint
.save_pytree`` loads with the port's ``load_pytree`` and resumes to the
reference's result.

Tolerances (f64): the resumed x to 1e-8 of the reference's resume from
the same checkpoint, the flags exactly, and the reference tests' own
contracts (gap, objective against straight-through) on the port's
result; a loaded checkpoint bit for bit.  ``iters`` are not compared:
these resumes run at tol = 1e-9, where the last stopping decisions
compare a Newton decrement at its rounding level (67 / 70 / 70 against
65 / 65 / 68 steps on the dense fleet, x equal to 1e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu import checkpoint as rck
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.models.dist_kl import kl_dual_gap as ref_kl_dual_gap
from cvx_tpu.solvers.barrier import barrier_solve as ref_barrier_solve
from cvx_tpu.solvers.structured import \
    barrier_solve_structured as ref_structured
from cvx_tpu.solvers.types import SolverParams as RefParams
from cvx_tpu_torch import DistKL, interop
from cvx_tpu_torch.checkpoint import (load_pytree, resume_barrier,
                                      resume_structured, save_pytree)
from cvx_tpu_torch.models.dist_kl import kl_dual_gap
from cvx_tpu_torch.solvers import SolverParams, barrier_solve
from cvx_tpu_torch.solvers.structured import barrier_solve_structured
from cvx_tpu_torch.tree import replace, tree_leaves, tree_map

# Tier-1 runs six test processes on the CPU's cores, and every process
# imports every test file: one torch thread a process keeps torch's
# intra-op pools from oversubscribing the cores (the port's test files on
# 8 cores: 726 s with torch's default threads, 104 s with one)
torch.set_num_threads(1)

X64 = 1e-8


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _same_bits(a, b):
    """Equal tensors, NaN where the other is NaN."""
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                                b[~nan])
    return torch.equal(a, b)


def _close_x(got, want, tol=X64):
    err = float(np.max(np.abs(_np(got) - np.asarray(want))))
    assert err <= tol, err


def _pair(n, H, u):
    """(reference DistKL, port DistKL) of the same data, f64."""
    return (RefDistKL.create(n, H=jnp.asarray(H), u=jnp.asarray(u)),
            DistKL.create(n, H=_t(H), u=_t(u), device="cpu"))


def _problem(n=24):
    """test_checkpoint.py::_problem."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    w = 0.35
    x0 = (w / 3) * I_A + ((1 - w) / (n - 3)) * (1 - I_A)
    return _pair(n, np.stack([-I_A, I_B]), np.array([-0.3, 0.7])) + (x0,)


def _fleet(n, B_ws=(0.45, 0.55, 0.7)):
    """The batched-resume family of test_round3.py (:970, :1378): P(A) >=
    0.4 and strictly feasible starts of weight w on A."""
    I_A = np.zeros(n); I_A[:3] = 1.0
    ws = np.asarray(B_ws)
    x0s = ws[:, None] * I_A / 3 + (1 - ws)[:, None] * (1 - I_A) / (n - 3)
    return _pair(n, -I_A[None], np.array([-0.4])) + (x0s,)


class TestPytreeRoundTrip:
    """test_checkpoint.py::TestPytreeRoundTrip."""

    def test_solution_round_trip(self, tmp_path):
        _, prob, x0 = _problem()
        sol = prob.solve_jittable(_t(x0), method="BR_fast",
                                  pars=SolverParams(tol=1e-9))
        path = str(tmp_path / "sol.npz")
        assert save_pytree(path, sol) > 5
        back = load_pytree(path, tree_map(torch.zeros_like, sol))
        for a, b in zip(tree_leaves(sol), tree_leaves(back)):
            assert _same_bits(a, b)

    def test_structure_mismatch_raises(self, tmp_path):
        path = str(tmp_path / "x.npz")
        save_pytree(path, {"a": torch.ones(3)})
        with pytest.raises(ValueError, match="structure changed"):
            load_pytree(path, {"a": torch.ones(3), "b": torch.ones(2)})


class TestCheckpointValidation:
    """test_round3.py::TestCheckpointValidation and ::TestInfraReviewFixes
    ::test_checkpoint_suffix_roundtrip."""

    def test_shape_mismatch_raises(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        save_pytree(path, {"a": torch.ones(4), "b": torch.zeros(2, 2)})
        with pytest.raises(ValueError, match="leaf 0"):
            load_pytree(path, {"a": torch.ones(5), "b": torch.zeros(2, 2)})

    def test_dtype_mismatch_raises(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        save_pytree(path, {"a": torch.ones(4, dtype=torch.float32)})
        with pytest.raises(ValueError, match="leaf 0"):
            load_pytree(path, {"a": torch.ones(4, dtype=torch.float64)})

    def test_checkpoint_suffix_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(4.0), "b": torch.ones(2, 2)}
        p = str(tmp_path / "run1.ckpt")
        save_pytree(p, tree)
        back = load_pytree(p, tree)
        assert torch.equal(back["a"], tree["a"])


class TestResumeBarrier:
    """test_checkpoint.py::TestResumeBarrier, each resume against the
    reference's resume of the same data."""

    def test_resume_matches_straight_through(self, tmp_path):
        rprob, prob, x0 = _problem()
        pars = dict(tol=1e-9, mu=10.0)
        obj, cnts, eqs = prob.objective, prob.inequalities, prob.equalities
        full = barrier_solve(obj, cnts, _t(x0)[None], SolverParams(**pars),
                             eqs=eqs)
        partial = barrier_solve(obj, cnts, _t(x0)[None], SolverParams(
            **pars, outer_max_iter=3), eqs=eqs)
        assert float(partial.duality_gap[0]) > float(full.duality_gap[0])
        path = str(tmp_path / "ckpt.npz")
        save_pytree(path, partial)
        restored = load_pytree(path, tree_map(torch.zeros_like, partial))
        resumed = resume_barrier(obj, cnts, restored, SolverParams(**pars),
                                 eqs=eqs)
        assert float(resumed.duality_gap[0]) <= float(
            full.duality_gap[0]) * 1.01
        f_full = float(obj.value(full.x)[0])
        assert abs(f_full - float(obj.value(resumed.x)[0])) < 1e-8
        # the reference's resume of the reference's own partial run
        rp = ref_barrier_solve(rprob.objective, rprob.inequalities,
                               jnp.asarray(x0), RefParams(
                                   **pars, outer_max_iter=3),
                               eqs=rprob.equalities)
        rres = rck.resume_barrier(rprob.objective, rprob.inequalities, rp,
                                  RefParams(**pars), eqs=rprob.equalities)
        _close_x(resumed.x[0], rres.x)
        assert bool(resumed.stalled[0]) == bool(rres.stalled)

    def test_resume_single_instance(self):
        """An unbatched Solution (one instance's record) resumes to one."""
        rprob, prob, x0 = _problem()
        pars = dict(tol=1e-9, mu=10.0)
        partial = prob.solve_jittable(_t(x0), method="BR",
                                      pars=SolverParams(**pars,
                                                        outer_max_iter=3))
        assert partial.x.dim() == 1
        res = resume_barrier(prob.objective, prob.inequalities, partial,
                             SolverParams(**pars), eqs=prob.equalities)
        rp = rprob.solve_jittable(jnp.asarray(x0), method="BR", pars=RefParams(
            **pars, outer_max_iter=3))
        rres = rck.resume_barrier(rprob.objective, rprob.inequalities, rp,
                                  RefParams(**pars), eqs=rprob.equalities)
        assert res.x.dim() == 1
        _close_x(res.x, rres.x)

    def test_resume_refuses_unhealthy_checkpoint(self):
        _, prob, x0 = _problem()
        sol = prob.solve_jittable(_t(x0), method="BR_fast",
                                  pars=SolverParams(tol=1e-9))
        bad = replace(sol, duality_gap=torch.tensor(float("nan"),
                                                    dtype=torch.float64))
        with pytest.raises(ValueError, match="unhealthy"):
            resume_barrier(prob.objective, prob.inequalities, bad,
                           SolverParams(), eqs=prob.equalities)


class TestResumeProduction:
    """test_round3.py::TestResumeProduction (BR_fast)."""

    def _prob(self):
        n = 100
        IA = np.zeros(n); IA[:3] = 1.0
        IB = np.zeros(n); IB[n // 2:] = 1.0
        x0 = np.where(np.arange(n) < 3, 0.45 / 3, 0.55 / (n - 3))
        return _pair(n, np.stack([-IA, IB]), np.array([-0.4, 0.7])) + (x0,)

    def test_resume_br_fast_matches_straight_through(self, tmp_path):
        rprob, prob, x0 = self._prob()
        eqs = prob.equalities
        pars = dict(tol=1e-9, mu=20.0)
        sol_full = prob.solve_jittable(_t(x0), method="BR_fast",
                                       pars=SolverParams(**pars))
        sol_cut = prob.solve_jittable(_t(x0), method="BR_fast",
                                      pars=SolverParams(**pars,
                                                        outer_max_iter=2))
        assert float(sol_cut.duality_gap) > 1e-9
        path = str(tmp_path / "preempted.npz")
        save_pytree(path, sol_cut)
        sol_loaded = load_pytree(path, sol_cut)
        sol_res = resume_structured(prob.objective, prob.H, prob.u, eqs.A,
                                    eqs.b, sol_loaded, SolverParams(**pars))
        b1 = eqs.b[None]
        g_full = kl_dual_gap(prob.H, prob.u[None], eqs.A, b1,
                             sol_full.x[None])[0]
        g_res = kl_dual_gap(prob.H, prob.u[None], eqs.A, b1,
                            sol_res.x[None])[0]
        assert float(g_res) < 1e-9
        assert abs(float(g_res) - float(g_full)) < 1e-9
        assert float(torch.max(torch.abs(sol_res.x - sol_full.x))) < 1e-6
        # against the reference's resume of its own preempted run
        reqs = rprob.equalities
        rcut = rprob.solve_jittable(jnp.asarray(x0), method="BR_fast",
                                    pars=RefParams(**pars, outer_max_iter=2))
        rres = rck.resume_structured(rprob.objective, rprob.H, rprob.u,
                                     reqs.A, reqs.b, rcut, RefParams(**pars))
        _close_x(sol_res.x, rres.x)
        rg, _ = ref_kl_dual_gap(rprob.H, rprob.u, reqs.A, reqs.b, rres.x)
        assert abs(float(g_res) - float(rg)) < 1e-10

    def test_resume_finished_checkpoint_is_identity(self):
        _, prob, x0 = self._prob()
        eqs = prob.equalities
        pars = SolverParams(tol=1e-9, mu=20.0)
        sol = prob.solve_jittable(_t(x0), method="BR_fast", pars=pars)
        assert float(sol.duality_gap) <= 1e-9
        assert resume_structured(prob.objective, prob.H, prob.u, eqs.A,
                                 eqs.b, sol, pars) is sol

    def test_resume_unhealthy_raises(self):
        _, prob, x0 = self._prob()
        eqs = prob.equalities
        sol = prob.solve_jittable(_t(x0), method="BR_fast",
                                  pars=SolverParams(outer_max_iter=1))
        bad = replace(sol, duality_gap=torch.tensor(float("nan"),
                                                    dtype=torch.float64))
        with pytest.raises(ValueError, match="unhealthy"):
            resume_structured(prob.objective, prob.H, prob.u, eqs.A, eqs.b,
                              bad)


class TestBatchedResume:
    """test_round3.py::TestBatchedBarrierResume and ::TestInfraReviewFixes
    ::test_batched_resume_structured: a fleet checkpoint (per-instance t0)
    resumes converged and unconverged instances alike."""

    def test_batched_resume_barrier(self, tmp_path):
        rprob, prob, x0s = _fleet(10)
        cnts, eqs = prob.inequalities, prob.equalities
        short = dict(outer_max_iter=3, mu=10.0, tol=1e-9)
        mid = barrier_solve(prob.objective, cnts, _t(x0s),
                            SolverParams(**short), eqs=eqs)
        assert float(mid.duality_gap.min()) > 1e-9
        p = str(tmp_path / "dense_fleet")
        save_pytree(p, mid)
        fin = resume_barrier(prob.objective, cnts, load_pytree(p, mid),
                             SolverParams(mu=10.0, tol=1e-9), eqs=eqs)
        assert tuple(fin.x.shape) == (3, 10)
        assert float(fin.duality_gap.max()) < 1e-8
        assert not bool(fin.stalled.any())
        rmid = jax.vmap(lambda x0: ref_barrier_solve(
            rprob.objective, rprob.inequalities, x0, RefParams(**short),
            eqs=rprob.equalities))(jnp.asarray(x0s))
        _close_x(mid.x, rmid.x)
        rfin = rck.resume_barrier(rprob.objective, rprob.inequalities, rmid,
                                  RefParams(mu=10.0, tol=1e-9),
                                  eqs=rprob.equalities)
        _close_x(fin.x, rfin.x)
        assert np.array_equal(_np(fin.stalled), np.asarray(rfin.stalled))

    def test_batched_resume_structured(self, tmp_path):
        rprob, prob, x0s = _fleet(12)
        eqs = prob.equalities
        short = dict(outer_max_iter=3, mu=10.0, tol=1e-9)
        mid = barrier_solve_structured(prob.objective, prob.H, prob.u,
                                       eqs.A, eqs.b, _t(x0s),
                                       SolverParams(**short))
        assert float(mid.duality_gap.min()) > 1e-9
        p = str(tmp_path / "fleet.npz")
        save_pytree(p, mid)
        fin = resume_structured(prob.objective, prob.H, prob.u, eqs.A,
                                eqs.b, load_pytree(p, mid),
                                SolverParams(mu=10.0, tol=1e-9))
        assert tuple(fin.x.shape) == (3, 12)
        assert float(fin.duality_gap.max()) < 1e-7
        assert not bool(fin.stalled.any())
        reqs = rprob.equalities
        rmid = jax.vmap(lambda x0: ref_structured(
            rprob.objective, rprob.H, rprob.u, reqs.A, reqs.b, x0,
            RefParams(**short)))(jnp.asarray(x0s))
        rfin = rck.resume_structured(rprob.objective, rprob.H, rprob.u,
                                     reqs.A, reqs.b, rmid,
                                     RefParams(mu=10.0, tol=1e-9))
        _close_x(fin.x, rfin.x)

    def test_t0_float_or_per_instance(self):
        """The t0 repair: a (B,) tensor of equal values gives the float's
        results, bit for bit, in both barriers."""
        _, prob, x0s = _fleet(10)
        eqs = prob.equalities
        pars = SolverParams(mu=10.0, tol=1e-6)
        t_vec = torch.full((3,), 7.0, dtype=torch.float64)
        a = barrier_solve(prob.objective, prob.inequalities, _t(x0s), pars,
                          eqs=eqs, t0=7.0)
        b = barrier_solve(prob.objective, prob.inequalities, _t(x0s), pars,
                          eqs=eqs, t0=t_vec)
        c = barrier_solve_structured(prob.objective, prob.H, prob.u, eqs.A,
                                     eqs.b, _t(x0s), pars, t0=7.0)
        d = barrier_solve_structured(prob.objective, prob.H, prob.u, eqs.A,
                                     eqs.b, _t(x0s), pars, t0=t_vec)
        for p, q in ((a, b), (c, d)):
            for u, v in zip(tree_leaves(p), tree_leaves(q)):
                assert _same_bits(u, v)


class TestCrossPackage:
    def test_reference_checkpoint_loads_and_resumes(self, tmp_path):
        """A batched Solution that cvx_tpu wrote loads into the port's
        own Solution template and resumes to the reference's result."""
        rprob, prob, x0s = _fleet(10)
        short = dict(outer_max_iter=3, mu=10.0, tol=1e-9)
        rmid = jax.vmap(lambda x0: ref_barrier_solve(
            rprob.objective, rprob.inequalities, x0, RefParams(**short),
            eqs=rprob.equalities))(jnp.asarray(x0s))
        path = str(tmp_path / "from_reference.npz")
        n_leaves = rck.save_pytree(path, rmid)
        # the port's own partial run of the same data is the template
        like = barrier_solve(prob.objective, prob.inequalities, _t(x0s),
                             SolverParams(**short), eqs=prob.equalities)
        assert len(tree_leaves(like)) == n_leaves
        loaded = load_pytree(path, like)
        ref_as_port = interop.solution_from_numpy(rmid, device="cpu")
        for a, b in zip(tree_leaves(loaded), tree_leaves(ref_as_port)):
            assert _same_bits(a, b)
        fin = resume_barrier(prob.objective, prob.inequalities, loaded,
                             SolverParams(mu=10.0, tol=1e-9),
                             eqs=prob.equalities)
        rfin = rck.resume_barrier(rprob.objective, rprob.inequalities, rmid,
                                  RefParams(mu=10.0, tol=1e-9),
                                  eqs=rprob.equalities)
        _close_x(fin.x, rfin.x)
        assert np.array_equal(_np(fin.stalled), np.asarray(rfin.stalled))
        assert float(fin.duality_gap.max()) < 1e-8
