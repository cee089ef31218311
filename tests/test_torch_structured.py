"""Port parity for the structured barrier (``BR_fast``):
``DistKL.solve_jittable_batch(..., method="BR_fast")`` of the port, one
masked loop over the instance axis, against the reference's per-instance
``solve_jittable(method="BR_fast")`` vmapped over the same numpy inputs.

At ``tol = 1e-6`` every stopping decision sits far above the rounding
floor, so the two agree on every leaf: x and lam to 1e-12 (f64 summation
order), the schedule gap and eq_gap to 1e-12, and iters, maxed_out and
stalled exactly.  At the default ``tol = 1e-8`` the final stages run at
t ~ 1e9, where the Newton decrement is cancellation noise of ~1e-8 (the
reference says so at solvers/structured.py:167-172): the two may stop
one step apart, so there x agrees to 1e-8 and the flags exactly, and
iters is not compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.interop import solution_to_numpy
from cvx_tpu_torch.models.dist_kl import KLObjective
from cvx_tpu_torch.solvers.structured import (_woodbury_solver,
                                              barrier_solve_structured)

# (k inequality rows, mE extra equality rows, prior)
SHAPES = [(0, 1, False), (1, 0, False), (3, 0, False), (2, 1, False),
          (2, 0, True)]


def _problem(k, m_eq, prior, n=24, B=4, seed=0):
    """Random rows with a strictly feasible x0 shared by B instances whose
    bounds differ (tests/test_round5.py::_family's draw)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    U = np.stack([H @ x0 + rng.uniform(0.05, 0.15, k) for _ in range(B)])
    data = {}
    if k:
        data.update(H=H, u=np.zeros(k))
    if m_eq:
        A = rng.uniform(0.0, 1.0, (m_eq, n))
        data.update(A=A, r=A @ x0)
    if prior:
        data["prior"] = rng.uniform(0.5, 1.5, n)
    return data, U.reshape(B, k), np.repeat(x0[None], B, axis=0)


def _solve_both(data, U, X0, method, pars):
    n = X0.shape[1]
    k = U.shape[1]
    ref0 = RefDistKL.create(n, **{a: jnp.asarray(v) for a, v in data.items()})

    def one(u, x0):
        prob = dataclasses.replace(ref0, u=u) if k else ref0
        return prob.solve_jittable(x0, method=method, pars=RefParams(**pars))

    ref = jax.jit(jax.vmap(one))(jnp.asarray(U), jnp.asarray(X0))
    port = DistKL.create(n, **{a: torch.from_numpy(np.asarray(v))
                               for a, v in data.items()}, device="cpu")
    got = port.solve_jittable_batch(torch.from_numpy(U),
                                    torch.from_numpy(X0), method=method,
                                    pars=SolverParams(**pars))
    return ref, solution_to_numpy(got)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("k,m_eq,prior", SHAPES)
def test_br_fast_matches_reference_leaf_for_leaf(k, m_eq, prior):
    ref, got = _solve_both(*_problem(k, m_eq, prior), "BR_fast",
                           dict(tol=1e-6))
    for leaf, ref_val in vars(ref).items():
        a = got[leaf]
        if ref_val is None:
            assert a is None, leaf
            continue
        b = np.asarray(ref_val)
        assert a.shape == b.shape, leaf
        if leaf in ("x", "lam", "duality_gap", "eq_gap"):
            assert np.max(np.abs(a - b)) <= 1e-12, leaf
        elif a.dtype.kind == "f":           # unmeasured diagnostics: NaN
            assert np.all(np.isnan(a)) and np.all(np.isnan(b)), leaf
        else:                               # iters and the flags
            assert np.array_equal(a, b), leaf
    assert not got["stalled"].any()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("k,m_eq,prior", [(1, 0, False), (2, 1, False)])
def test_br_fast_default_tolerance(k, m_eq, prior):
    ref, got = _solve_both(*_problem(k, m_eq, prior, seed=3), "BR_fast", {})
    assert np.max(np.abs(got["x"] - np.asarray(ref.x))) <= 1e-8
    assert np.max(np.abs(got["duality_gap"]
                         - np.asarray(ref.duality_gap))) <= 1e-12
    for flag in ("maxed_out", "stalled"):
        assert np.array_equal(got[flag], np.asarray(getattr(ref, flag)))
    assert np.max(got["duality_gap"]) < 1e-8 and not got["stalled"].any()


@pytest.mark.timeout(120)
def test_poisoned_instance_is_flagged_and_frozen():
    # tests/test_round2.py::TestPerInstanceStatus::test_poisoned_instance_
    # flagged: exactly the NaN instance stalls, keeps a finite frozen
    # iterate, and the others converge
    data, U, X0 = _problem(2, 0, False, B=4, seed=1)
    U[2, 0] = np.nan
    ref, got = _solve_both(data, U, X0, "BR_fast", dict(tol=1e-8))
    assert got["stalled"].tolist() == [False, False, True, False]
    assert np.array_equal(got["stalled"], np.asarray(ref.stalled))
    assert np.array_equal(got["x"][2], X0[2])
    assert np.array_equal(got["iters"][2], np.asarray(ref.iters)[2])
    assert np.max(got["duality_gap"][[0, 1, 3]]) < 1e-7


@pytest.mark.timeout(60)
def test_woodbury_solver_inverts_the_barrier_hessian():
    # H = diag(h) + U^T diag(w) U, solved per instance without forming it;
    # delta = 0 so the shift does not enter
    rng = np.random.default_rng(4)
    B, k, n = 3, 2, 9
    h = rng.uniform(0.5, 2.0, (B, n))
    U = rng.standard_normal((k, n))
    w = rng.uniform(0.5, 2.0, (B, k))
    r = rng.standard_normal((B, n))
    R = rng.standard_normal((B, n, 2))
    solve = _woodbury_solver(torch.from_numpy(h), torch.from_numpy(U),
                             torch.from_numpy(w), 0.0)
    Hd = (np.stack([np.diag(hi) for hi in h])
          + np.einsum("kn,bk,km->bnm", U, w, U))
    assert np.allclose(solve(torch.from_numpy(r)).numpy(),
                       np.linalg.solve(Hd, r[..., None])[..., 0],
                       rtol=0, atol=1e-12)
    assert np.allclose(solve(torch.from_numpy(R)).numpy(),
                       np.linalg.solve(Hd, R), rtol=0, atol=1e-12)


@pytest.mark.timeout(60)
def test_objective_matches_reference():
    from cvx_tpu.models.dist_kl import KLObjective as RefObjective

    rng = np.random.default_rng(6)
    x = rng.uniform(0.01, 0.2, (3, 12))
    lp = np.log(rng.uniform(0.5, 1.5, 12) / 12)
    for log_prior in (None, lp):
        ours = KLObjective(12, None if log_prior is None
                           else torch.from_numpy(log_prior))
        ref = RefObjective(12, None if log_prior is None
                           else jnp.asarray(log_prior))
        for i in range(3):
            xi = x[i]
            assert abs(float(ours.value(torch.from_numpy(xi)))
                       - float(ref.value(jnp.asarray(xi)))) <= 1e-15
            for f in ("grad", "hess", "hess_diag"):
                assert np.allclose(getattr(ours, f)(torch.from_numpy(xi)),
                                   np.asarray(getattr(ref, f)(
                                       jnp.asarray(xi))),
                                   rtol=0, atol=1e-13), f
    # batched points: one value per instance
    assert ours.value(torch.from_numpy(x)).shape == (3,)
    sol = barrier_solve_structured(
        ours, torch.zeros((0, 12), dtype=torch.float64),
        torch.zeros((3, 0), dtype=torch.float64),
        torch.ones((1, 12), dtype=torch.float64),
        torch.ones((3, 1), dtype=torch.float64),
        torch.full((3, 12), 1.0 / 12, dtype=torch.float64))
    # min KL to the prior on the simplex is the prior itself
    p = np.exp(lp) / np.exp(lp).sum()
    assert np.max(np.abs(sol.x.numpy() - p)) < 1e-8
