"""Port parity for the dual fallback and the measured certificate:
``kl_dual_gap`` and the cold ``kl_certify`` (batched over instances)
against the reference's vmapped per-instance functions;
``solve_dual_newton`` (method="dual_fast") and the fallback past dual dim
16 of ``solve_dual_fused`` and ``solve_certified_batch``, on the same
numpy inputs.

Tolerances (all f64): the measured gap to 1e-12 and z to 1e-9 relative to
1 + |z| (the least-squares fit and the line-searched polish run the same
steps; only summation order differs); x of the dual routes to 1e-10; the
certified x to 1e-11; every flag exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.models.dist_kl import kl_certify as ref_kl_certify
from cvx_tpu.models.dist_kl import kl_dual_gap as ref_kl_dual_gap
from cvx_tpu_torch import DistKL
from cvx_tpu_torch.duality import _small_solve
from cvx_tpu_torch.interop import solution_to_numpy
from cvx_tpu_torch.models.dist_kl import kl_certify, kl_dual_gap

GAP_TOL = 1e-12
Z_TOL = 1e-9


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float64)))


def _bench(B, n, seed=0):
    """bench.py's family (tests/test_round2.py::bench_family) with the
    analytic feasible starts and their barrier-solved optima."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    pA = rng.uniform(0.2, 0.5, B)
    U = np.column_stack([-pA, rng.uniform(0.55, 0.8, B)])
    w = pA + 0.05
    X0 = (w / 3)[:, None] * I_A + ((1 - w) / (n - 3))[:, None] * (1 - I_A)
    return np.stack([-I_A, I_B]), U, X0


def _zdiff(a, b):
    return np.max(np.abs(a - b) / (1.0 + np.abs(b)))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("prior", [False, True])
def test_kl_dual_gap_matches_reference(prior):
    # tests/test_kl.py:198-206 and test_round2.py::TestMeasuredGap: the
    # gap at a far start (large) and at a converged primal (tiny)
    n, B = 40, 4
    H, U, X0 = _bench(B, n)
    p = np.random.default_rng(1).uniform(0.5, 1.5, n) if prior else None
    port = DistKL.create(n, H=_t(H), u=_t(U[0]), prior=None if p is None
                         else _t(p), device="cpu")
    x_opt = port.solve_jittable_batch(_t(U), _t(X0), method="BR_fast").x
    A, b = np.ones((1, n)), np.ones((B, 1))
    pj = None if p is None else jnp.asarray(p / p.sum())
    for X in (X0, x_opt.numpy()):
        g_ref, z_ref = jax.vmap(lambda ui, bi, xi: ref_kl_dual_gap(
            jnp.asarray(H), ui, jnp.asarray(A), bi, xi, prior=pj))(
                jnp.asarray(U), jnp.asarray(b), jnp.asarray(X))
        gap, z = kl_dual_gap(_t(H), _t(U), _t(A), _t(b), _t(X),
                             prior=port.prior)
        assert np.max(np.abs(gap.numpy() - np.asarray(g_ref))) <= GAP_TOL
        assert _zdiff(z.numpy(), np.asarray(z_ref)) <= Z_TOL
        assert np.all(z.numpy()[:, :2] >= 0)        # lam dual feasible
    assert np.all(kl_dual_gap(_t(H), _t(U), _t(A), _t(b), _t(X0),
                              prior=port.prior)[0].numpy() > 1e-3)
    assert np.all(np.abs(gap.numpy()) < 1e-8)       # the optimum certifies


@pytest.mark.timeout(120)
def test_cold_kl_certify_matches_reference():
    # the cold branch (z0=None) refines a primal route's f32-quality x
    n, B = 30, 3
    H, U, X0 = _bench(B, n, seed=2)
    A, b = np.ones((1, n)), np.ones((B, 1))
    port = DistKL.create(n, H=_t(H), u=_t(U[0]), device="cpu")
    X = port.solve_jittable_batch(_t(U), _t(X0), method="BR_fast").x.numpy()
    X = (X * (1.0 + 1e-6 * np.sin(np.arange(n)))).astype(np.float32)
    ref = jax.vmap(lambda ui, bi, xi: ref_kl_certify(
        jnp.asarray(H), ui, jnp.asarray(A), bi, xi, polish_steps=6))(
            jnp.asarray(U), jnp.asarray(b), jnp.asarray(X))
    got = kl_certify(_t(H), _t(U), _t(A), _t(b), torch.from_numpy(X),
                     polish_steps=6)
    for f in ("x", "gap", "ineq_res", "eq_res"):
        assert np.max(np.abs(getattr(got, f).numpy()
                             - np.asarray(getattr(ref, f)))) <= 1e-11, f
    for f in ("lam", "nu"):
        assert _zdiff(getattr(got, f).numpy(),
                      np.asarray(getattr(ref, f))) <= Z_TOL, f
    assert np.max(np.abs(got.gap.numpy())) <= 1e-8


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dim", [1, 2, 3, 5, 8, 12])
def test_small_solve_branches(dim):
    from cvx_tpu.duality import _small_solve as ref_small_solve

    rng = np.random.default_rng(dim)
    M = rng.standard_normal((3, dim, dim))
    A = M @ M.transpose(0, 2, 1) + dim * np.eye(dim)
    b = rng.standard_normal((3, dim))
    ref = jax.vmap(ref_small_solve)(jnp.asarray(A), jnp.asarray(b))
    got = _small_solve(_t(A), _t(b)).numpy()
    assert np.max(np.abs(got - np.asarray(ref))) <= 1e-12
    assert np.max(np.abs(got - np.linalg.solve(A, b[..., None])[..., 0])) \
        <= 1e-10


@pytest.mark.timeout(120)
def test_solve_dual_newton_matches_reference():
    # tests/test_round2.py::TestDualFastRoutes::test_matches_analytic
    n, pA = 100, 0.4
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    data = dict(H=np.stack([-I_A, I_B]), u=np.array([-pA, 0.7]))
    ref = RefDistKL.create(n, **{k: jnp.asarray(v) for k, v in data.items()})
    port = DistKL.create(n, **{k: _t(v) for k, v in data.items()},
                         device="cpu")
    s_ref = ref.solve(method="dual_fast")
    s = port.solve(method="dual_fast")
    xs = np.full(n, (1 - pA) / (n - 3)); xs[:3] = pA / 3
    assert np.max(np.abs(s.x.numpy() - xs)) < 1e-8
    got = solution_to_numpy(s)
    for leaf in ("x", "eq_gap", "ineq_res"):
        assert np.max(np.abs(got[leaf] - np.asarray(getattr(s_ref, leaf)))) \
            <= 1e-10, leaf
    assert abs(got["duality_gap"] - float(s_ref.duality_gap)) <= GAP_TOL
    assert 0 <= float(s.duality_gap) + 1e-12 < 1e-8
    for leaf in ("lam", "nu"):
        assert _zdiff(got[leaf], np.asarray(getattr(s_ref, leaf))) <= Z_TOL
    assert abs(got["norm_grad"] - float(s_ref.norm_grad)) <= 1e-9
    for leaf in ("iters", "maxed_out", "stalled"):
        assert got[leaf] == np.asarray(getattr(s_ref, leaf)), leaf


def _dim20(n=30, B=3, seed=7):
    """Dual dim 20 = 19 inequality rows + sum-to-one: past the fused
    kernels' 16, so the reference takes dual_fast
    (tests/test_round3.py::test_fallback_beyond_dim5 at a larger dim)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (19, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.02, 0.1, 19)
    return H, np.stack([u * s for s in np.linspace(1.0, 1.05, B)])


@pytest.mark.timeout(120)
def test_dual_fused_falls_back_past_dim_16():
    H, U = _dim20()
    ref = RefDistKL.create(30, H=jnp.asarray(H), u=jnp.asarray(U[0]))
    port = DistKL.create(30, H=_t(H), u=_t(U[0]), device="cpu")
    assert port.dual_dim == ref.dual_dim == 20
    s_ref = ref.solve_dual_fused()
    s = port.solve_dual_fused()
    assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) <= 1e-10
    assert abs(float(s.duality_gap) - float(s_ref.duality_gap)) <= GAP_TOL
    assert int(s.iters) == int(s_ref.iters) == 30
    assert bool(s.stalled) == bool(s_ref.stalled) is False
    # solve(method="dual_fused") and solve_jittable agree with it
    assert torch.equal(port.solve(method="dual_fused").x, s.x)
    assert torch.equal(port.solve_jittable(None, method="dual_fast").x, s.x)


@pytest.mark.timeout(120)
def test_certified_batch_falls_back_past_dim_16():
    # tests/test_round2.py:311-340 and test_round3.py:270 at dim 20: the
    # cold dual_fast solve (>= 30 steps) then the f64 warm finish
    H, U = _dim20()
    H32, U32 = H.astype(np.float32), U.astype(np.float32)
    ref = RefDistKL.create(30, H=jnp.asarray(H32),
                           u=jnp.zeros((19,), jnp.float32),
                           dtype=jnp.float32)
    s_ref = ref.solve_certified_batch(jnp.asarray(U32))
    port = DistKL.create(30, H=torch.from_numpy(H32), u=torch.zeros(19),
                         device="cpu")
    s = port.solve_certified_batch(torch.from_numpy(U32))
    got = solution_to_numpy(s)
    assert np.max(np.abs(got["x"] - np.asarray(s_ref.x))) <= 1e-11
    assert np.max(np.abs(got["duality_gap"]
                         - np.asarray(s_ref.duality_gap))) <= 1e-10
    assert np.max(np.abs(got["duality_gap"])) <= 1e-8
    for leaf in ("iters", "maxed_out", "stalled"):
        assert np.array_equal(got[leaf], np.asarray(getattr(s_ref, leaf)))
    assert np.all(got["iters"] == 32) and not got["stalled"].any()
    with pytest.raises(ValueError, match="fused_cert needs"):
        port.solve_certified_batch(torch.from_numpy(U32), fused_cert=True)
