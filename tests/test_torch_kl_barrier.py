"""Port parity for K3: ``cvx_tpu_torch.ops.kl_barrier.kl_barrier_fused``
(its plain PyTorch version, which the wrapper runs for CPU tensors) against
the JAX reference kernel ``cvx_tpu.ops.pallas_kl.kl_barrier_fused`` in
interpret mode, on the same inputs made with numpy from fixed seeds.

Tolerances: f64 inputs agree to max |dx| <= 1e-11 (summation order only:
the reference pads n and sums in another order); f32 inputs to max |dx| <=
1e-5 (late Armijo decisions at t ~ 1e10 sit at the f32 resolution of the
barrier value, so another summation order may take another candidate and
move x by ~1e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.ops import pallas_kl as ref_mod
from cvx_tpu_torch.ops import kl_barrier
from cvx_tpu_torch.ops.kl_barrier import (kl_barrier_fused,
                                          kl_barrier_fused_plain)

F64_TOL = 1e-11
F32_TOL = 1e-5
# the reference's default schedule and bench.py's production one
SCHEDULES = {"default": {}, "production": dict(mu=55.0, n_inner=3)}


def _family(B, n, k, seed=0):
    """bench.py's family (P(A) >= pA, |A| = 3; P(B) <= pB, B the upper
    half; the first k of the two rows) with its analytic feasible start
    (bench.py:164-168); the sum-to-one row as A x = b."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    pA = rng.uniform(0.2, 0.5, B)
    pB = rng.uniform(0.55, 0.8, B)
    w = pA + 0.05
    X0 = (w / 3)[:, None] * I_A + ((1 - w) / (n - 3))[:, None] * (1 - I_A)
    Hs = np.repeat(np.stack([-I_A, I_B])[None, :k], B, axis=0)
    U = np.column_stack([-pA, pB])[:, :k]
    return Hs, U, np.ones((B, 1, n)), np.ones((B, 1)), X0


def _both(arrays, dtype, **kw):
    """(reference x, port x) as numpy arrays for one batch."""
    ref = ref_mod.kl_barrier_fused(
        *(jnp.asarray(a.astype(dtype)) for a in arrays), interpret=True, **kw)
    got = kl_barrier_fused(
        *(torch.from_numpy(np.ascontiguousarray(a.astype(dtype)))
          for a in arrays), **kw)
    return np.asarray(ref), got.numpy()


@pytest.mark.timeout(60)
@pytest.mark.parametrize("m,t0,mu,tol", [(3, 1.0, 30.0, 1e-8),
                                         (102, 1.0, 55.0, 1e-8),
                                         (102, 2.0, 10.0, 1e-6),
                                         (1, 1.0, 1e9, 1.0)])
def test_schedule_helpers_equal_reference(m, t0, mu, tol):
    n_outer = kl_barrier.fused_n_outer(m, t0=t0, mu=mu, tol=tol)
    assert n_outer == ref_mod.fused_n_outer(m, t0=t0, mu=mu, tol=tol)
    assert kl_barrier.fused_final_t(m, t0=t0, mu=mu, tol=tol) == \
        ref_mod.fused_final_t(m, t0=t0, mu=mu, tol=tol)
    assert kl_barrier.fused_final_t(m, mu=mu, n_outer=4) == \
        ref_mod.fused_final_t(m, mu=mu, n_outer=4)
    # tests/test_round2.py: the production schedule is 7 stages at n = 100
    assert kl_barrier.fused_n_outer(102, mu=55.0) == 7


@pytest.mark.timeout(120)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_matches_reference(dtype, k, n, schedule):
    B = 5 if k == 2 else 3
    ref, got = _both(_family(B, n, k, seed=n + k), dtype,
                     **SCHEDULES[schedule])
    assert got.dtype == dtype and got.shape == (B, n)
    assert np.all(np.isfinite(got))
    tol = F64_TOL if dtype == np.float64 else F32_TOL
    assert np.max(np.abs(got - ref)) <= tol


@pytest.mark.timeout(60)
def test_no_step_guard_holds_an_instance_on_a_bound():
    # instance 1 starts with one coordinate at 0: log 0 and 1/0 make its
    # dx non-finite, and the guard where(s_best > 0, x + s dx, x) keeps it
    # at x0 where a blend would write NaN; instance 0 solves normally
    Hs, U, A, b, X0 = _family(2, 16, 2, seed=5)
    X0[1, 7] = 0.0
    ref, got = _both((Hs, U, A, b, X0), np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.array_equal(got[1], X0[1]) and np.array_equal(ref[1], X0[1])
    assert np.max(np.abs(got[0] - ref[0])) <= F64_TOL


@pytest.mark.timeout(60)
def test_shape_errors_match_reference():
    # tests/test_round2.py::TestFusedFallback::
    # test_kernel_rejects_k0_p2_with_clear_error, and k = 3
    n, B = 16, 2
    cases = {
        "k <= 2": (np.zeros((B, 0, n)), np.zeros((B, 0)), np.ones((B, 1, n)),
                   np.ones((B, 1)), np.full((B, n), 1.0 / n)),
        "p = 1": (np.zeros((B, 1, n)), np.ones((B, 1)), np.ones((B, 2, n)),
                  np.ones((B, 2)), np.full((B, n), 1.0 / n)),
        "k=3": (np.zeros((B, 3, n)), np.ones((B, 3)), np.ones((B, 1, n)),
                np.ones((B, 1)), np.full((B, n), 1.0 / n)),
    }
    for match, arrays in cases.items():
        with pytest.raises(ValueError, match=match):
            ref_mod.kl_barrier_fused(*(jnp.asarray(a) for a in arrays),
                                     interpret=True)
        with pytest.raises(ValueError, match=match):
            kl_barrier_fused(*(torch.from_numpy(a) for a in arrays))


@pytest.mark.timeout(60)
def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _family(4, 20, 2, seed=9)]
    before = kl_barrier_fused.launches
    x = kl_barrier_fused(*arrays, mu=55.0, n_inner=3)
    assert torch.equal(x, kl_barrier_fused_plain(*arrays, mu=55.0,
                                                 n_inner=3))
    assert kl_barrier_fused.launches == before      # no kernel launched
    # shared rows as stride-0 expands give the same x as copies
    Hs, U, A, b, X0 = arrays
    x2 = kl_barrier_fused(Hs[:1].expand(4, -1, -1), U, A[:1].expand(4, -1, -1),
                          b, X0, mu=55.0, n_inner=3)
    assert torch.equal(x, x2)
    with pytest.raises(ValueError, match="do not agree"):
        kl_barrier_fused(Hs, U[:3], A, b, X0)
