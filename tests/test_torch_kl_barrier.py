"""Port parity for K3: ``cvx_tpu_torch.ops.kl_barrier.kl_barrier_fused``
(its plain PyTorch version, which the wrapper runs for CPU tensors) against
the JAX reference kernel ``cvx_tpu.ops.pallas_kl.kl_barrier_fused`` in
interpret mode, on the same inputs made with numpy from fixed seeds.

Tolerances: f64 inputs agree to max |dx| <= 1e-11 (summation order only:
the reference pads n and sums in another order); f32 inputs to max |dx| <=
1e-5 (late Armijo decisions at t ~ 1e10 sit at the f32 resolution of the
barrier value, so another summation order may take another candidate and
move x by ~1e-7).

The plain version's ``count_candidates`` (the line-search candidates the
kernel needs, which bound its work) is held to the rule read off one-step
solves: exact counts, x unchanged bit for bit.
"""

import re
from pathlib import Path

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


@pytest.mark.timeout(120)
@pytest.mark.parametrize("schedule", ["production"])
@pytest.mark.parametrize("n", [300])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_matches_reference_past_the_register_path(dtype, k, n,
                                                         schedule):
    # n > 256: the kernel's group path (path_of), which chip_smoke.py holds
    # to this plain version on the card
    B = 3
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


@pytest.mark.timeout(60)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_ls", [1, 12, 40])
@pytest.mark.parametrize("beta", [0.5, 0.8, 1.0])
def test_line_search_factors_do_not_increase(beta, n_ls, dtype):
    # the kernel's precondition for stopping at the first accepted
    # candidate: beta^expo non-increasing (and none negative)
    _, ls_ts, _ = kl_barrier._schedule(100, dtype, "cpu", t0=1.0, mu=55.0,
                                       n_outer=7, beta=beta, n_ls=n_ls)
    assert ls_ts.shape == (n_ls,) and ls_ts.dtype == dtype
    assert float(ls_ts[0]) == 1.0
    assert bool((ls_ts[1:] <= ls_ts[:-1]).all())
    assert bool((ls_ts > 0).all())


@pytest.mark.timeout(60)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [16, 37])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_count_candidates_leaves_x_unchanged(dtype, k, n, schedule):
    B = 5 if k == 2 else 3
    arrays = [torch.from_numpy(np.ascontiguousarray(a.astype(dtype)))
              for a in _family(B, n, k, seed=n + k)]
    x = kl_barrier_fused_plain(*arrays, **SCHEDULES[schedule])
    x2, count = kl_barrier_fused_plain(*arrays, count_candidates=True,
                                       **SCHEDULES[schedule])
    assert torch.equal(x, x2)
    assert count.shape == (B,) and count.dtype == torch.int64


@pytest.mark.timeout(60)
@pytest.mark.parametrize("ls", [{}, dict(n_ls=40), dict(beta=1.25)],
                         ids=["n_ls=12", "n_ls=40", "beta=1.25"])
@pytest.mark.parametrize("k", [1, 2])
def test_count_candidates_in_range(k, ls):
    arrays = [torch.from_numpy(a.astype(np.float32))
              for a in _family(200, 100, k, seed=11)]
    kw = dict(SCHEDULES["production"], **ls)
    _, count = kl_barrier_fused_plain(*arrays, count_candidates=True, **kw)
    n_ls = ls.get("n_ls", 12)
    steps = kl_barrier.fused_n_outer(k + 100, mu=55.0) * 3
    assert bool((count >= 0).all()) and bool((count <= n_ls * steps).all())
    assert bool((count > 0).all())
    if "beta" in ls:
        # increasing candidates: every search that runs evaluates them all
        assert bool((count % n_ls == 0).all())


def _read_candidates(arrays, *, mu=55.0, n_inner=3, n_ls=12):
    """The rule read off one-step solves, per step: the least L for which
    a step over the first L candidates moves x (the first accepted one is
    candidate L - 1); n_ls when only an Armijo constant that accepts every
    feasible candidate moves it (none was accepted); 0 when nothing moves
    it (the search is gated).  Returns (counts, x after the last step)."""
    Hs, u, A, b, x = arrays
    n_outer = kl_barrier.fused_n_outer(Hs.shape[1] + Hs.shape[2], mu=mu)
    ts, _, _ = kl_barrier._schedule(Hs.shape[2], Hs.dtype, "cpu", t0=1.0,
                                    mu=mu, n_outer=n_outer, beta=0.8,
                                    n_ls=n_ls)
    counts = []
    for i in range(n_outer * n_inner):
        one = dict(t0=float(ts[i // n_inner]), mu=mu, n_outer=1, n_inner=1)

        def moves(**kw):
            return not torch.equal(
                kl_barrier_fused_plain(Hs, u, A, b, x, **one, **kw), x)

        first = next((L for L in range(1, n_ls + 1) if moves(n_ls=L)), None)
        counts.append(first if first is not None
                      else n_ls if moves(n_ls=n_ls, alpha=-1e300) else 0)
        x = kl_barrier_fused_plain(Hs, u, A, b, x, n_ls=n_ls, **one)
    return counts, x


@pytest.mark.timeout(120)
def test_count_candidates_reads_the_rule_on_a_later_candidate():
    # bench.py's family at pA = 0.47, pB = 0.65 in f64 takes later
    # candidates in the middle stages and accepts none in the last ones
    Hs, U, A, b, X0 = _family(1, 100, 2)
    U[0] = (-0.47, 0.65)
    w = 0.47 + 0.05
    X0[0] = np.where(np.arange(100) < 3, w / 3, (1 - w) / 97)
    arrays = [torch.from_numpy(a) for a in (Hs, U, A, b, X0)]
    counts, x_read = _read_candidates(arrays)
    x, count = kl_barrier_fused_plain(*arrays, count_candidates=True,
                                      **SCHEDULES["production"])
    assert torch.equal(x, x_read)
    assert int(count[0]) == sum(counts)
    assert any(1 < c < 12 for c in counts) and 12 in counts


@pytest.mark.timeout(120)
def test_count_candidates_is_zero_for_an_instance_on_a_bound():
    # the instance of test_no_step_guard_holds_an_instance_on_a_bound: its
    # q is NaN at every step, so every search is gated and the count is 0
    Hs, U, A, b, X0 = (a[1:] for a in _family(2, 16, 2, seed=5))
    X0[0, 7] = 0.0
    arrays = [torch.from_numpy(np.ascontiguousarray(a))
              for a in (Hs, U, A, b, X0)]
    counts, x_read = _read_candidates(arrays)
    x, count = kl_barrier_fused_plain(*arrays, count_candidates=True,
                                      **SCHEDULES["production"])
    assert counts == [0] * len(counts) and int(count[0]) == 0
    assert torch.equal(x, arrays[4]) and torch.equal(x_read, arrays[4])


@pytest.mark.timeout(30)
def test_path_of_mirrors_the_kernel_source():
    # path_of is the C launcher's dispatch: its constants are
    # csrc/kl_barrier.cu's, its rule the source's group_warps and launch_k
    src = (Path(kl_barrier.__file__).parent / "csrc" /
           "kl_barrier.cu").read_text()
    const = {m[1]: int(m[2]) for m in
             re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert kl_barrier._REG_MAX_N == const["kRegMaxN"]
    assert kl_barrier._GROUP_NC == const["kGroupNC"]
    assert kl_barrier._GROUP_FULL_NC == const["kGroupFullNC"]
    assert kl_barrier._GROUP_FILL_WARPS == const["kGroupFillWarps"]
    assert kl_barrier._GROUP_MAX_WARPS == const["kGroupMaxWarps"]
    assert kl_barrier._GROUP_BLOCK_WARPS == const["kGroupBlockWarps"]
    assert kl_barrier._GROUP_ROWS == const["kGroupRows"]
    assert kl_barrier._RED_MAX == const["kRedMax"]
    assert kl_barrier._SMEM_MAX == const["kSmemMax"]
    flat = " ".join(src.replace("\\\n", " ").split())  # macros joined
    for rule in ("if (n <= kRegMaxN) {",
                 "while (G < kGroupMaxWarps && 32 * G * kGroupNC < n && "
                 "((long long)B * G < kGroupFillWarps || 32 * G * "
                 "kGroupFullNC < n)) G *= 2;",
                 "const int per = G == 1 ? kGroupBlockWarps : 1;",
                 "const int c = (n + 32 * G - 1) / (32 * G);",
                 "if (c <= kGroupNC) {",
                 "const long long smem = (long long)per * kGroupRows * n * "
                 "(long long)sizeof(T); if (smem <= kGroupSmemBytes && "
                 "smem + tab + 2 * kGroupMaxWarps * kRedMax * "
                 "(long long)sizeof(T) <= kSmemMax) {",
                 "const int tab = schedule_bytes<T>(n_outer, n_ls);",
                 "return ((n_outer + n_ls) * (int)sizeof(T) + 15) / 16 * 16;",
                 "constexpr int kGroupSmemBytes = 232448 - 2 * "
                 "kGroupMaxWarps * kRedMax * 8;"):
        assert rule in flat, rule
    f32, f64 = torch.float32, torch.float64
    path_of = kl_barrier.path_of
    assert path_of(256, 10000, f32) == "register"
    assert path_of(1, 1, f64) == "register"
    # G doubles past each 256 G coordinates, up to 16, while B G warps do
    # not fill the card
    for n, G in ((257, 2), (512, 2), (513, 4), (1024, 4), (1025, 8),
                 (2049, 16), (4096, 16), (10000, 16)):
        assert path_of(n, 8, f32)[:2] == ("group", G)
        assert path_of(n, 8, f32)[2] == ("registers" if n <= 4096 else
                                         "shared")
    # a full card stops G where a thread owns at most 16 coordinates
    assert path_of(300, 10000, f32) == ("group", 1, "shared")
    assert path_of(512, 10000, f32) == ("group", 1, "shared")
    assert path_of(513, 10000, f32) == ("group", 2, "shared")
    assert path_of(1000, 10000, f32) == ("group", 2, "shared")
    assert path_of(1000, 1000, f32) == ("group", 4, "registers")
    assert path_of(1000, 1000, f64) == ("group", 4, "registers")
    # shared memory while a block's five rows fit, else global
    assert path_of(10000, 100, f32) == ("group", 16, "shared")
    assert path_of(10000, 100, f64) == ("group", 16, "global")
    assert path_of(11520, 1, f32) == ("group", 16, "shared")
    assert path_of(11521, 1, f32) == ("group", 16, "global")
    assert path_of(2048, 10000, f32) == ("group", 4, "shared")
    assert path_of(2880, 10000, f32) == ("group", 8, "shared")
    assert path_of(30000, 4, f64) == ("group", 16, "global")
    # the schedule's table (n_outer + n_ls entries) sits in front of the
    # rows: in f64 the rows of n = 5,760 fill the block without it, in f32
    # a table of up to 256 entries fits beside the reduction buffers
    assert path_of(5760, 100, f64) == ("group", 16, "shared")
    assert path_of(5760, 100, f64, 19) == ("group", 16, "global")
    assert path_of(5756, 100, f64, 19) == ("group", 16, "shared")
    assert path_of(5757, 100, f64, 19) == ("group", 16, "global")
    assert path_of(11520, 1, f32, 256) == ("group", 16, "shared")
    assert path_of(11520, 1, f32, 257) == ("group", 16, "global")
    # a block holds one instance of G warps or four one-warp instances:
    # at most 512 threads, the kernel's launch bound
    for n in (257, 1000, 4097, 10 ** 6):
        for B in (1, 100, 10 ** 5):
            _, G, _ = path_of(n, B, f32)
            assert G & (G - 1) == 0 and 32 * G * (4 if G == 1 else 1) <= 512
