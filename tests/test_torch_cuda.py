"""The CUDA kernels on the card: K1 ``kl_dual_fused``, K2
``kl_dual_fused_cert``, K3 ``kl_barrier_fused`` and K4
``cholesky_batched_cuda``, each against its plain PyTorch version on the
same CUDA inputs, the wrappers' refusals, and the launch counters.

Every test here needs a CUDA device (the kernels have no CPU mode), carries
the ``cuda`` marker and skips without one.  The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 K1 max |dx| <= 1e-5 on converged lanes (the f32 gap
floor), f64 K1 <= 1e-9 (summation order only), and K1's z within 1e-4
(f32) / 1e-8 (f64) of the plain z, relative to 1 + |z|.  K2 on certified
lanes (both ends polished to f64 rounding): max |dx| <= 1e-11, |dgap| <=
1e-10, z within 1e-9 relative to 1 + |z|, ineq_res and eq_res within
1e-12.  K3: max |dx| <= 1e-5 in f32 (late Armijo decisions at f32
resolution), 1e-11 in f64, and 0 on bench.py's family at 1000 x n = 100
with the default line search.  K4: max |dL| <= 1e-4 relative to max |L|
in f32 and 1e-10 in f64, NaN where the plain version has NaN (the lower
triangle from the failed pivot's column on).

K2's epilogue on the held and group paths writes the stall flag by
``_stalled``'s rule and the constant leaves, and a certified call through
``DistKL.solve_certified_batch`` is K2 alone on the card.  K3 works out
its continuation schedule itself into a table in shared memory: the
values equal ``_schedule``'s tensors on the card bit for bit, f64 rows
that fill a block move to global memory beside the table, and a K3 call
is the kernel alone.

The generic core, the fleet screen, the QP family, ``minimize`` and
resume run on the card against the same calls on the CPU (tolerances at
each test), and the entry points default to the card.  The parallel
layer runs on a one-rank NCCL group: the dp certified route through K2
equal in bits to the local call, and ``tp_chol`` at n = 1024.
"""

import math

import numpy as np
import pytest
import torch

from cvx_tpu_torch.ops.chol import (cholesky_batched,
                                    cholesky_batched_cuda,
                                    cholesky_batched_plain, held_max_n,
                                    max_n)
from cvx_tpu_torch.ops.kl_barrier import (_schedule, kl_barrier_fused,
                                          kl_barrier_fused_plain)
from cvx_tpu_torch.ops.kl_dual import (_stalled, kl_dual_fused,
                                       kl_dual_fused_cert,
                                       kl_dual_fused_cert_plain,
                                       kl_dual_fused_plain, path_of)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _family(k, m_eq, n, B, seed=0):
    """tests/test_round5.py::_family with B scaled copies of the bounds."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = rng.uniform(0.0, 1.0, (m_eq, n))
    U = np.stack([u * s for s in np.linspace(1.0, 1.1, B)])
    return H, U, A, np.broadcast_to(A @ x0, (B, m_eq))


def _bench_family(n, B):
    """bench.py's family: P(A) >= pA (|A| = 3), P(B) <= pB (upper half)."""
    rng = np.random.default_rng(n)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    U = np.column_stack([-rng.uniform(0.2, 0.5, B), rng.uniform(0.55, 0.8, B)])
    return np.stack([-I_A, I_B]), U, np.zeros((0, n)), np.zeros((B, 0))


# kl_dual.cu holds a lane's rows in registers for f32, dual dim <= 8, no
# extra equality rows and n <= 128, and takes the group path (G warps an
# instance, kl_dual.path_of) otherwise: shapes either side of each
# threshold, each n where G doubles and one past it, and large n
@pytest.mark.timeout(600)
@pytest.mark.parametrize("k,m_eq,n,B,dtype", [
    (2, 0, 24, 64, torch.float32),
    (5, 2, 24, 64, torch.float32),
    (13, 2, 24, 64, torch.float64),
    (2, 0, 100, 64, torch.float64),     # f64 takes the group path
    (2, 1, 100, 64, torch.float32),     # an equality row: group path
    (3, 0, 100, 64, torch.float32),     # dim 4
    (7, 0, 100, 64, torch.float32),     # dim 8, the widest held
    (8, 0, 100, 64, torch.float32),     # dim 9, the first on the group path
    (15, 0, 100, 64, torch.float32),    # dim 16
    (9, 2, 100, 64, torch.float32),     # dim 12 with equality rows
    (2, 0, 128, 64, torch.float32),     # the last n held
    (2, 0, 129, 64, torch.float32),     # the first n on the group path
    (2, 0, 256, 16, torch.float32),     # G = 2
    (2, 0, 257, 16, torch.float32),     # G = 4
    (2, 0, 512, 16, torch.float32),
    (2, 0, 513, 16, torch.float32),     # G = 8
    (2, 0, 1000, 64, torch.float32),
    (2, 0, 1024, 16, torch.float32),
    (2, 0, 1025, 16, torch.float32),    # G = 16, the cap at dim 3
    (2, 0, 10000, 8, torch.float32),
    (2, 0, 10000, 100, torch.float32)])  # the ladder's batch
def test_kernels_match_plain(dev, k, m_eq, n, B, dtype):
    # the random family up to n = 100, bench.py's (k = 2) beyond
    H, U, A, R = (_family(k, m_eq, n, B) if n <= 100
                  else _bench_family(n, B))

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    Hs = t(H)[None].expand(B, -1, -1)           # stride-0 batch, read in place
    As = t(A)[None].expand(B, -1, -1) if m_eq else None
    Rs = t(R) if m_eq else None
    x, g, z = kl_dual_fused(Hs, t(U), As, Rs)
    xp, gp, zp = kl_dual_fused_plain(Hs, t(U), As, Rs)
    tol, ztol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-9, 1e-8)
    conv = gp.abs() <= tol
    assert bool(conv.any())
    assert float((x - xp)[conv].abs().max()) <= tol
    assert float(((z - zp) / (1.0 + zp.abs()))[conv].abs().max()) <= ztol
    if dtype == torch.float32:
        xc, zc, gc, ic, ec, *_ = kl_dual_fused_cert(Hs, t(U), As, Rs)
        xq, zq, gq, iq, eq, *_ = kl_dual_fused_cert_plain(Hs, t(U), As, Rs)
        ok = gq.abs() <= 1e-8
        assert bool(ok.any())
        assert float((xc - xq)[ok].abs().max()) <= 1e-11
        assert float((gc - gq)[ok].abs().max()) <= 1e-10
        assert float(((zc - zq) / (1.0 + zq.abs()))[ok].abs().max()) <= 1e-9
        assert float((ic - iq)[ok].abs().max()) <= 1e-12
        assert float((ec - eq)[ok].abs().max()) <= 1e-12


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", ["jammed", "dead"])
def test_group_path_sick_and_dead_lanes(dev, case):
    # n = 200 takes the group path (two warps an instance): an exactly
    # anti-parallel pair of rows whose lams are both free makes the small
    # system sick (Jacobi direction), and lane 3's B'z0 ~ 2000 underflows
    # every exp (sum(y) = 0, gap +inf)
    n = 200
    I_A = np.zeros(n); I_A[:3] = 1.0
    if case == "jammed":
        H = np.stack([-I_A, I_A])[None]
        U = np.array([[-0.4444439978653988, 0.49597226141316375]])
    else:
        H, U, _, _ = _bench_family(n, 4)
        H = np.repeat(H[None], 4, axis=0); H[3] = 1e6
        U[3] = 1e6
    Hs = torch.tensor(H, dtype=torch.float32, device=dev)
    Ut = torch.tensor(U, dtype=torch.float32, device=dev)
    assert path_of(3, 2, 0, n, Hs.shape[0], torch.float32) == ("group", 2)
    x, g, z = kl_dual_fused(Hs, Ut)
    xp, gp, zp = kl_dual_fused_plain(Hs, Ut)
    assert torch.equal(torch.isinf(g), torch.isinf(gp))
    assert bool(torch.isinf(gp).any()) == (case == "dead")
    live = torch.isfinite(gp) & (gp.abs() <= 1e-5)
    assert bool(live.any())
    assert float((x - xp)[live].abs().max()) <= 1e-5
    assert float(((z - zp) / (1.0 + zp.abs()))[live].abs().max()) <= 1e-4
    xc, zc, gc, ic, ec, *_ = kl_dual_fused_cert(Hs, Ut)
    xq, zq, gq, iq, eq, *_ = kl_dual_fused_cert_plain(Hs, Ut)
    assert torch.equal(torch.isinf(gc), torch.isinf(gq))
    ok = gq.abs() <= 1e-8
    assert bool(ok.any())
    assert float((xc - xq)[ok].abs().max()) <= 1e-11
    assert float((gc - gq)[ok].abs().max()) <= 1e-10
    assert float(((zc - zq) / (1.0 + zq.abs()))[ok].abs().max()) <= 1e-9


@pytest.mark.timeout(600)
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    H = torch.zeros((2, 1, 8), device=dev)
    U = torch.zeros((2, 1), device=dev)
    with pytest.raises(ValueError, match="f32/f64 CUDA"):
        kl_dual_fused(H.half(), U.half())
    with pytest.raises(ValueError, match="contiguous"):
        kl_dual_fused(torch.zeros((2, 1, 16), device=dev)[:, :, ::2], U)
    with pytest.raises(ValueError, match="must be on"):
        kl_dual_fused(H, U, log_prior=torch.zeros(8))
    with pytest.raises(ValueError, match="takes torch.float32"):
        kl_dual_fused_cert(H.double(), U.double())
    with pytest.raises(ValueError, match="float64 log_prior"):
        kl_dual_fused_cert(H, U, log_prior=torch.zeros(8, device=dev))


@pytest.mark.timeout(600)
def test_launch_counters_count_kernel_launches_only(dev):
    H = torch.tensor([[[-1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]]],
                     device=dev)
    U = torch.tensor([[-0.6, 0.3]], device=dev)
    k1, k2 = kl_dual_fused.launches, kl_dual_fused_cert.launches
    kl_dual_fused(H, U)
    kl_dual_fused_cert(H, U)
    kl_dual_fused_plain(H, U)
    kl_dual_fused_cert_plain(H, U)
    assert (kl_dual_fused.launches, kl_dual_fused_cert.launches) == (k1 + 1,
                                                                    k2 + 1)
    x, gap, z = kl_dual_fused(H[:0], U[:0])      # empty batch: no launch
    assert x.shape == (0, 4) and z.shape == (0, 3)
    assert kl_dual_fused.launches == k1 + 1
    torch.cuda.synchronize()


def _cert_cases(n, B, dev):
    """bench.py's family at (n, B) with rows of its own for each instance:
    instance 1 infeasible (P(B) <= -0.1), instance 2's first row NaN at one
    coordinate (its x comes out NaN)."""
    H, U, _, _ = _bench_family(n, B)
    Hs = torch.tensor(H, dtype=torch.float32, device=dev)[None].repeat(
        B, 1, 1)
    Ut = torch.tensor(U, dtype=torch.float32, device=dev)
    Ut[1, 1] = -0.1
    Hs[2, 0, 1] = float("nan")
    return Hs, Ut


@pytest.mark.timeout(600)
@pytest.mark.parametrize("tol_at", ["gap", "below_gap"])
@pytest.mark.parametrize("n,B,path", [(100, 10000, "held"),
                                      (10000, 100, ("group", 16))])
def test_k2_writes_the_stall_flag_and_the_leaves(dev, n, B, path, tol_at):
    """K2's stalled is ``_stalled`` on its own x, gap and residuals at the
    tolerances it is given (instance 0's tol exactly at its |gap|, or the
    next double below), NaN in x and the infeasible instance flagged; the
    NaN leaf, iters and maxed_out are the fills; the other outputs do not
    depend on the tolerances."""
    assert path_of(3, 2, 0, n, B, torch.float32) == path
    Hs, U = _cert_cases(n, B, dev)
    first = kl_dual_fused_cert(Hs, U)
    g = abs(float(first[2][0]))
    tol = g if tol_at == "gap" else math.nextafter(g, -math.inf)
    out = kl_dual_fused_cert(Hs, U, tol=tol, tol_feas=1e-7)
    x, z, gap, ineq, eq, stalled, nan, iters, maxed = out
    torch.cuda.synchronize()
    for a, b in zip(first[:5], out[:5]):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # at the default tolerances only the infeasible and the NaN instance
    # stall: the infeasible dual runs off (gap -> -inf) or its lane dies
    assert torch.equal(first[5], _stalled(x, gap, ineq, 1e-8, 1e-7, eq=eq))
    assert first[5].nonzero().flatten().tolist() == [1, 2]
    assert float(gap[1]) < -1.0 or float(gap[1]) == math.inf
    assert bool(torch.isnan(x[2]).all())
    assert torch.equal(stalled, _stalled(x, gap, ineq, tol, 1e-7, eq=eq))
    assert bool(stalled[0]) == (tol_at == "below_gap")
    assert nan.dtype == torch.float64 and bool(torch.isnan(nan).all())
    assert iters.dtype == torch.int64 and bool((iters == 18).all())
    assert maxed.dtype == torch.bool and not bool(maxed.any())


def _primal_family(B, n, k, dev, dtype):
    """bench.py's family with its analytic feasible start; shared rows as
    stride-0 expands."""
    rng = np.random.default_rng(B + n)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    pA = rng.uniform(0.2, 0.5, B)
    U = np.column_stack([-pA, rng.uniform(0.55, 0.8, B)])[:, :k]
    w = pA + 0.05
    X0 = (w / 3)[:, None] * I_A + ((1 - w) / (n - 3))[:, None] * (1 - I_A)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    ones = torch.ones((1, 1, n), dtype=dtype, device=dev)
    return (t(np.stack([-I_A, I_B])[:k])[None].expand(B, -1, -1), t(U),
            ones.expand(B, -1, -1), ones[0, :, :1].expand(B, 1), t(X0))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("B,n,k,dtype,ls", [
    (1000, 100, 2, torch.float32, {}),
    (37, 77, 1, torch.float32, {}),
    (37, 77, 2, torch.float64, {}),
    (64, 200, 2, torch.float32, {}),
    (64, 200, 1, torch.float64, {}),
    (16, 300, 2, torch.float32, {}),
    # the group path (path_of): a thread's state in registers, shared
    # memory and global memory, ragged batches, one-warp groups
    (37, 257, 2, torch.float32, {}),
    (37, 257, 1, torch.float64, {}),
    (16, 300, 1, torch.float64, {}),
    (13, 1000, 1, torch.float32, {}),
    (1000, 1000, 2, torch.float32, {}),
    (1000, 1000, 2, torch.float64, {}),
    (10000, 300, 2, torch.float32, {}),
    (100, 10000, 2, torch.float32, {}),
    (100, 10000, 1, torch.float64, {}),
    (4, 30000, 2, torch.float64, {}),
    (1000, 1000, 2, torch.float32, dict(beta=1.25)),
    # one candidate; exponents past 32; increasing candidates, where the
    # kernel evaluates every one and keeps the longest accepted
    (1000, 100, 2, torch.float32, dict(n_ls=1)),
    (1000, 100, 2, torch.float32, dict(n_ls=40)),
    (1000, 100, 2, torch.float32, dict(beta=1.25))])
def test_k3_matches_plain(dev, B, n, k, dtype, ls):
    args = _primal_family(B, n, k, dev, dtype)
    kw = dict(mu=55.0, n_inner=3, **ls)
    x = kl_barrier_fused(*args, **kw)
    xp = kl_barrier_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-11
    if (B, n) == (1000, 100) and not ls:
        tol = 0.0       # the bench family: the same bits
    assert bool(torch.isfinite(x).all())
    assert float((x - xp).abs().max()) <= tol


def _kernel_schedule(n, dtype, dev, *, t0, mu, n_outer, beta, n_ls):
    """(t per stage, the candidates' factors, log n) as K3 works them out
    (``kl_barrier_schedule_{f32,f64}``)."""
    from cvx_tpu_torch.ops import _build

    out = torch.full((n_ls + n_outer + 1,), float("nan"), dtype=dtype,
                     device=dev)
    fn = ("kl_barrier_schedule_f32" if dtype == torch.float32
          else "kl_barrier_schedule_f64")
    _build.launch(_build.load("kl_barrier"), fn, "kl_barrier_schedule", dev,
                  _build.ptr(out), n, n_outer, n_ls, float(t0), float(mu),
                  float(beta))
    return out[n_ls:n_ls + n_outer], out[:n_ls], out[-1]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mu", [30.0, 55.0])
def test_k3_schedule_is_the_torch_schedule_bit_for_bit(dev, mu, dtype):
    # K3's in-kernel schedule against _schedule's tensors on the card, as
    # bit patterns: the stages' t, the candidates' factors (increasing and
    # alternating ones, exponents past 32) and log n
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    for t0 in (1.0, 0.37):
        for beta in (0.8, 1.25, -0.8):
            for n_ls in (1, 12, 40):
                for n_outer in range(2, 9):
                    for n in (3, 100, 10000):
                        kw = dict(t0=t0, mu=mu, n_outer=n_outer, beta=beta,
                                  n_ls=n_ls)
                        got = _kernel_schedule(n, dtype, dev, **kw)
                        want = _schedule(n, dtype, dev, **kw)
                        for g, w, what in zip(got, want,
                                              ("t", "factors", "log n")):
                            assert torch.equal(g.view(bits), w.view(bits)), \
                                (what, n, kw, g.tolist(), w.tolist())


@pytest.mark.timeout(600)
def test_k3_schedule_table_moves_the_rows_to_global_memory(dev):
    # f64 rows of n = 5,760 fill a block's shared memory alone: beside the
    # schedule's table the launcher keeps them in global memory, and the
    # wrapper, through path_of, allocates the scratch for them
    from cvx_tpu_torch.ops.kl_barrier import fused_n_outer, path_of

    args = _primal_family(4, 5760, 1, dev, torch.float64)
    kw = dict(mu=55.0, n_inner=3)
    table = fused_n_outer(5761, mu=55.0) + 12
    assert path_of(5760, 4, torch.float64) == ("group", 16, "shared")
    assert path_of(5760, 4, torch.float64, table) == ("group", 16, "global")
    x = kl_barrier_fused(*args, **kw)
    xp = kl_barrier_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    assert float((x - xp).abs().max()) <= 1e-11


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n", [100, 300])
def test_k3_no_step_guard_on_the_card(dev, n):
    # instance 2 starts with x0 = 0 at one coordinate: its dx is not
    # finite, and both paths must hold it at x0 as the plain version does
    args = list(_primal_family(4, n, 2, dev, torch.float32))
    args[4] = args[4].clone()
    args[4][2, 40] = 0.0
    x = kl_barrier_fused(*args, mu=55.0, n_inner=3)
    xp = kl_barrier_fused_plain(*args, mu=55.0, n_inner=3)
    torch.cuda.synchronize()
    assert torch.equal(x[2], args[4][2]) and bool(torch.isfinite(x).all())
    assert float((x - xp).abs().max()) <= 1e-5


@pytest.mark.timeout(600)
def test_k3_bench_case_reaches_every_line_search_path(dev):
    # test_k3_matches_plain's exact case, one step at a time: some searches
    # are gated (0 candidates), some stop at a later candidate (2 to 11),
    # some accept none (all 12); the steps chain to the whole solve's x
    args = _primal_family(1000, 100, 2, dev, torch.float32)
    Hs, u, A, b, x = args
    ts, _, _ = _schedule(100, torch.float32, dev, t0=1.0, mu=55.0,
                         n_outer=7, beta=0.8, n_ls=12)
    per_step = []
    for i in range(21):
        x, c = kl_barrier_fused_plain(Hs, u, A, b, x, t0=float(ts[i // 3]),
                                      mu=55.0, n_outer=1, n_inner=1,
                                      count_candidates=True)
        per_step.append(c)
    per_step = torch.stack(per_step, dim=1)
    xw, count = kl_barrier_fused_plain(*args, mu=55.0, n_inner=3,
                                       count_candidates=True)
    assert torch.equal(x, xw) and torch.equal(per_step.sum(dim=1), count)
    assert bool((per_step == 0).any()) and bool((per_step == 12).any())
    assert bool(((per_step > 1) & (per_step < 12)).any())


# chol.cu factors n <= held_max_n(dtype) with the matrix in registers and
# larger n on its panel path: n either side of the limit in each type; at
# n = 100 a failed pivot in column 0, a zero pivot (row and column 50
# zero) and a failed pivot in the last, ragged column block (96-99); on
# the panel path ragged n (257, 500 in f32, 300 in f64), max_n(dtype) and
# a failed pivot in a late column block (300 of 512)
_F32_HELD, _F64_HELD = (held_max_n(torch.float32),
                        held_max_n(torch.float64))
_F32_MAX, _F64_MAX = max_n(torch.float32), max_n(torch.float64)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n,dtype,where", [
    (77, torch.float32, "pivot 10"), (128, torch.float64, "pivot 10"),
    (512, torch.float32, "pivot 10"),
    (_F32_HELD, torch.float32, "pivot 10"),
    (_F32_HELD + 1, torch.float32, "pivot 10"),
    (_F64_HELD, torch.float64, "pivot 10"),
    (_F64_HELD + 1, torch.float64, "pivot 10"),
    (100, torch.float32, "pivot 0"), (100, torch.float32, "zero pivot 50"),
    (100, torch.float32, "pivot 97"),
    (257, torch.float32, "pivot 10"), (500, torch.float32, "pivot 10"),
    (_F32_MAX, torch.float32, "pivot 10"),
    (300, torch.float64, "pivot 10"), (_F64_MAX, torch.float64, "pivot 10"),
    (512, torch.float32, "pivot 300")])
def test_k4_matches_plain(dev, n, dtype, where):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((7, n, n))
    X = torch.tensor(M @ M.transpose(0, 2, 1) / n + np.eye(n), dtype=dtype,
                     device=dev)
    k = int(where.rsplit(" ", 1)[1])   # lane 3 is not positive definite
    if where.startswith("zero"):
        X[3, k, :] = 0.0
        X[3, :, k] = 0.0
    else:
        X[3, k, k] = -1.0
    L = cholesky_batched_cuda(X)
    Lp = cholesky_batched_plain(X)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(L), torch.isnan(Lp))
    rows, cols = torch.meshgrid(torch.arange(n, device=dev),
                                torch.arange(n, device=dev), indexing="ij")
    assert torch.equal(torch.isnan(L[3]), (rows >= cols) & (cols >= k))
    ok = torch.tensor([0, 1, 2, 4, 5, 6], device=dev)
    scale = float(Lp[ok].abs().max())
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((L[ok] - Lp[ok]).abs().max()) <= tol * scale
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(cholesky_batched(X, method="cuda").isnan(),
                       L.isnan())


@pytest.mark.timeout(600)
def test_k3_k4_wrappers_refuse_and_count(dev):
    args = _primal_family(4, 16, 2, dev, torch.float32)
    with pytest.raises(ValueError, match="f32/f64 CUDA"):
        kl_barrier_fused(*(a.half() for a in args))
    with pytest.raises(ValueError, match="must be on"):
        kl_barrier_fused(*args[:4], args[4].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        kl_barrier_fused(*args[:4], torch.zeros((4, 32), device=dev)[:, ::2])
    X = torch.eye(8, device=dev).expand(3, -1, -1)
    with pytest.raises(ValueError, match="f32/f64 CUDA"):
        cholesky_batched_cuda(X.half())
    with pytest.raises(ValueError, match="contiguous"):
        cholesky_batched_cuda(torch.eye(8, device=dev).repeat(3, 1, 2)
                              [:, :, ::2])
    with pytest.raises(ValueError, match="n = 900"):
        cholesky_batched_cuda(torch.eye(900, dtype=torch.float64,
                                        device=dev)[None])
    k3, k4 = kl_barrier_fused.launches, cholesky_batched_cuda.launches
    kl_barrier_fused(*args)
    kl_barrier_fused_plain(*args)
    cholesky_batched_cuda(X)            # stride-0 batch, read in place
    cholesky_batched_plain(X)
    cholesky_batched(X)                 # "torch": no kernel of ours
    assert (kl_barrier_fused.launches, cholesky_batched_cuda.launches) == (
        k3 + 1, k4 + 1)
    torch.cuda.synchronize()


def _mixed_batch(n, B, seed=0):
    """tests/test_round5.py's _mixed_batch: P(A) >= pA and P(A) <= qA,
    qA < pA (infeasible) on every 4th instance."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[::4] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return np.stack([-I_A, I_A]), np.stack([-pA, qA], axis=1), bad


@pytest.mark.timeout(600)
@pytest.mark.parametrize("method", ["dual", "BR", "PD"])
def test_generic_core_on_the_card_matches_the_cpu(dev, method):
    # the generic core (plain PyTorch, no kernel of ours) runs the same
    # algorithm on the card.  solve() (the barrier on the dual) from its
    # own start; the primal methods from a given strictly feasible point at
    # tol = 1e-6, where every stopping decision sits far above the rounding
    # floor: x to 1e-10 in f64, iters and the flags exactly
    from cvx_tpu_torch import DistKL, SolverParams

    n = 32
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    data = dict(H=np.stack([-I_A, I_B]), u=np.array([-0.36, 0.3]))
    x0 = np.full(n, 0.35 / (n // 2 - 3))
    x0[:3], x0[n // 2:] = 0.4 / 3, 0.25 / (n // 2)
    out = {}
    for d in ("cpu", dev):
        prob = DistKL.create(n, **data, device=d)
        out[str(d)] = (prob.solve() if method == "dual" else prob.solve(
            method, SolverParams(tol=1e-6), feasible_point=x0))
    cpu, gpu = out["cpu"], out[str(dev)]
    assert gpu.x.device.type == "cuda"
    dx = float((gpu.x.cpu() - cpu.x).abs().max())
    assert dx <= 1e-10, dx
    for flag in ("iters", "maxed_out", "stalled"):
        assert torch.equal(getattr(gpu, flag).cpu(), getattr(cpu, flag)), (
            flag, getattr(gpu, flag), getattr(cpu, flag))


@pytest.mark.timeout(600)
def test_feasibility_batch_on_the_card_matches_the_cpu(dev):
    # the flags exactly; s_max to 1e-8, as against the reference (phase-I
    # stops at the first point with slack below -tol_feas)
    from cvx_tpu_torch import DistKL

    n, B = 32, 40
    H, U, bad = _mixed_batch(n, B)
    out = {}
    for d in ("cpu", dev):
        prob = DistKL.create(n, H=H, u=np.zeros(2), device=d)
        out[str(d)] = [t.cpu() for t in prob.feasibility_batch(U)]
    (s_c, f_c), (s_g, f_g) = out["cpu"], out[str(dev)]
    assert np.array_equal(s_g.numpy() > 0, bad)
    assert torch.equal(f_g, f_c) and np.array_equal(f_g.numpy(), ~bad)
    ds = float((s_g - s_c).abs().max())
    assert ds <= 1e-8, ds


# ---------------------------------------------------------------------------
# the fleet screen, the QP family, minimize and resume on the card,
# each against the same call on the CPU.  Tolerances: the flags exactly; the
# screen's bounds to 1e-10 (f64) / 1e-5 (f32) on the anti-parallel family;
# f64 x to 1e-8 and the certified gap within the contract on both
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_screen_on_the_card_matches_the_cpu(dev, dtype):
    from cvx_tpu_torch import DistKL

    n, B = 100, 200
    H, U, bad = _mixed_batch(n, B)
    out = {}
    for d in ("cpu", dev):
        prob = DistKL.create(n, H=torch.tensor(H, dtype=dtype),
                             u=torch.zeros(2, dtype=dtype), device=d)
        out[str(d)] = prob.feasibility_screen_batch(
            torch.tensor(U, dtype=dtype))
    cpu, gpu = out["cpu"], out[str(dev)]
    assert gpu.x.device.type == "cuda"
    assert np.array_equal(gpu.infeasible.cpu().numpy(), bad)
    for f in ("strictly_feasible", "infeasible", "undecided"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for f in ("s_lower", "s_upper", "x", "w"):
        d = float((getattr(gpu, f).cpu() - getattr(cpu, f)).abs().max())
        assert d <= tol, (f, d)


def _qp_fleet(n, m, p, B, seed=0):
    """bench_scaling.qp_fleet's recipe in numpy: shared P, G, A; per
    instance a, ub."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    return dict(P=M @ M.T + np.eye(n),
                a=rng.standard_normal((B, n)),
                G=rng.standard_normal((m, n)) / np.sqrt(n),
                h=rng.uniform(0.5, 1.5, (B, m)),
                A=rng.standard_normal((p, n)) / np.sqrt(n),
                b=np.zeros(p))


@pytest.mark.timeout(600)
def test_qp_certified_on_the_card_matches_the_cpu(dev):
    from cvx_tpu_torch import QP, SolverParams

    data = _qp_fleet(24, 12, 2, 8)
    pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol", kkt_refine=1,
                        max_iter=40)
    out = {}
    for d in ("cpu", dev):
        qp = QP.create(**data, dtype=torch.float32, device=d)
        out[str(d)] = qp.solve_certified(
            torch.zeros(24, dtype=torch.float32), pars, method="BR")
    cpu, gpu = out["cpu"], out[str(dev)]
    assert gpu.x.device.type == "cuda" and gpu.x.dtype == torch.float64
    for s in (cpu, gpu):
        assert float(s.duality_gap.abs().max()) <= 1e-8
        assert float(s.ineq_res.max()) <= 1e-7
        assert not bool(s.stalled.any())
    dx = float((gpu.x.cpu() - cpu.x).abs().max())
    assert dx <= 1e-5, dx


def test_minimize_on_the_card_matches_the_cpu(dev):
    from cvx_tpu_torch import minimize
    from cvx_tpu_torch import problem as pb

    n = 8
    outs = {}
    for d in ("cpu", dev):
        outs[str(d)] = minimize(pb.p_norm_p(n, 2.2),
                                pb.ConstraintSet(blocks=(pb.positivity(n),)),
                                pb.sum_to_one(n),
                                x0=torch.zeros(n, dtype=torch.float64),
                                method="BR", device=d)
    cpu, gpu = outs["cpu"], outs[str(dev)]
    assert gpu.x.device.type == "cuda"
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-8
    assert bool(gpu.stalled) == bool(cpu.stalled)


def test_resume_on_the_card_matches_the_cpu(dev, tmp_path):
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.checkpoint import (load_pytree, resume_barrier,
                                          save_pytree)
    from cvx_tpu_torch.solvers import barrier_solve

    n = 10
    I_A = np.zeros(n); I_A[:3] = 1.0
    ws = np.array([0.45, 0.55, 0.7])
    x0s = ws[:, None] * I_A / 3 + (1 - ws)[:, None] * (1 - I_A) / (n - 3)
    out = {}
    for d in ("cpu", dev):
        prob = DistKL.create(n, H=-I_A[None], u=np.array([-0.4]), device=d)
        X0 = torch.tensor(x0s, device=d)
        mid = barrier_solve(prob.objective, prob.inequalities, X0,
                            SolverParams(outer_max_iter=3, mu=10.0, tol=1e-9),
                            eqs=prob.equalities)
        path = str(tmp_path / f"{torch.device(d).type}.npz")
        save_pytree(path, mid)
        out[str(d)] = resume_barrier(
            prob.objective, prob.inequalities, load_pytree(path, mid),
            SolverParams(mu=10.0, tol=1e-9), eqs=prob.equalities)
    cpu, gpu = out["cpu"], out[str(dev)]
    assert gpu.x.device.type == "cuda"
    assert float((gpu.x.cpu() - cpu.x).abs().max()) <= 1e-8
    assert torch.equal(gpu.stalled.cpu(), cpu.stalled)
    assert float(gpu.duality_gap.max()) < 1e-8


def test_new_entry_points_default_to_the_card(dev):
    from cvx_tpu_torch import LP, QP, DiagQP, minimize
    from cvx_tpu_torch import problem as pb

    n = 4
    qp = QP.create(np.eye(n), np.ones(n), np.eye(n), np.ones(n))
    dq = DiagQP.create(np.ones(n), np.ones(n))
    lp = LP(np.ones(n), A=np.ones((1, n)), b=np.ones(1))
    for leaf in (qp.P, qp.h, dq.c, dq.U, lp.a, lp.c, lp.A):
        assert leaf.device.type == "cuda"
    sol = minimize(pb.norm_squared(n), pb.ConstraintSet(
        blocks=(pb.positivity(n),)), pb.sum_to_one(n),
        feasible_point=torch.full((n,), 0.25, dtype=torch.float64))
    assert sol.x.device.type == "cuda"


@pytest.fixture
def nccl_one_rank(dev):
    """A one-rank NCCL group on the card for the parallel layer."""
    import torch.distributed as dist

    from cvx_tpu_torch.parallel import init_distributed, instance_mesh
    from cvx_tpu_torch.parallel.mesh import free_port

    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    try:
        yield instance_mesh(device=dev)
    finally:
        dist.destroy_process_group()


def test_parallel_dp_k2_one_nccl_rank(dev, nccl_one_rank):
    """``shard_solve`` of the certified route through K2 on a one-rank
    NCCL group, 4,096 instances: the same bits as the local call, K2
    launched once."""
    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.parallel import shard_solve

    H, U, _, _ = _family(2, 0, 100, 4096)
    f32 = dict(dtype=torch.float32, device=dev)
    prob = DistKL.create(100, H=torch.tensor(H, **f32),
                         u=torch.zeros(2, **f32))
    Ut = torch.tensor(U, **f32)
    local = prob.solve_certified_batch(Ut)
    k2 = kl_dual_fused_cert.launches
    sol = shard_solve(prob.solve_certified_batch, nccl_one_rank)(Ut)
    torch.cuda.synchronize()
    assert kl_dual_fused_cert.launches == k2 + 1
    for name in ("x", "lam", "nu", "duality_gap", "ineq_res", "eq_gap",
                 "stalled"):
        assert torch.equal(getattr(sol, name), getattr(local, name)), name
    assert float(sol.duality_gap.abs().max()) <= 1e-8


def test_tp_chol_one_nccl_rank(dev, nccl_one_rank):
    """``tp_chol`` on one rank at n = 1024 (block 128, f64) against
    ``torch.linalg.cholesky`` (the reference's tests/test_tp_chol.py
    bound, 1e-9), and its solve against ``torch.linalg.solve``."""
    from cvx_tpu_torch.parallel import (instance_mesh,
                                        make_sharded_chol_solve,
                                        make_sharded_cholesky)

    n = 1024
    g = torch.Generator().manual_seed(0)
    M = torch.randn(n, n, generator=g, dtype=torch.float64) / n ** 0.5
    H = (M @ M.T + 2.0 * torch.eye(n, dtype=torch.float64)).to(dev)
    B = torch.randn(n, 3, generator=g, dtype=torch.float64).to(dev)
    tp = instance_mesh(axis="tp", device=dev)
    L = make_sharded_cholesky(tp, n, block=128)(H)
    assert float((L - torch.linalg.cholesky(H)).abs().max()) < 1e-9
    X = make_sharded_chol_solve(tp, n, block=128)(L, B)
    assert float((X - torch.linalg.solve(H, B)).abs().max()) < 1e-8


@pytest.mark.timeout(600)
@pytest.mark.parametrize("n,B", [(100, 10000), (10000, 100)])
def test_certified_call_launches_k2_alone(dev, n, B):
    """A certified call on the card is one device op, K2, and one
    ``cert_leaves_fused``.  Last in the file: a profile taken before the
    one-rank NCCL tests left the next file's profile (test_torch_spans.py)
    without device events on the card (torch 2.11)."""
    from torch.profiler import ProfilerActivity, profile

    from cvx_tpu_torch import DistKL, diagnostics

    H, U, _, _ = _bench_family(n, B)
    model = DistKL.create(n, H=H.astype(np.float32), u=U[0].astype(
        np.float32), device=dev)
    u = torch.tensor(U, dtype=torch.float32, device=dev)
    model.solve_certified_batch(u)       # the library and the log prior
    torch.cuda.synchronize()
    before = diagnostics.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            sol = model.solve_certified_batch(u)
        torch.cuda.synchronize()
    got = diagnostics.counters()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_user_annotation()]
    assert len(ops) == 3 and all("kl_dual_cert" in o for o in ops), ops
    assert got["kl_dual_fused_cert"] == before["kl_dual_fused_cert"] + 3
    assert got["cert_leaves_fused"] == before["cert_leaves_fused"] + 3
    assert got["cert_leaves_torch"] == before["cert_leaves_torch"]
    assert not bool(sol.stalled.any())


@pytest.mark.timeout(600)
@pytest.mark.parametrize("B,n,dtype", [(10000, 100, torch.float32),
                                       (100, 10000, torch.float64)])
def test_k3_call_launches_k3_alone(dev, B, n, dtype):
    """A K3 call on the card is one device op, the kernel, on the register
    path and on the group path that allocates its scratch ("global"): the
    kernel works out the schedule, so ``kl_barrier_schedule_torch`` does
    not move and ``kl_barrier_fused`` counts each launch.  Last in the
    file, as the certified test above."""
    from torch.profiler import ProfilerActivity, profile

    from cvx_tpu_torch import diagnostics
    from cvx_tpu_torch.ops.kl_barrier import path_of

    args = _primal_family(B, n, 2, dev, dtype)
    kw = dict(mu=55.0, n_inner=3)
    kl_barrier_fused(*args, **kw)        # the library
    torch.cuda.synchronize()
    before = diagnostics.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            x = kl_barrier_fused(*args, **kw)
        torch.cuda.synchronize()
    got = diagnostics.counters()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_user_annotation()]
    assert len(ops) == 3 and all("kl_barrier" in o for o in ops), ops
    assert got["kl_barrier_fused"] == before["kl_barrier_fused"] + 3
    assert got["kl_barrier_schedule_torch"] == \
        before["kl_barrier_schedule_torch"]
    assert path_of(n, B, dtype) in ("register", ("group", 16, "global"))
    assert bool(torch.isfinite(x).all())
