"""Port parity for K1: ``cvx_tpu_torch.ops.kl_dual.kl_dual_fused`` (its
plain PyTorch version, which the wrapper runs for CPU tensors) against the
JAX reference kernel ``cvx_tpu.ops.pallas_kl_dual.kl_dual_fused`` in
interpret mode, on the same inputs made with numpy from fixed seeds.

Tolerances: f64 inputs agree to max |dx| <= 1e-9 (the two differ only in
summation order); f32 inputs to max |dx| <= 1e-5 (the f32 gap floor —
line-search ties at the value's resolution may resolve differently under
another summation order, moving x by ~1e-6).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.ops.pallas_kl_dual import kl_dual_fused as ref_kl_dual_fused
from cvx_tpu_torch.ops import kl_dual
from cvx_tpu_torch.ops.kl_dual import (kl_dual_fused, kl_dual_fused_plain,
                                       path_of)

F32_TOL = 1e-5
F64_TOL = 1e-9


def _both(H, U, A=None, R=None, log_prior=None, dtype=np.float64,
          n_steps=16):
    """Run the reference (interpret mode) and the port on one batch;
    returns ((x, gap, z) reference, (x, gap, z) port) as numpy arrays."""
    def j(a):
        return None if a is None else jnp.asarray(np.asarray(a, dtype))

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(np.asarray(a, dtype)))

    ref = ref_kl_dual_fused(j(H), j(U), j(A), j(R), log_prior=j(log_prior),
                            n_steps=n_steps, bt=8, interpret=True)
    got = kl_dual_fused(t(H), t(U), t(A), t(R), log_prior=t(log_prior),
                        n_steps=n_steps)
    return (tuple(np.asarray(a) for a in ref),
            tuple(a.numpy() for a in got))


def _family(k, mE, n, seed=0):
    """tests/test_round4.py::TestDualDim8 / test_round5.py::_family."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = rng.uniform(0.0, 1.0, (mE, n)) if mE else None
    r = (A @ x0) if mE else None
    return H, u, A, r


def _dim5_pair(k, m_eq, n=64):
    """Two instances of tests/test_round3.py::TestFusedKernelDim5: the
    feasible-by-construction draw and (k > 0) the BINDING draw H = -W,
    which exercises the active-set freeze/release logic; per-instance
    rows (B, k, n)."""
    rng = np.random.default_rng(k * 10 + m_eq)
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    H = rng.uniform(0.0, 1.0, (k, n))
    u = H @ x0 + rng.uniform(0.05, 0.2, k)
    A = rng.uniform(0.0, 1.0, (m_eq, n))
    r = A @ x0
    rng2 = np.random.default_rng(100 + k * 10 + m_eq)
    x1 = rng2.uniform(0.5, 1.5, n); x1 /= x1.sum()
    W = rng2.uniform(0.0, 1.0, (k, n))
    delta = 0.02 if m_eq else 0.06
    A1 = rng2.uniform(0.0, 1.0, (m_eq, n))
    H1, u1, r1 = -W, -(W @ x1 + delta), A1 @ x1
    return (np.stack([H, H1]), np.stack([u, u1]), np.stack([A, A1]),
            np.stack([r, r1]))


class TestK1Dim5Shapes:
    @pytest.mark.timeout(60)
    @pytest.mark.parametrize("k,m_eq", [(1, 0), (2, 0), (3, 0), (4, 0),
                                        (1, 1), (2, 1), (2, 2), (3, 1),
                                        (0, 1), (0, 2)])
    def test_f32_matches_reference(self, k, m_eq):
        H, U, A, R = _dim5_pair(k, m_eq)
        (xr, gr, zr), (x, g, z) = _both(H, U, A if m_eq else None,
                                        R if m_eq else None,
                                        dtype=np.float32)
        assert np.max(np.abs(x - xr)) <= F32_TOL
        assert np.max(np.abs(g)) <= F32_TOL and np.max(np.abs(gr)) <= F32_TOL
        assert np.max(np.abs(g - gr)) <= F32_TOL


class TestK1WideDims:
    @pytest.mark.timeout(60)
    @pytest.mark.parametrize("k,mE", [(5, 0), (4, 2), (7, 0)])
    def test_dim6_8_f64(self, k, mE):
        H, u, A, r = _family(k, mE, 24)
        (xr, gr, zr), (x, g, z) = _both(
            H[None], u[None], None if A is None else A[None],
            None if r is None else r[None])
        assert np.max(np.abs(x - xr)) <= F64_TOL
        assert np.max(np.abs(z - zr)) <= 1e-7
        assert abs(g[0]) < 1e-8 and abs(g[0] - gr[0]) <= F64_TOL

    @pytest.mark.timeout(90)
    @pytest.mark.parametrize("k,mE", [(11, 0), (13, 2), (15, 0)])
    def test_dim12_16_f64(self, k, mE):
        H, u, A, r = _family(k, mE, 24)
        (xr, gr, zr), (x, g, z) = _both(
            H[None], u[None], None if A is None else A[None],
            None if r is None else r[None])
        assert np.max(np.abs(x - xr)) <= F64_TOL
        assert abs(g[0]) < 1e-8 and abs(g[0] - gr[0]) <= F64_TOL
        if (k, mE) == (13, 2):
            # test_round5.py::test_multi_boundary_cold_start_converges_in_16:
            # 13 slack lams, all retired within the 16 steps by the
            # projected full-step candidate
            assert np.max(np.abs(z[0, :k])) == 0.0
            assert np.max(np.abs(zr[0, :k])) == 0.0

    @pytest.mark.timeout(60)
    def test_dim8_f32(self):
        H, u, A, r = _family(5, 2, 24)
        U = np.stack([u * s for s in (1.0, 1.05, 1.1)])
        (xr, gr, _), (x, g, _) = _both(
            np.broadcast_to(H, (3, 5, 24)), U, np.broadcast_to(A, (3, 2, 24)),
            np.broadcast_to(r, (3, 2)), dtype=np.float32)
        assert np.max(np.abs(x - xr)) <= F32_TOL
        assert np.max(np.abs(g)) <= F32_TOL


class TestK1PinnedInstances:
    @pytest.mark.timeout(60)
    def test_boundary_jam_instance(self):
        # test_round4.py::test_boundary_jam_instance_converges: instance
        # 5579 of the (k=5, n=100, seed 0) family, all five rows slack
        n, batch, k = 100, 10000, 5
        rng = np.random.default_rng(0)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        margins = rng.uniform(0.05, 0.15, (batch, k))
        u = (H @ x0)[None, :] + margins
        (xr, gr, zr), (x, g, z) = _both(H[None], u[5579][None],
                                        dtype=np.float32)
        assert abs(g[0]) < F32_TOL
        assert np.max(np.abs(z[0, :k])) == 0.0       # all lam purged
        assert abs(z[0, k] + 1.0) < 1e-4             # nu -> -1
        assert np.max(np.abs(x - xr)) <= F32_TOL

    @pytest.mark.timeout(60)
    def test_anti_parallel_instance(self):
        # test_round5.py::TestAntiParallelRows: the sick flag and the
        # Jacobi substitute unjam exactly anti-parallel rows
        pa, qa = 0.4444439978653988, 0.49597226141316375
        I_A = np.zeros(100); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A])
        (xr, gr, zr), (x, g, z) = _both(H[None], np.array([[-pa, qa]]),
                                        dtype=np.float32)
        assert abs(g[0]) < F32_TOL
        assert abs(float(np.sum(x[0, :3])) - pa) < 1e-5
        assert z[0, 1] == 0.0 and zr[0, 1] == 0.0   # redundant lam purged
        assert np.max(np.abs(x - xr)) <= F32_TOL

    @pytest.mark.timeout(60)
    def test_general_prior(self):
        # test_round3.py::TestGeneralPrior: instance 0 has an inactive row
        # (x* = p), instance 1 an active one (x* = the tilted prior)
        n = 20
        w = np.exp(0.7 * np.random.default_rng(42).standard_normal(n))
        p = w / w.sum()
        I4 = np.zeros(n); I4[:4] = 1.0
        I5 = np.zeros(n); I5[:5] = 1.0
        a = p[:5].sum() + 0.25
        H = np.stack([I4[None], -I5[None]])
        U = np.array([[0.999], [-a]])
        (xr, gr, zr), (x, g, z) = _both(H, U, log_prior=np.log(p))
        assert np.max(np.abs(x - xr)) <= F64_TOL
        assert np.max(np.abs(x[0] - p)) < 1e-9
        tilt = p * np.exp(z[1, 0] * I5)
        assert np.max(np.abs(x[1] - tilt / tilt.sum())) < 1e-9
        assert abs(x[1, :5].sum() - a) < 1e-9

    @pytest.mark.timeout(60)
    def test_dead_lane(self):
        # lane 1: B'z0 ~ 2000 underflows every exp, sum(y) = 0 -> gap +inf
        n = 40
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([np.stack([-I_A, I_A]), np.full((2, n), 1e6)])
        U = np.array([[-0.3, 0.6], [1e6, 1e6]])
        (xr, gr, zr), (x, g, z) = _both(H, U, dtype=np.float32)
        assert np.isposinf(g[1]) and np.isposinf(gr[1])
        assert np.array_equal(x[1], xr[1]) and np.array_equal(z[1], zr[1])
        assert abs(g[0]) < F32_TOL
        assert np.max(np.abs(x[0] - xr[0])) <= F32_TOL

    @pytest.mark.timeout(60)
    def test_ragged_batch_and_lanes(self):
        # B = 5 and n = 37 fit neither the reference's batch tile nor its
        # lane tile (it pads both); the port pads nothing
        n, B = 37, 5
        rng = np.random.default_rng(7)
        I_A = np.zeros(n); I_A[:3] = 1.0
        I_B = np.zeros(n); I_B[n // 2:] = 1.0
        H = np.stack([-I_A, I_B])
        U = np.column_stack([-rng.uniform(0.2, 0.5, B),
                             rng.uniform(0.55, 0.8, B)])
        for dtype, tol in ((np.float64, F64_TOL), (np.float32, F32_TOL)):
            (xr, gr, zr), (x, g, z) = _both(np.broadcast_to(H, (B, 2, n)), U,
                                            dtype=dtype)
            assert x.shape == (B, n) and g.shape == (B,) and z.shape == (B, 3)
            assert np.max(np.abs(x - xr)) <= tol
            assert np.max(np.abs(g)) <= tol


class TestK1Wrapper:
    @pytest.mark.timeout(30)
    def test_cpu_runs_plain_and_counts_no_launch(self):
        H = torch.tensor([[[-1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]]],
                         dtype=torch.float64)
        U = torch.tensor([[-0.6, 0.3]], dtype=torch.float64)
        before = kl_dual_fused.launches
        got = kl_dual_fused(H.expand(3, -1, -1), U.expand(3, -1))
        ref = kl_dual_fused_plain(H.expand(3, -1, -1).contiguous(),
                                  U.expand(3, -1).contiguous())
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert kl_dual_fused.launches == before

    @pytest.mark.timeout(30)
    def test_rejects_what_it_does_not_take(self):
        H = torch.zeros((2, 1, 8), dtype=torch.float64)
        U = torch.zeros((2, 1), dtype=torch.float64)
        with pytest.raises(ValueError, match="together"):
            kl_dual_fused(H, U, A=torch.zeros((2, 1, 8)))
        with pytest.raises(ValueError, match="<= 16"):
            kl_dual_fused(torch.zeros((2, 16, 8)), torch.zeros((2, 16)))
        with pytest.raises(ValueError, match="1 <= k \\+ m_eq"):
            kl_dual_fused(torch.zeros((2, 0, 8)), torch.zeros((2, 0)))
        with pytest.raises(ValueError, match="do not agree"):
            kl_dual_fused(H, torch.zeros((3, 1), dtype=torch.float64))
        with pytest.raises(ValueError, match="n_ls"):
            kl_dual_fused(H, U, n_ls=kl_dual._MAX_LS + 1)
        with pytest.raises(ValueError, match="CPU tensors or f32/f64 CUDA"):
            kl_dual_fused(H.to("meta"), U.to("meta"))



@pytest.mark.timeout(30)
def test_path_of_mirrors_the_kernel_source():
    # path_of is the C launchers' dispatch: its constants are
    # csrc/kl_dual.cu's, its rule the source's held_shape, group_max_warps
    # and group_warps
    src = (Path(kl_dual.__file__).parent / "csrc" / "kl_dual.cu").read_text()
    const = {m[1]: int(m[2]) for m in
             re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert kl_dual._MAX_LS == const["kMaxLs"]
    assert kl_dual._HELD_NC == const["kHeldNC"]
    assert kl_dual._HELD_MAX_DIM == const["kHeldMaxDim"]
    assert kl_dual._GROUP_NC == const["kGroupNC"]
    assert kl_dual._GROUP_FILL_WARPS == const["kGroupFillWarps"]
    assert kl_dual._GROUP_MAX_WARPS == const["kGroupMaxWarps"]
    assert kl_dual._GROUP_WIDE_DIM == const["kGroupWideDim"]
    assert kl_dual._GROUP_WIDE_MAX_WARPS == const["kGroupWideMaxWarps"]
    assert kl_dual._GROUP_BLOCK_WARPS == const["kGroupBlockWarps"]
    assert kl_dual._WARP_LOOP_MAX_DIM_F64 == const["kWarpLoopMaxDimF64"]
    flat = " ".join(src.replace("\\\n", " ").split())  # macros joined
    for rule in ("return k == dim - 1 && n <= 32 * kHeldNC;",
                 "return dim <= kGroupWideDim ? kGroupMaxWarps : "
                 "kGroupWideMaxWarps;",
                 "while (G < cap && 32 * G * kGroupNC < n && (long long)B * "
                 "G < kGroupFillWarps) G *= 2;",
                 "const int G = group_warps(dim, n, B), per = "
                 "group_per_block(G);",
                 "return G >= kGroupBlockWarps ? 1 : kGroupBlockWarps / G;",
                 "if constexpr (!held_type && D <= kWarpLoopMaxDimF64) { "
                 "if (G == 1) { kl_dual_kernel<D, 0, T>"):
        assert rule in flat, rule
    f32, f64 = torch.float32, torch.float64
    # held: f32, dual dim <= 8, no equality rows, n <= 128
    assert path_of(3, 2, 0, 100, 10000, f32) == "held"
    assert path_of(8, 7, 0, 128, 1, f32) == "held"
    assert path_of(3, 2, 0, 100, 10000, f64) == "warp loop"
    assert path_of(5, 4, 0, 100, 10000, f64) == ("group", 1)
    assert path_of(4, 2, 1, 100, 10000, f32) == ("group", 1)
    assert path_of(9, 8, 0, 100, 10000, f32) == ("group", 1)
    assert path_of(16, 15, 0, 24, 1, f32) == ("group", 1)
    # G doubles past each 128 G coordinates, up to its cap, while B G
    # warps do not fill the card
    for n, G in ((129, 2), (256, 2), (257, 4), (512, 4), (513, 8),
                 (1024, 8), (1025, 16), (10000, 16)):
        assert path_of(3, 2, 0, n, 8, f32) == ("group", G)
        assert path_of(3, 2, 0, n, 8, f64) == ("group", G)
        assert path_of(3, 2, 0, n, 4096, f64) == "warp loop"
        assert path_of(12, 9, 2, n, 8, f32) == ("group", min(G, 8))
    assert path_of(3, 2, 0, 10000, 100, f32) == ("group", 16)
    assert path_of(3, 2, 0, 1000, 1000, f32) == ("group", 2)
    assert path_of(3, 2, 0, 200, 10000, f32) == ("group", 1)
    # a block of one instance's G warps, or of kGroupBlockWarps one-warp
    # groups, stays within the kernel's launch bound
    for dim in range(2, 17):
        for dtype in (f32, f64):
            cap = 16 if dim <= 4 else 8
            for n in (1, 100, 129, 1000, 10 ** 6):
                path = path_of(dim, dim - 2, 1, n, 1, dtype)
                if path == "warp loop":
                    continue
                _, G = path
                per = 1 if G >= 4 else 4 // G
                assert G & (G - 1) == 0 and G * per <= max(cap, 4)
