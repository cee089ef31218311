"""The K2 / K3 operation and byte counts against hand counts at a tiny
size, and the frozen candidate count against the program's own."""

import pytest
import torch

from benchmark.work import kl_barrier, kl_dual, peaks


def test_least_seconds_takes_the_slower_bound():
    t, by = peaks.least_seconds(3.35e12, ops32=67e12 / 2)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = peaks.least_seconds(0, ops32=67e12, ops64=34e12)
    assert (t, by) == (pytest.approx(2.0), "operations")


def test_k2_counts_by_hand():
    # dim 3 (k = 2, the sum-to-one row): a step is 9 + 21 + 8 + 3 * 5 = 53,
    # 16 steps and the epilogue 2 * 3 + 9: 863 f32 operations a coordinate
    assert kl_dual.k1_ops_per_coord(3, 16) == 16 * 53 + 15 == 863
    # two f64 polish steps of 9 + 9 + 2 and the certificate 6 + 8 + 4
    assert kl_dual.k2_ops64_per_coord(3, 2, 0) == 2 * 20 + 18 == 58
    ops32, ops64, nbytes = kl_dual.k2_launch(B=2, n=3, k=2)
    assert ops32 == 2 * 3 * 863 and ops64 == 2 * 3 * 58
    # rows 2*3 f32, bounds 2*2 f32, log prior 3 f64; x 2*3, z 2*3 and three
    # leaves of 2, all f64
    assert nbytes == 24 + 16 + 24 + 48 + 48 + 48
    # the wide-dim candidate
    assert kl_dual.k1_ops_per_coord(9, 1) == 81 + 63 + 8 + 15 + 22 + 27


def test_k2_bound_at_the_north_star_shape():
    # 10,000 x n = 100 and 100 x n = 10,000 do the same work: operations
    # set it (the program's own figure, 0.01459 ms)
    for B, n in ((10000, 100), (100, 10000)):
        t, by = kl_dual.k2_least_seconds(B, n, 2)
        assert by == "operations"
        assert t * 1e3 == pytest.approx(0.01459, rel=2e-3)


def test_k3_counts_by_hand():
    # k = 2: 31 + 32 + 6 + 1 = 70 a coordinate a step, 8 a candidate
    assert kl_barrier.k3_ops(2, 3, 2, 5, 7) == 3 * (2 * 5 * 70 + 8 * 7)
    assert kl_barrier.k3_ops(1, 4, 1, 1, 0) == 4 * (31 + 16 + 2 + 1)
    # rows 2*3, ones 3, rhs 1, bounds 2*2, x0 and x 2*3 each, f32
    assert kl_barrier.k3_bytes(2, 3, 2) == (6 + 3 + 1 + 4 + 12) * 4
    # the fused route's schedule: 7 stages of 3 steps at n = 100, 8 at
    # n = 10,000 (bench.py's mu 55, tol 1e-8)
    pars = {"max_iter": 3, "mu": 55.0, "tol": 1e-8}
    assert kl_barrier.schedule(2, 100, pars) == (7, 3)
    assert kl_barrier.schedule(2, 10000, pars) == (8, 3)


@pytest.mark.parametrize("n,B", [(20, 16), (300, 3)])
def test_candidates_match_the_programs_plain_count(n, B):
    from cvx_tpu_torch.ops.kl_barrier import kl_barrier_fused_plain

    from benchmark.families import kl_bounds

    torch.set_num_threads(2)
    config = {"n": n, "batch": B, "dtype": "float32", "prior": "uniform",
              "start_margin": 0.05, "rows": [
                  {"sense": ">=", "start": 0, "stop": 3, "low": 0.2,
                   "high": 0.5},
                  {"sense": "<=", "start": n // 2, "stop": n, "low": 0.55,
                   "high": 0.8}]}
    mix = {"pool": 1, "inputs": ["u", "x0"]}
    H, (batch,) = kl_bounds.make_inputs(config, mix, 4, torch.device("cpu"))
    pars = {"max_iter": 3, "mu": 55.0, "tol": 1e-8}
    outer, inner = kl_barrier.schedule(2, n, pars)
    ones = torch.ones((B, 1, n))
    _, cand = kl_barrier_fused_plain(
        H[None].expand(B, -1, -1), batch["u"], ones, ones[:, :, 0],
        batch["x0"], mu=55.0, tol=1e-8, n_inner=inner,
        count_candidates=True)
    got = kl_barrier.candidates(H, batch["u"], batch["x0"], pars)
    assert got == int(cand.sum()) > 0
