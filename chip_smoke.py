"""Smoke run of ``cvx_tpu_torch`` on one NVIDIA GPU (H100).

Builds the port's CUDA kernels from ``cvx_tpu_torch/ops/csrc`` (one nvcc
per source, all started together), holds each kernel against its plain
PyTorch version on the card, drives the port's paths end to end through
the user entry points on bench.py's family at 10,000 instances x n = 100:

* the batched certified KL dual solve (``DistKL.create`` ->
  ``solve_certified_batch`` / ``solve``; kernels K1 and K2);
* the batched primal KL solve (``solve_jittable_batch`` /
  ``solve_jittable`` with ``method="fused"``; kernel K3, then the gap
  kernel ``kl_gap_fused`` for its measured certificate), also on K3's
  group path (n > 256) at 1,000 x n = 1,000 and 100 x n = 10,000;
* the batched Cholesky (``ops.chol.cholesky_batched(method="cuda")`` on
  4096 matrices of n = 100; kernel K4);
* the generic interior-point core in f64 (phase 4b): ``solve()`` (the
  barrier on the dual), ``solve("BR")`` and ``solve("PD")`` (phase-I, then
  the primal barrier or primal-dual method) and ``solve("fused")`` (phase-I,
  then K3 and the gap kernel) on one instance,
  ``solve_jittable_batch(method="BR")`` and
  ``feasibility_batch`` at 10,000 instances, and an infeasible problem;
* phase 4c: the fleet screen (``DistKL.feasibility_screen_batch``, f32
  and f64, 10,000 x n = 100, and the eq-fold family), the QP fleet
  (``QP.solve_certified`` at (n, m, p, B) = (128, 64, 4, 512) and (1000,
  500, 10, 100)), a resume of the first from a checkpoint on disk,
  ``minimize`` with "BR", "PD" and "BR_fast", a DiagQP batch (with its
  masked loop's steps by outer stage) and an LP batch, and the exact-f32
  guard of the solvers, none of which launches a kernel;
* phase 4d: the parallel layer (``cvx_tpu_torch.parallel``) on a
  one-rank NCCL group: ``shard_solve`` of ``solve_certified_batch`` at
  10,000 x n = 100 (K2 once, the same bits as the local call), north-star
  config 5 (64 blocks of 156, the Schur consensus and its certificate),
  the m-sharded barrier and primal-dual at m = 4096, n = 128, and
  ``tp_chol`` at n = 4096 and 8192 against ``torch.linalg.cholesky``;
  then four gloo ranks on the one card hold (a) and config 5 sharded;
* phase 4e: ``ops.ruiz_equilibrate0`` on the card against the CPU;

times the kernels with CUDA events beside their plain versions, a library
call where one computes the same function, and the least time the card
could take (``bound_ms``), measures the host wall and device busy share of
each path, and prints one JSON line per result.  Any failed check raises.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero, printing no result, without one.
Imports nothing of JAX: inputs are made with numpy or torch from fixed
seeds.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# the data recipes, the kernels' tolerances against their plain versions
# (K1, K2, K4), the bound helpers and the card's peak rates, shared with
# bench_scaling_torch.py and probe_structured.py
from cvx_tpu_torch._bench import (CERT_GAP, K1_DZ, K1_F64_DZ, K1_F64_TOL,
                                  K1_TOL, K2_DGAP, K2_DRES, K2_DX, K2_DZ,
                                  K4_F64_TOL, K4_TOL, KGAP_DGAP, KGAP_DZ,
                                  KGAP_F64_TOL, PRIMAL_CERT, PRODUCTION,
                                  TOL_FEAS, bench_family, bound, bytes_in,
                                  bytes_out, diagqp_data, feasible_points,
                                  k1_agreement, k1_ops_per_coord,
                                  k2_agreement, k2_ops64_per_coord, k3_ops,
                                  k4_bytes, kgap_ops, max_abs, primal_args,
                                  qp_fleet_data, separable_data)

# K3 against its plain version: late Armijo decisions at t ~ 1e10 sit at
# the f32 resolution of the barrier value, so another summation order may
# take another candidate (max |dx| ~ 1e-7 on the CPU against the
# reference); f64 differs by summation order only.  The measured gaps of
# the two x to 1e-5 (kl_dual_gap's f32 floor), the stall flags exactly.
K3_TOL, K3_F64_TOL, K3_DGAP = 1e-5, 1e-11, 1e-5
# K4's backward error ||L L^T - X|| / ||X|| may exceed
# torch.linalg.cholesky's own by this factor (plus 10 eps)
K4_RECON_FACTOR = 10.0
PRIMAL_GAP = math.sqrt(torch.finfo(torch.float32).eps)   # the stall rule
PRIMAL_DOBJ = 1e-4   # |f(x_primal) - f(x_certified)| per instance
# the generic core (phase 4b, f64): max |dx| against K2's certified x of the
# same instance (the barrier's gap bound m/t is <= 1e-8), and the host f64
# certificate |gap| of each x
GEN_DX, GEN_CERT = 1e-5, 1e-6
# phase 4c: the fleet screen's bounds recomputed on the host from its x and
# w, and |sum x - 1| (f32, f64); (TOL_FEAS, the QP family's residual
# contract); a resumed and certified QP fleet against straight through
SCREEN_F32, SCREEN_F64 = 1e-5, 1e-12
# phase 4d (the parallel layer): config 5's sharded run against its local
# run, the m-sharded solvers against the port's local solvers (max |dx|),
# tp_chol against torch.linalg.cholesky (max |dL| / max |L|, f64)
SCHUR_DX = 1e-10
MSHARD_DX = 1e-6
TP_CHOL_REL = 1e-12
RESUME_DX = 1e-6
# phase 4e: the Ruiz variant on the card against the CPU, relative to the
# largest entry (f64; the row norms sum in another order)
RUIZ_REL = 1e-12


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")
    print(f"  ok: {msg}")


def random_family(k, m_eq, n, B, seed=0):
    """The dim-8/16 stress family of the reference's tests, with B scaled
    copies of the bounds."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = rng.uniform(0.0, 1.0, (m_eq, n))
    U = np.stack([u * s for s in np.linspace(1.0, 1.1, B)])
    R = np.broadcast_to(A @ x0, (B, m_eq))
    return H, U, A, R


def dual_cases(dev):
    """(name, Hs, U, A, R) on the card: shared rows are stride-0 expands."""
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    out = []
    H, U = bench_family(10000, 100, seed=0)
    out.append(("bench 10000 x n=100 (dim 3)",
                t(H)[None].expand(10000, -1, -1), t(U), None, None))
    # n = 100: every dual dim with a held path in kl_dual.cu (2 to 8, no
    # extra equality rows; dim 3 is the bench shape), the first without
    # (9), and dim 4 with an equality row (the group path)
    for k, m_eq, n in ((2, 0, 24), (7, 0, 24), (5, 2, 24), (15, 0, 24),
                       (13, 2, 24), (1, 0, 100), (3, 0, 100), (4, 0, 100),
                       (5, 0, 100), (6, 0, 100), (7, 0, 100), (8, 0, 100),
                       (2, 1, 100)):
        H, U, A, R = random_family(k, m_eq, n, 256)
        Ab = t(A)[None].expand(256, -1, -1) if m_eq else None
        out.append((f"family k={k} mE={m_eq} n={n} (dim {k + 1 + m_eq})",
                    t(H)[None].expand(256, -1, -1), t(U), Ab,
                    t(R) if m_eq else None))
    I_A = np.zeros(100); I_A[:3] = 1.0
    out.append(("anti-parallel jammed instance",
                t(np.stack([-I_A, I_A]))[None],
                t([[-0.4444439978653988, 0.49597226141316375]]), None, None))
    # lane 3 is dead: B'z0 ~ 2000 underflows every exp, sum(y) = 0
    H, U = bench_family(4, 100, seed=1)
    Hs = np.repeat(H[None], 4, axis=0); Hs[3] = 1e6
    U[3] = 1e6
    out.append(("dead lane (lane 3)", t(Hs), t(U), None, None))
    H, U = bench_family(37, 77, seed=2)
    out.append(("ragged B=37 n=77", t(H)[None].expand(37, -1, -1), t(U),
                None, None))
    # the last n a lane holds in registers and the first on the group path,
    # each n where the group path's G doubles (kl_dual.path_of) and one
    # past it, and large n
    for n, B in ((128, 256), (129, 256), (256, 16), (257, 16), (512, 16),
                 (513, 16), (1000, 64), (1024, 16), (1025, 16), (2048, 8),
                 (2049, 8), (10000, 8),
                 # one warp an instance (B fills the card): a lane adds 8
                 # terms a sum uncompensated, then 9 compensated
                 (256, 1024), (257, 1024)):
        H, U = bench_family(B, n, seed=n)
        out.append((f"family of bench.py B={B} n={n}",
                    t(H)[None].expand(B, -1, -1), t(U), None, None))
    # the group path at the wide dims: dim 16 and dim 12 with equality rows
    # at n = 100, dim 9 past its G cap (8 warps from n = 1,025)
    for k, m_eq, n, B in ((15, 0, 100, 256), (9, 2, 100, 256),
                          (8, 0, 1025, 16)):
        H, U, A, R = random_family(k, m_eq, n, B)
        Ab = t(A)[None].expand(B, -1, -1) if m_eq else None
        out.append((f"family k={k} mE={m_eq} n={n} (dim {k + 1 + m_eq})",
                    t(H)[None].expand(B, -1, -1), t(U), Ab,
                    t(R) if m_eq else None))
    # the sick and dead-lane rules on the group path (n = 200, two warps)
    I_A = np.zeros(200); I_A[:3] = 1.0
    out.append(("anti-parallel jammed instance n=200",
                t(np.stack([-I_A, I_A]))[None],
                t([[-0.4444439978653988, 0.49597226141316375]]), None, None))
    H, U = bench_family(4, 200, seed=1)
    Hs = np.repeat(H[None], 4, axis=0); Hs[3] = 1e6
    U[3] = 1e6
    out.append(("dead lane (lane 3) n=200", t(Hs), t(U), None, None))
    # the scaling ladder's kl_batch at n = 10,000: with uncompensated lane
    # sums, lane 20 stopped at gap 1.4e-3 (kl_dual.cu, LaneSum)
    H, U = bench_family(100, 10000, seed=0)
    out.append(("ladder kl_batch B=100 n=10000",
                t(H)[None].expand(100, -1, -1), t(U), None, None))
    return out


def mixed_batch(n, B, frac_infeasible=0.25, seed=0):
    """tests/test_round5.py:293-305: P(A) >= pA and P(A) <= qA (|A| = 3),
    with qA < pA (infeasible) on every 4th instance; returns (H, U, bad)."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[:: int(1 / frac_infeasible)] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return np.stack([-I_A, I_A]), np.stack([-pA, qA], axis=1), bad


def primal_cases(dev):
    """(name, dtype, K3 args, line-search options) for phase 3."""
    out = []
    H, U = bench_family(10000, 100, seed=0)
    bench = primal_args(H, U, feasible_points(U, 100), dev)
    out.append(("bench 10000 x n=100, k=2", torch.float32, bench, {}))
    out.append(("bench 10000 x n=100, k=1", torch.float32,
                primal_args(H[:1], U[:, :1], feasible_points(U, 100), dev),
                {}))
    # one candidate; 40 (exponents past 32); increasing candidates, where
    # the kernel evaluates all of them and keeps the longest accepted
    for ls in (dict(n_ls=1), dict(n_ls=40), dict(beta=1.25)):
        out.append((f"bench 10000 x n=100, k=2, {ls}", torch.float32, bench,
                    ls))
    H, U = bench_family(37, 77, seed=2)
    for dtype in (torch.float32, torch.float64):
        out.append((f"ragged B=37 n=77 {str(dtype)[6:]}", dtype,
                    primal_args(H, U, feasible_points(U, 77), dev, dtype),
                    {}))
    # lane 2 starts on a bound (x0 = 0 at one coordinate): log 0 and 1/0
    # make its dx non-finite, and the no-step guard must hold it at x0
    H, U = bench_family(4, 100, seed=3)
    X0 = feasible_points(U, 100); X0[2, 40] = 0.0
    out.append(("x0 on a bound (lane 2)", torch.float32,
                primal_args(H, U, X0, dev), {}))
    # the group path (n > 256; kl_barrier.path_of): each n in f32 and f64,
    # ragged batches, x, log x and dx in registers, shared memory and
    # global memory (f64 past a block's shared memory), one-warp groups
    for B, n, k, dtype in ((37, 257, 2, torch.float32),
                           (37, 257, 1, torch.float64),
                           (16, 300, 2, torch.float32),
                           (16, 300, 1, torch.float64),
                           (13, 1000, 1, torch.float32),
                           (1000, 1000, 2, torch.float32),
                           (1000, 1000, 2, torch.float64),
                           (10000, 300, 2, torch.float32),
                           (100, 10000, 2, torch.float32),
                           (100, 10000, 1, torch.float64),
                           (4, 30000, 2, torch.float64)):
        H, U = bench_family(B, n, seed=n + k)
        out.append((f"group B={B} n={n} k={k} {str(dtype)[6:]}", dtype,
                    primal_args(H[:k], U[:, :k], feasible_points(U, n), dev,
                                dtype), {}))
    H, U = bench_family(4, 300, seed=3)
    X0 = feasible_points(U, 300); X0[2, 40] = 0.0
    out.append(("x0 on a bound (lane 2), group n=300", torch.float32,
                primal_args(H, U, X0, dev), {}))
    return out


def spd_batch(B, n, dtype, dev, seed):
    """B SPD matrices A A^T / n + 0.01 I, A standard normal (condition
    ~1e3), made on the card from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device=dev,
                    dtype=torch.float64)
    X = A @ A.transpose(1, 2) / n + 0.01 * torch.eye(n, device=dev,
                                                     dtype=torch.float64)
    return X.to(dtype)


def k4_cases(dev):
    """(name, X) for phase 3's K4 checks, one lane of each not SPD: the
    sweep's n and a ragged one, n = 1, 2 and 33, the held path's last n
    and the panel path's first in each type; on the panel path ragged n
    (257 and 500 in f32, 300 in f64), ``max_n(dtype)`` at a small batch
    and a failed pivot in a late column block (n = 512, pivot 300); at n =
    100 a failed pivot in column 0, a zero pivot (row and column 50 zero:
    the pivot is exactly 0, 1/sqrt(0) = inf and 0 * inf = NaN) and a
    failed pivot in the last, ragged column block."""
    from cvx_tpu_torch.ops.chol import held_max_n, max_n

    out = []
    for dtype in (torch.float32, torch.float64):
        held = held_max_n(dtype)
        ragged = {(257, 11), (500, 7)} if dtype == torch.float32 else {
            (300, 11)}
        for n, B in sorted({(1, 67), (2, 67), (33, 67), (77, 67), (100, 67),
                            (128, 67), (held, 67), (held + 1, 67), (256, 23),
                            (512, 13), (max_n(dtype), 3)} | ragged):
            X = spd_batch(B, n, dtype, dev, seed=n)
            X[B // 2, n // 3, n // 3] = -1.0   # one lane is not SPD
            out.append((f"{str(dtype)[6:]} B={B} n={n}", X))
        X = spd_batch(13, 512, dtype, dev, seed=1512)
        X[6, 300, 300] = -1.0
        out.append((f"{str(dtype)[6:]} B=13 n=512, failed pivot in column "
                    "300 (a late column block)", X))
        for m, where in enumerate(("failed pivot in column 0",
                                   "zero pivot in column 50",
                                   "failed pivot in column 97 (last block)")):
            X = spd_batch(67, 100, dtype, dev, seed=1000 + m)
            if where.startswith("zero"):
                X[33, 50, :] = 0.0
                X[33, :, 50] = 0.0
            else:
                k = 0 if "column 0" in where else 97
                X[33, k, k] = -1.0
            out.append((f"{str(dtype)[6:]} B=67 n=100, {where}", X))
    return out


def compare_k1(name, got, ref, tol, ztol):
    a = k1_agreement(got, ref, tol, ztol)
    check(a["dead_same"], f"K1 {name}: identical dead lanes ({a['dead']})")
    print(f"  K1 {name}: {a['converged']}/{a['lanes']} lanes converged; "
          f"max|dx| {a['dx']:.3e} (all live lanes {a['dx_all']:.3e}); "
          f"max|dz|/(1+|z|) {a['dz']:.3e}; max|gap| {a['gap']:.3e}")
    check(a["close"],
          f"K1 {name}: max|dx| <= {tol:g}, |gap| <= {a['gtol']:g}, z within "
          f"{ztol:g} on converged lanes")
    return a["dx"]


def compare_k2(name, got, ref):
    a = k2_agreement(got, ref)
    check(a["dead_same"], f"K2 {name}: identical dead lanes")
    print(f"  K2 {name}: {a['certified']}/{a['lanes']} lanes certified; "
          f"max|dx| {a['dx']:.3e}; max|dgap| {a['dgap']:.3e}; max|dz|/(1+|z|)"
          f" {a['dz']:.3e}; max|d ineq_res|, |d eq_res| {a['dres']:.3e}")
    check(a["close"],
          f"K2 {name}: max|dx| <= {K2_DX:g}, |dgap| <= {K2_DGAP:g}, z "
          f"within {K2_DZ:g}, residuals within {K2_DRES:g}")
    return a["dx"]


def compare_k3(name, dtype, args, ls, kern, plain, prob=None, pars=None):
    """K3 against its plain version on x, with the line-search options
    ``ls``; on the bench shape also the measured gap and the stall flags of
    the fused route's Solution, and x the same bits."""
    kw = dict(mu=PRODUCTION["mu"], n_inner=PRODUCTION["max_iter"], **ls)
    xk = kern(*args, **kw)
    xp, cand = plain(*args, count_candidates=True, **kw)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(xk), torch.isnan(xp)
    check(torch.equal(nan_k, nan_p), f"K3 {name}: NaN in the same places "
          f"({int(nan_p.sum())})")
    dx = float((xk - xp).nan_to_num().abs().max())
    tol = K3_TOL if dtype == torch.float32 else K3_F64_TOL
    if name.startswith("bench") and not ls:
        tol = 0.0      # the bench family with the default search: same bits
    from cvx_tpu_torch.ops.kl_barrier import fused_n_outer, path_of
    B_c, k_c, n_c = args[0].shape
    steps = fused_n_outer(k_c + n_c, mu=kw["mu"]) * kw["n_inner"]
    print(f"  K3 {name} (path {path_of(n_c, B_c, dtype)}"
          f"): max|dx| {dx:.3e}; line-search candidates per step "
          f"{float(cand.double().mean()) / steps:.4f}")
    check(dx <= tol, f"K3 {name}: max|dx| <= {tol:g}")
    if prob is not None:
        schedule = prob._fused_schedule(pars)
        sk = prob._fused_solution(args[1], xk, schedule)
        sp = prob._fused_solution(args[1], xp, schedule)
        dg = float((sk.duality_gap - sp.duality_gap).abs().max())
        print(f"  K3 {name}: max|gap| kernel {float(sk.duality_gap.abs().max()):.3e}"
              f", plain {float(sp.duality_gap.abs().max()):.3e}; max|dgap| "
              f"{dg:.3e}; stalled {int(sk.stalled.sum())}, "
              f"{int(sp.stalled.sum())}")
        check(dg <= K3_DGAP and torch.equal(sk.stalled, sp.stalled),
              f"K3 {name}: measured gaps within {K3_DGAP:g}, identical "
              "stalled flags")
    return dx, xk


def gap_args(H, U, x):
    """``kl_gap_fused``'s arguments for the primal route's certificate of
    iterates x (B, n) of bench.py's family: the rows, the bounds, the
    sum-to-one row and its right-hand side."""
    B, n = x.shape
    ones = torch.ones((1, n), dtype=x.dtype, device=x.device)
    return (torch.as_tensor(H, dtype=x.dtype, device=x.device),
            torch.as_tensor(U, dtype=x.dtype, device=x.device), ones,
            torch.ones((B, 1), dtype=x.dtype, device=x.device), x)


def compare_gap(name, args, kern, plain, prior=None):
    """The gap kernel against its plain version on the same inputs: the
    same non-finite lanes, gap and z within KGAP_* (f32) or KGAP_F64_TOL,
    each relative to 1 + its magnitude.  Returns that max |dgap|."""
    x = args[4]
    gk, zk = kern(*args, prior=prior)
    gp, zp = plain(*args, prior=prior)
    torch.cuda.synchronize()
    fin = torch.isfinite(gp) & torch.isfinite(zp).all(dim=1)
    check(torch.equal(torch.isfinite(gk), torch.isfinite(gp)),
          f"gap kernel {name}: non-finite gaps in the same lanes "
          f"({int((~fin).sum())})")
    dg = max_abs(((gk - gp) / (1.0 + gp.abs()))[:, None], fin)
    dz = max_abs((zk - zp).abs() / (1.0 + zp.abs()), fin)
    tg, tz = ((KGAP_DGAP, KGAP_DZ) if x.dtype == torch.float32
              else (KGAP_F64_TOL, KGAP_F64_TOL))
    print(f"  gap kernel {name}: max|dgap|/(1+|gap|) {dg:.3e}, "
          f"max|dz|/(1+|z|) {dz:.3e}; max|gap| "
          f"{max_abs(gp[:, None], fin):.3e}")
    check(dg <= tg and dz <= tz, f"gap kernel {name}: |dgap|/(1+|gap|) <= "
          f"{tg:g}, |dz|/(1+|z|) <= {tz:g}")
    return dg


def recon_err(L, X):
    """Per-matrix ||L L^T - X||_F / ||X||_F, in f64."""
    L64, X64 = L.double(), X.double()
    return (torch.linalg.matrix_norm(L64 @ L64.transpose(1, 2) - X64)
            / torch.linalg.matrix_norm(X64))


def compare_k4(name, X, kern, plain, Lk=None):
    """K4 against its plain version (NaN pattern, max |dL|) and its
    backward error against torch.linalg.cholesky's; ``Lk`` is the kernel's
    factor where the caller already has it (else ``kern(X)``)."""
    Lk = kern(X) if Lk is None else Lk
    Lp = plain(X)
    Ll, info = torch.linalg.cholesky_ex(X)
    torch.cuda.synchronize()
    check(torch.equal(torch.isnan(Lk), torch.isnan(Lp)),
          f"K4 {name}: NaN in the same places "
          f"({int(torch.isnan(Lp).any(dim=(1, 2)).sum())} lanes)")
    ok = ~torch.isnan(Lp).any(dim=(1, 2))
    check(bool(ok.any()) and bool((info[ok] == 0).all())
          and torch.equal(~ok, info > 0),
          f"K4 {name}: the non-SPD lanes are exactly those "
          "torch.linalg.cholesky refuses")
    scale = float(Lp[ok].abs().max())
    dL = float((Lk[ok] - Lp[ok]).abs().max())
    tol = K4_TOL if X.dtype == torch.float32 else K4_F64_TOL
    rk = float(recon_err(Lk[ok], X[ok]).max())
    rl = float(recon_err(Ll[ok], X[ok]).max())
    eps = torch.finfo(X.dtype).eps
    print(f"  K4 {name}: max|dL| {dL:.3e} (max|L| {scale:.3e}); "
          f"||LL'-X||/||X|| kernel {rk:.3e}, torch.linalg.cholesky {rl:.3e}")
    check(dL <= tol * scale and rk <= K4_RECON_FACTOR * rl + 10 * eps
          and torch.equal(torch.triu(Lk[ok], 1), torch.zeros_like(Lk[ok])),
          f"K4 {name}: max|dL| <= {tol:g} max|L|, backward error <= "
          f"{K4_RECON_FACTOR:g}x torch.linalg.cholesky's, upper triangle 0")
    return dL


def time_ms(fn, reps):
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps, order):
    """Best ms of each named function, timed in the given order."""
    runs = {name: [] for name in fns}
    for name in order:
        runs[name].append(time_ms(fns[name], reps[name]))
    return {name: min(v) for name, v in runs.items()}, runs


def kernel_counts(*kernels):
    return {k.__name__: k.launches for k in kernels}


def zero_counts(*kernels):
    for k in kernels:
        k.launches = 0


def device_busy(fn, reps, warm=True, raw=False, timed=True):
    """(host wall ms median of ``reps`` calls ending in synchronize(),
    device busy ms per call and device ops per call from a torch.profiler
    trace of ``reps`` calls); the profiler figures are None where the
    trace holds no device time.  ``warm=False`` skips the warm-up call
    (the caller has made one).  ``raw=True`` traces the device activity
    alone and sums its raw events: for calls of a million launches, where
    tracing the host ops and ``key_averages`` take many minutes.
    ``timed=False`` skips the separate timed calls (a route of tens of
    seconds): the host wall is then that of the traced calls themselves,
    the tracing's cost included."""
    if warm:
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps if timed else 0):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA] if raw else
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / reps
    wall = statistics.median(walls) if timed else traced
    busy_us, ops = 0.0, 0
    if raw:
        for evt in prof.profiler.kineto_results.events():
            if evt.device_type() == torch.autograd.DeviceType.CUDA:
                busy_us += evt.duration_ns() / 1e3
                ops += 1
    else:
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
            if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                busy_us += us
                ops += evt.count
    if busy_us <= 0:
        return wall, None, None
    return wall, busy_us / 1e3 / reps, ops / reps


def generic_core(dev, kernels, H, U, x_cert):
    """Phase 4b: the generic core through the entry points, in f64, each
    route with the counters set to 0 just before it and read just after.
    Returns phase 6's timed calls of the two batched routes."""
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.solvers import InfeasibleProblemError

    print("phase 4b: the generic core (f64)")
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls at full precision (no TF32)")
    f64 = dict(dtype=torch.float64, device=dev)
    none = {k.__name__: 0 for k in kernels}
    one = DistKL.create(100, H=torch.tensor(H, **f64),
                        u=torch.tensor(U[0], **f64))
    for method in ("dual", "BR", "PD", "fused"):
        zero_counts(*kernels)
        t0 = time.perf_counter()
        s = one.solve() if method == "dual" else one.solve(method)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts(*kernels)
        want = dict(none, kl_barrier_fused=int(method == "fused"),
                    kl_gap_fused=int(method == "fused"))
        x = s.x
        dx = float((x - x_cert[0].to(x.dtype)).abs().max())
        gap = float(kl_gap_certificate_np(x[None].cpu().numpy(), H,
                                          U[:1])[0])
        print(f"  solve({method!r}) from the uniform point: {wall:.3f} s, "
              f"iters {int(s.iters)}, max|dx| vs K2 {dx:.3e}, host "
              f"certificate {gap:.3e}, launches {launches}")
        check(launches == want,
              f"solve({method!r}) launched "
              + ("K3 once and the gap kernel once (its certificate), "
                 "nothing else" if method == "fused"
                 else "none of the kernels"))
        check(bool(torch.isfinite(x).all()) and dx <= GEN_DX
              and abs(gap) <= GEN_CERT and not bool(s.stalled),
              f"solve({method!r}): max|dx| <= {GEN_DX:g} against K2's "
              f"certified x, |certificate| <= {GEN_CERT:g}, not stalled")

    B = U.shape[0]
    prob = DistKL.create(100, H=torch.tensor(H, **f64),
                         u=torch.zeros(2, **f64))
    Ut = torch.tensor(U, **f64)
    X0 = torch.tensor(feasible_points(U, 100), **f64)
    torch.cuda.synchronize()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    sol = prob.solve_jittable_batch(Ut, X0, method="BR")
    torch.cuda.synchronize()
    wall = wall_br = time.perf_counter() - t0
    launches = kernel_counts(*kernels)
    certs = kl_gap_certificate_np(sol.x.cpu().numpy(), H, U)
    dx = float((sol.x - x_cert.to(sol.x.dtype)).abs().max())
    nst = int(sol.stalled.sum())
    print(f"  solve_jittable_batch(method='BR') {B} x n=100: {wall:.3f} s; "
          f"Newton steps, the batch's longest {int(sol.iters.max())}, "
          f"median {float(sol.iters.double().median()):.0f}; stalled {nst}; "
          f"max|certificate| {np.abs(certs).max():.3e}; max|dx| vs K2 "
          f"{dx:.3e}; launches {launches}")
    check(launches == none,
          "the batched BR route launched none of the kernels")
    check(tuple(sol.x.shape) == (B, 100) and nst == 0
          and float(np.abs(certs).max()) <= GEN_CERT and dx <= GEN_DX,
          f"batched BR: 0 stalled, every |certificate| <= {GEN_CERT:g}, "
          f"max|dx| <= {GEN_DX:g} against K2's certified x")

    Hm, Um, bad = mixed_batch(100, B)
    screen = DistKL.create(100, H=torch.tensor(Hm, **f64),
                           u=torch.zeros(2, **f64))
    Umt = torch.tensor(Um, **f64)
    # feasibility_batch is _screen's report cut to two leaves: keep the
    # report of each call, for phase 6's step counts
    report, screen_report = {}, screen._screen

    def keep_report(u, pars):
        report["rep"] = screen_report(u, pars)
        return report["rep"]

    screen._screen = keep_report
    torch.cuda.synchronize()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    s_max, strict = screen.feasibility_batch(Umt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_counts(*kernels)
    flagged = (s_max > 0).cpu().numpy()
    print(f"  feasibility_batch {B} x n=100 ({int(bad.sum())} infeasible): "
          f"{wall:.3f} s; flagged {int(flagged.sum())}; launches "
          f"{launches}")
    check(launches == none, "feasibility_batch launched none of the kernels")
    check(np.array_equal(flagged, bad)
          and np.array_equal(strict.cpu().numpy(), ~bad),
          "feasibility_batch: s_max > 0 exactly on the infeasible lanes, "
          "strictly_feasible exactly on the others")

    # tests/test_kl.py:106-121: P(A) >= .51 and P(B) >= .51, A and B
    # disjoint
    I_A = np.zeros(20); I_A[:3] = 1.0
    I_B = np.zeros(20); I_B[10:] = 1.0
    bad_prob = DistKL.create(20, H=torch.tensor(np.stack([-I_A, -I_B]), **f64),
                             u=torch.tensor([-0.51, -0.51], **f64))
    rep = bad_prob.feasibility()
    check(not bool(rep.strictly_feasible) and float(rep.s_max) > 0,
          f"infeasible problem: feasibility() not strictly feasible, s_max "
          f"{float(rep.s_max):.3e} > 0")
    raised = False
    try:
        bad_prob.solve("BR")
    except InfeasibleProblemError:
        raised = True
    check(raised, "infeasible problem: solve('BR') raised "
          "InfeasibleProblemError")
    # phase 6's rows: (label, call, Newton steps of the batch's longest
    # instance, or a function that reads them after the call, the host
    # wall ms of the untraced call above: the same route, tens of seconds)
    return (("generic BR, solve_jittable_batch(method='BR')",
             lambda: prob.solve_jittable_batch(Ut, X0, method="BR"),
             int(sol.iters.max()), wall_br * 1e3),
            ("generic phase-I, feasibility_batch",
             lambda: screen.feasibility_batch(Umt),
             lambda: int(report["rep"].iters.max()), wall * 1e3))


def primal_group_routes(dev, kernels, pars, main_launches,
                        shapes=(("n1000", 1000, 1000), ("n10000", 100, 10000)),
                        sync=torch.cuda.synchronize):
    """The primal route ``solve_jittable_batch(method="fused")`` on K3's
    group path (n > 256; ``kl_barrier.path_of``): bench.py's family, numpy
    seed 0, f32, bench.py's schedule, at each (label, B, n) of ``shapes``,
    with the counters set to 0 just before it and read just after (into
    ``main_launches``); then K3 against its plain version on the route's
    inputs, and both x's host f64 certificates, the kernel's no worse than
    the plain x's (to K3_DGAP).  Returns {label: phase 5's inputs}."""
    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.ops.kl_barrier import (fused_n_outer,
                                              kl_barrier_fused_plain, path_of)
    from cvx_tpu_torch.ops.kl_gap import kl_gap_fused, kl_gap_fused_plain
    f32 = dict(dtype=torch.float32, device=dev)
    primal_group = {}
    kw3 = dict(mu=PRODUCTION["mu"], n_inner=PRODUCTION["max_iter"])
    for label, B_r, n_r in shapes:
        Hr, Ur = bench_family(B_r, n_r, seed=0)
        X0r = feasible_points(Ur, n_r).astype(np.float32)
        prob_r = DistKL.create(n_r, H=Hr.astype(np.float32),
                               u=np.zeros(2, np.float32))
        Urt, X0rt = torch.tensor(Ur, **f32), torch.tensor(X0r, **f32)
        sync()
        zero_counts(*kernels)
        rsol = prob_r.solve_jittable_batch(Urt, X0rt, method="fused",
                                           pars=pars)
        sync()
        launches = kernel_counts(*kernels)
        steps = fused_n_outer(2 + n_r, mu=PRODUCTION["mu"]) * kw3["n_inner"]
        print(f"  primal route {label} ({B_r} x n={n_r}, K3 path "
              f"{path_of(n_r, B_r, torch.float32)}): launches {launches}")
        check(launches == {"kl_dual_fused": 0, "kl_dual_fused_cert": 0,
                           "kl_barrier_fused": 1, "cholesky_batched_cuda": 0,
                           "kl_gap_fused": 1},
              f"the primal route {label} launched K3 once and the gap "
              "kernel once (its certificate), nothing else")
        main_launches[f"kl_barrier_fused_group_{label}"] = launches[
            "kl_barrier_fused"]
        main_launches[f"kl_gap_fused_{label}"] = launches["kl_gap_fused"]
        nst = int(rsol.stalled.sum())
        check(tuple(rsol.x.shape) == (B_r, n_r)
              and bool(torch.isfinite(rsol.x).all())
              and bool((rsol.iters == steps).all()) and nst == 0,
              f"primal route {label}: x finite, shape ({B_r}, {n_r}), "
              f"{steps} Newton steps each, stalled {nst}")
        kargs_r = primal_args(Hr, Ur, X0r, dev)
        xp_r = kl_barrier_fused_plain(*kargs_r, **kw3)
        sync()
        err = float((rsol.x - xp_r).nan_to_num().abs().max())
        check(torch.equal(torch.isnan(rsol.x), torch.isnan(xp_r))
              and err <= K3_TOL,
              f"primal route {label}: K3's x against the plain version's "
              f"on the same inputs, max|dx| {err:.3e} <= {K3_TOL:g}")
        cert_k = kl_gap_certificate_np(rsol.x.cpu().numpy(), Hr, Ur)
        cert_p = kl_gap_certificate_np(xp_r.cpu().numpy(), Hr, Ur)
        print(f"  primal route {label}: kl_gap_certificate_np max kernel "
              f"{cert_k.max():.3e}, plain {cert_p.max():.3e}; median "
              f"{np.median(cert_k):.3e}, {np.median(cert_p):.3e}")
        check(float(cert_k.max()) <= float(cert_p.max()) + K3_DGAP,
              f"primal route {label}: host f64 certificate of K3's x no "
              f"worse than the plain x's (to {K3_DGAP:g})")
        gargs = gap_args(Hr, Ur, rsol.x)
        primal_group[label] = dict(
            args=kargs_r, err=err, steps=steps, gap_args=gargs,
            gap_err=compare_gap(f"primal route {label}", gargs,
                                kl_gap_fused, kl_gap_fused_plain))
    return primal_group


def screen_family(B, n, seed=7):
    """bench_scaling.py:772-777: H = [-1_A; 1_A] (|A| = 3), pA ~ U(0.3,
    0.5), qA = pA + U(0.05, 0.2), every 10th instance infeasible with qA =
    pA - U(0.05, 0.1); returns (H, U, bad)."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[::10] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return np.stack([-I_A, I_A]), np.stack([-pA, qA], axis=1), bad


def eq_fold_family(B, n, seed=2):
    """tests/test_round5.py:458-490 at width B x n: the screen family with
    pA ~ U(0.2, 0.4), every 8th instance infeasible, and one equality row
    W x = r (W ~ U(0.5, 1.5)) consistent with instance 1's band; returns
    (H, U, W, r, bad)."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    pA = rng.uniform(0.2, 0.4, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[::8] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    W = rng.uniform(0.5, 1.5, n)
    m1 = (pA[1] + qA[1]) / 2.0
    xf = m1 * I_A / 3 + (1 - m1) * (1 - I_A) / (n - 3)
    return (np.stack([-I_A, I_A]), np.stack([-pA, qA], axis=1), W[None, :],
            np.array([W @ xf]), bad)


class PNorm:
    """f(x) = sum_j |x_j|^p with its diagonal Hessian in closed form (the
    zoo's TestMinPNorm objective, tests/test_problems_zoo.py:41-54, with
    the hess_diag that BR_fast needs)."""

    def __init__(self, p):
        self.p = p

    def value(self, x):
        return torch.sum(torch.abs(x) ** self.p, dim=-1)

    def grad(self, x):
        return self.p * torch.abs(x) ** (self.p - 1) * torch.sign(x)

    def hess_diag(self, x):
        return self.p * (self.p - 1) * torch.abs(x) ** (self.p - 2)

    def hess(self, x):
        return torch.diag_embed(self.hess_diag(x))


def check_none(kernels, what, sync):
    """Read the launch counters after a route that must launch none of
    the kernels."""
    sync()
    launches = kernel_counts(*kernels)
    check(all(v == 0 for v in launches.values()),
          f"{what} launched none of the kernels {launches}")


def fleet_routes(dev, kernels, B_screen=10000, qp_shapes=((128, 64, 4, 512),
                                                    (1000, 500, 10, 100)),
           B_diag=1000, sync=torch.cuda.synchronize):
    """Phase 4c: the fleet screen, the QP family, resume, minimize and the
    exact-f32 guard through the entry points, each route with the launch
    counters set to 0 just before it and read just after.  Returns phase
    6's calls of the screen and the first QP fleet."""
    import tempfile

    from cvx_tpu_torch import QP, DiagQP, DistKL, LP, SolverParams, minimize
    from cvx_tpu_torch import problem as pb
    from cvx_tpu_torch.checkpoint import (load_pytree, resume_barrier,
                                          save_pytree)
    from cvx_tpu_torch.models import qp_certify
    from cvx_tpu_torch.models.qp import _certified_solution
    from cvx_tpu_torch.solvers.structured import record_stages
    from cvx_tpu_torch.solvers import barrier_solve

    print("phase 4c: the fleet screen, the QP family, resume, minimize")
    rows = []
    n = 100
    # 1. the fleet screen, f32 and f64
    H, U, bad = screen_family(B_screen, n)
    f64 = dict(dtype=torch.float64, device=dev)
    judge = DistKL.create(n, H=torch.tensor(H, **f64), u=torch.zeros(2, **f64))
    s_max, strict = judge.feasibility_batch(
        torch.tensor(U[:256], **f64), SolverParams(tol=1e-6, max_iter=60))
    phase1_inf = (s_max > 0).cpu().numpy()
    phase1_strict = strict.cpu().numpy()
    for dtype, tol in ((torch.float32, SCREEN_F32), (torch.float64,
                                                      SCREEN_F64)):
        opts = dict(dtype=dtype, device=dev)
        prob = DistKL.create(n, H=torch.tensor(H, **opts),
                             u=torch.zeros(2, **opts))
        Ut = torch.tensor(U, **opts)
        prob.feasibility_screen_batch(Ut[:64])       # warm-up
        sync()
        zero_counts(*kernels)
        t0 = time.perf_counter()
        scr = prob.feasibility_screen_batch(Ut)
        sync()
        wall = time.perf_counter() - t0
        check_none(kernels, f"the screen ({dtype})", sync)
        x = scr.x.double().cpu().numpy()
        w = scr.w.double().cpu().numpy()
        slb = scr.s_lower.double().cpu().numpy()
        sub = scr.s_upper.double().cpu().numpy()
        und = int(scr.undecided.sum())
        width = float(np.max(sub - slb))
        print(f"  screen {dtype} {B_screen} x n={n}: {wall:.4f} s; "
              f"undecided {und}; widest interval {width:.3e}")
        check(np.array_equal(scr.infeasible.cpu().numpy(), bad) and und == 0,
              f"screen {dtype}: infeasible exactly the constructed "
              f"{int(bad.sum())} lanes, 0 undecided")
        check(bool(np.all(slb <= sub)) and bool(np.all(x > 0))
              and float(np.max(np.abs(x.sum(1) - 1.0))) <= tol,
              f"screen {dtype}: s_lower <= s_upper, x > 0, |sum x - 1| <= "
              f"{tol:g}")
        sub_host = np.max(x @ H.T - U, axis=1)
        slb_host = np.min(w @ H, axis=1) - np.sum(w * U, axis=1)
        d_up = float(np.max(np.abs(sub_host - sub)))
        d_lo = float(np.max(np.abs(slb_host - slb)))
        check(d_up <= tol and d_lo <= tol,
              f"screen {dtype}: s_upper from x and s_lower from w, "
              f"recomputed in f64 on the host, within {tol:g} "
              f"({d_up:.2e}, {d_lo:.2e})")
        # the sign against the generic phase-I (f64, the screening
        # tolerances of tests/test_round5.py:443) where the screen decided
        dec = ~scr.undecided[:256].cpu().numpy()
        check(np.array_equal(phase1_inf[dec],
                             scr.infeasible[:256].cpu().numpy()[dec])
              and np.array_equal(phase1_strict[dec],
                                 scr.strictly_feasible[:256].cpu().numpy()
                                 [dec]),
              f"screen {dtype}: the sign of s agrees with feasibility_batch "
              f"on 256 instances")
        if dtype == torch.float32:
            # the fixed schedule: 6 stages of 4 Newton and 16 polish steps
            rows.append((f"screen f32 {B_screen} x n={n}",
                         lambda p=prob, u=Ut: p.feasibility_screen_batch(u),
                         6 * (4 + 16)))
    # the eq-fold family: one equality row folded in as a +/- pair
    He, Ue, We, re_, bad_e = eq_fold_family(B_screen, n)
    prob = DistKL.create(n, H=torch.tensor(He, **f64),
                         u=torch.zeros(2, **f64), A=torch.tensor(We, **f64),
                         r=torch.tensor(re_, **f64))
    sync()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    scr = prob.feasibility_screen_batch(torch.tensor(Ue, **f64))
    sync()
    wall = time.perf_counter() - t0
    check_none(kernels, "the eq-fold screen", sync)
    inf = scr.infeasible.cpu().numpy()
    feas = scr.strictly_feasible.cpu().numpy()
    xf = scr.x.cpu().numpy()[feas]
    eq_err = float(np.abs(xf @ We[0] - re_[0]).max()) if feas.any() else 0.0
    print(f"  eq-fold screen f64 {B_screen} x n={n}: {wall:.4f} s; "
          f"undecided {int(scr.undecided.sum())}; strictly feasible "
          f"{int(feas.sum())}; max |W x - r| {eq_err:.2e}")
    check(bool(inf[bad_e].all()) and int(inf[~bad_e].sum()) == 0
          and feas.any() and eq_err < 1e-4
          and bool(((xf @ He.T) - Ue[feas] < 0).all()),
          "eq-fold screen: every infeasible lane certified, no false flag, "
          "feasible points meet W x = r within eq_tol 1e-4 and H x < u")

    # 2. the QP fleet: f32 barrier + the certified f64 finish
    pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol", kkt_refine=1,
                        max_iter=40)
    certified = {}
    for qn, qm, qp_, qB in qp_shapes:
        data = qp_fleet_data(qn, qm, qp_, qB, seed=qn)
        qp = QP.create(**data, dtype=torch.float32)
        x0 = torch.zeros(qn, dtype=torch.float32, device=dev)
        sync()
        zero_counts(*kernels)
        t0 = time.perf_counter()
        sol = qp.solve_certified(x0, pars, method="BR")
        sync()
        wall = time.perf_counter() - t0
        check_none(kernels, f"the QP fleet ({qn}, {qm}, {qp_}, {qB})", sync)
        gap = float(sol.duality_gap.abs().max())
        ineq, eq = float(sol.ineq_res.max()), float(sol.eq_gap.max())
        print(f"  QP fleet (n, m, p, B) = ({qn}, {qm}, {qp_}, {qB}): "
              f"{wall:.3f} s; Newton steps, the longest instance "
              f"{int(sol.iters.max())}; max |gap| {gap:.3e}, ineq_res "
              f"{ineq:.3e}, eq_res {eq:.3e}")
        check(gap <= CERT_GAP and ineq <= TOL_FEAS and eq <= TOL_FEAS
              and bool(torch.isfinite(sol.x).all())
              and not bool(sol.stalled.any()),
              f"QP fleet ({qn}, {qm}, {qp_}, {qB}): |gap| <= {CERT_GAP:g}, "
              f"residuals <= {TOL_FEAS:g}, x finite, 0 stalled")
        certified[(qn, qm, qp_, qB)] = (qp, sol)
    # 3. resume on the card at the first shape: stop early, save, load,
    # resume, certify
    key = qp_shapes[0]
    qp, straight = certified[key]
    # the straight-through run's own f32 barrier flags, for comparison
    straight_raw = qp.solve_jittable(torch.zeros(key[0], device=dev),
                                     "BR", pars).stalled.sum()
    x0 = torch.zeros(key[0], dtype=torch.float32, device=dev)
    sync()
    zero_counts(*kernels)
    cut = barrier_solve(qp.objective, qp.inequalities,
                        x0.expand(key[3], -1).clone(),
                        dataclasses.replace(pars, outer_max_iter=3),
                        eqs=qp.equalities)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/qp_fleet.npz"
        save_pytree(path, cut)
        loaded = load_pytree(path, cut)
    res = resume_barrier(qp.objective, qp.inequalities, loaded, pars,
                         eqs=qp.equalities)
    cert = _certified_solution(
        qp_certify(qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, res.x, res.lam,
                   res.nu), res, pars)
    check_none(kernels, "the resume", sync)
    dx = float((cert.x - straight.x).abs().max())
    gap = float(cert.duality_gap.abs().max())
    ineq, eq = float(cert.ineq_res.max()), float(cert.eq_gap.max())
    print(f"  resume {key}: checkpoint gap max "
          f"{float(cut.duality_gap.max()):.3e}; resumed and certified max "
          f"|gap| {gap:.3e}, ineq_res {ineq:.3e}, eq_res {eq:.3e}; max |dx| "
          f"against straight through {dx:.3e}; f32 barrier stall flags "
          f"{int(res.stalled.sum())} resumed, {int(straight_raw)} straight "
          f"through; certified stalled {int(cert.stalled.sum())}")
    check(gap <= CERT_GAP and ineq <= TOL_FEAS and eq <= TOL_FEAS
          and dx <= RESUME_DX and bool(torch.isfinite(cert.x).all())
          and not bool(cert.stalled.any()),
          f"resume: the contract held (|gap| <= {CERT_GAP:g}, residuals <= "
          f"{TOL_FEAS:g}, x finite, 0 stalled) and x within {RESUME_DX:g} of "
          "the straight-through run")
    rows.append((f"QP fleet {key} solve_certified",
                 lambda q=qp, z=x0: q.solve_certified(z, pars, method="BR"),
                 int(straight.iters.max())))

    # 4. minimize (the zoo's min p-norm on the simplex), DiagQP, LP
    nz = 8
    cnts = pb.ConstraintSet(blocks=(pb.positivity(nz),))
    x_star = torch.full((nz,), 1.0 / nz, dtype=torch.float64)
    for method in ("BR", "PD", "BR_fast"):
        sync()
        zero_counts(*kernels)
        sol = minimize(PNorm(2.2), cnts, pb.sum_to_one(nz),
                       x0=torch.zeros(nz, dtype=torch.float64),
                       method=method)
        check_none(kernels, f"minimize({method!r})", sync)
        dx = float((sol.x.cpu() - x_star).abs().max())
        check(sol.x.device.type == torch.device(dev).type and dx <= 1e-6
              and not bool(sol.stalled),
              f"minimize(method={method!r}) on the card: x* = 1/n within "
              f"1e-6 ({dx:.2e}), not stalled")
    rng = np.random.default_rng(11)
    k = 4
    c, ad, Ud, ubd, x_ref = diagqp_data(B_diag, n, k, rng=rng)
    dq = DiagQP.create(c, ad, Ud, ubd, np.ones((1, n)), np.ones(1))
    sync()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    with record_stages() as stages:
        dsol = dq.solve_certified(torch.tensor(x_ref, device=dev),
                                  SolverParams(tol=1e-9, kkt_method="chol"))
    sync()
    wall = time.perf_counter() - t0
    check_none(kernels, "DiagQP.solve_certified", sync)
    gap = float(dsol.duality_gap.abs().max())
    # the masked loop runs each stage as long as its slowest instance: an
    # instance whose last stage accepts null steps at a rounding floor
    # takes max_iter there, as in the reference (ROADMAP Queue 3)
    print(f"  DiagQP solve_certified {B_diag} x n={n}, k={k}: {wall:.3f} s; "
          f"max |gap| {gap:.3e}; masked-loop steps {sum(stages[0])}, the "
          f"largest stage {max(stages[0])} (by stage {stages[0]}), the "
          f"longest instance {int(dsol.iters.max())}")
    check(gap <= CERT_GAP and not bool(dsol.stalled.any()),
          f"DiagQP batch: |gap| <= {CERT_GAP:g}, 0 stalled")
    # the LP family of tests/test_qp_model.py::TestLP::
    # test_lp_with_dense_row, batched: a = linspace(2, 1) + 1e-3 N(0, 1), the
    # last coordinate capped at ub ~ U(0.2, 0.4) (the cap is active).  At
    # tol 1e-7, as random costs on this route stall in the reference too
    # (27 of 1,000 instances with four random rows on the CPU, the same 27
    # in the port)
    a_lp = np.linspace(2.0, 1.0, n)[None] + 1e-3 * rng.standard_normal(
        (B_diag, n))
    cap = np.zeros((1, n)); cap[0, n - 1] = 1.0
    ub_lp = rng.uniform(0.2, 0.4, (B_diag, 1))
    lp = LP(a_lp, U=cap, ub=ub_lp, A=np.ones((1, n)), b=np.ones(1))
    sync()
    zero_counts(*kernels)
    lsol = lp.solve_jittable(torch.tensor(x_ref, device=dev),
                             SolverParams(tol=1e-7))
    check_none(kernels, "LP.solve_jittable", sync)
    dcap = float(np.abs(lsol.x[:, -1].cpu().numpy() - ub_lp[:, 0]).max())
    check(bool(torch.isfinite(lsol.x).all()) and not bool(lsol.stalled.any())
          and dcap < 1e-3,
          f"LP batch {B_diag} x n={n} at tol 1e-7: x finite, 0 stalled, the "
          f"cap active within 1e-3 ({dcap:.2e})")

    # 5. the exact-f32 guard: a caller's TF32 settings do not reach the
    # solver, and come back after
    seen = []

    def fn(params, x):
        seen.append(torch.get_float32_matmul_precision())
        return 0.5 * torch.sum(x * x)

    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        barrier_solve(pb.CustomObjective(fn=fn),
                      pb.ConstraintSet(blocks=(pb.half_norm2_bounded(
                          4, 2.0, dtype=torch.float32, device=dev),)),
                      torch.full((2, 4), 0.1, device=dev),
                      SolverParams(tol=1e-4))
        back = (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    check(bool(seen) and set(seen) == {"highest"} and back == ("high", True),
          "exact-f32 guard: 'highest' inside barrier_solve with the caller "
          "at 'high' and TF32 on; the caller's settings back after")
    return rows


def ruiz_card(dev, B=64, n=100):
    """Phase 4e: ``ops.ruiz_equilibrate0`` and ``apply_equilibration`` on a
    batch of f64 SPD matrices (condition ~1e3) on the card, held to the
    same calls on the CPU."""
    from cvx_tpu_torch.ops import apply_equilibration, ruiz_equilibrate0

    X = spd_batch(B, n, torch.float64, dev, seed=11)
    b = torch.randn(B, n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(12))
    d, Q = ruiz_equilibrate0(X)
    db = apply_equilibration(d, b.to(dev))
    d_c, Q_c = ruiz_equilibrate0(X.cpu())
    db_c = apply_equilibration(d_c, b)
    err = max(float((u.cpu() - v).abs().max() / v.abs().max())
              for u, v in ((d, d_c), (Q, Q_c), (db, db_c)))
    check(d.device.type == "cuda" and err <= RUIZ_REL,
          f"phase 4e: ruiz_equilibrate0 + apply_equilibration on the card, "
          f"{B} x {n} f64: max rel diff {err:.3e} <= {RUIZ_REL:g} against "
          "the CPU")


def msharded_data(m, n, seed=0):
    """``tests/test_constraint_shard.py:23-33``'s problem from a numpy
    seed: min 0.5 ||x - z||^2 s.t. G x <= ub, x0 = 0 strictly feasible, z
    pulled outside so a handful of rows are active at the optimum."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n)) / np.sqrt(n)
    ub = rng.uniform(0.5, 1.5, m)
    z = 2.0 * rng.standard_normal(n) / np.sqrt(n) + 0.4
    return G, ub, z


def spd_f64(n, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    M = torch.randn(n, n, generator=g, dtype=torch.float64) / math.sqrt(n)
    return (M @ M.T + 2.0 * torch.eye(n, dtype=torch.float64)).to(dev)


def _sep_problem(dev, dtype=torch.float32):
    from cvx_tpu_torch.parallel import SeparableProblem

    return SeparableProblem(*(torch.tensor(v, dtype=dtype, device=dev)
                              for v in separable_data()))


def gloo_rank(rank, size, H, U, device):
    """Phase 4d (e): one of ``size`` gloo ranks on cuda:0 runs (a) and (b)
    sharded over the ranks; rank 0 returns the whole results."""
    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.parallel import (block_mesh, instance_mesh,
                                        separable_barrier_solve,
                                        make_sharded_schur_solver,
                                        shard_solve)
    from cvx_tpu_torch.parallel.schur import make_sharded_separable_certify
    from cvx_tpu_torch.solvers import SolverParams

    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    prob = DistKL.create(H.shape[1], H=torch.tensor(H, **f32),
                         u=torch.zeros(2, **f32), device=dev)
    sol = shard_solve(prob.solve_certified_batch, instance_mesh(device=dev))(
        torch.tensor(U, **f32))
    sp = _sep_problem(dev)
    mesh = block_mesh(device=dev)
    pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
    s = separable_barrier_solve(sp, torch.zeros(sp.K, sp.nb, **f32), pars,
                                kkt_solver=make_sharded_schur_solver(mesh))
    cert = make_sharded_separable_certify(mesh)(sp, s.x, s.lam, s.nu)
    out = {k: v.cpu().numpy() for k, v in (("x", sol.x), ("lam", sol.lam),
                                   ("nu", sol.nu), ("gap", sol.duality_gap),
                                   ("ineq", sol.ineq_res),
                                   ("eq", sol.eq_gap), ("sep_x", cert.x),
                                   ("sep_gap", cert.gap))}
    return out if rank == 0 else None


def parallel_routes(dev, kernels, smi, H, U, n_gloo=4, m_shape=(4096, 128),
                    tp_sizes=(4096, 8192), sync=torch.cuda.synchronize):
    """Phase 4d: the parallel layer on a one-rank NCCL group at full width,
    each route with the launch counters set to 0 just before it and read
    just after, then ``n_gloo`` gloo ranks on cuda:0.  Returns phase 6's
    records of the sharded dp route and config 5, measured while the group
    is up."""
    import torch.distributed as dist

    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.parallel import (barrier_solve_msharded, block_mesh,
                                        init_distributed, instance_mesh,
                                        make_sharded_cholesky,
                                        make_sharded_schur_solver,
                                        primal_dual_solve_msharded,
                                        separable_barrier_solve,
                                        shard_solve)
    from cvx_tpu_torch.parallel.mesh import free_port, spawn_ranks
    from cvx_tpu_torch.parallel.schur import (make_sharded_separable_certify,
                                              separable_certify)
    from cvx_tpu_torch.problem.constraint_set import ConstraintSet
    from cvx_tpu_torch.problem.constraints import LinearBlock
    from cvx_tpu_torch.problem.objective import QuadraticObjective
    from cvx_tpu_torch.solvers import barrier_solve, primal_dual_solve

    print("phase 4d: the parallel layer (a one-rank NCCL group, then "
          f"{n_gloo} gloo ranks on cuda:0)")
    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    check(dist.get_backend() == "nccl", "phase 4d's group is NCCL")
    rows = []

    def wall(fn, reps=3):
        fn()
        sync()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls), out

    def busy(rows, label, fn, reps, steps):
        # phase 6's measure, taken here while the group is up
        w, b, ops = device_busy(fn, reps, warm=steps is None,
                                raw=steps is not None)
        rows.append({"path": label, "host_wall_ms": w,
                     "host_wall_of": "separate timed calls",
                     "device_busy_ms": b,
                     "device_ops": ops, "calls": reps,
                     "newton_steps_longest": steps, "card": smi})

    def record(label, ms, **extra):
        print(json.dumps({"path": label, "host_wall_ms": ms, **extra,
                          "card": smi}))

    # (a) dp, the flagship route: K2 on each rank's shard
    f32 = dict(dtype=torch.float32, device=dev)
    prob = DistKL.create(H.shape[1], H=torch.tensor(H, **f32),
                         u=torch.zeros(2, **f32), device=dev)
    Ut = torch.tensor(U, **f32)
    mesh = instance_mesh(device=dev)
    dp = shard_solve(prob.solve_certified_batch, mesh)
    local = prob.solve_certified_batch(Ut)
    sync()
    zero_counts(*kernels)
    sol = dp(Ut)
    sync()
    launches = kernel_counts(*kernels)
    check(launches == {"kl_dual_fused": 0, "kl_dual_fused_cert": 1,
                       "kl_barrier_fused": 0, "cholesky_batched_cuda": 0,
                       "kl_gap_fused": 0},
          f"(a) shard_solve(solve_certified_batch) launched K2 once, "
          f"nothing else {launches}")
    same = all(torch.equal(getattr(sol, k), getattr(local, k))
               for k in ("x", "lam", "nu", "duality_gap", "ineq_res",
                         "eq_gap", "stalled"))
    gmax = float(sol.duality_gap.abs().max())
    rmax = max(float(sol.ineq_res.max()), float(sol.eq_gap.max()))
    check(same and gmax <= CERT_GAP and rmax <= TOL_FEAS
          and not bool(sol.stalled.any()),
          f"(a) dp K2 {tuple(Ut.shape)}: the same bits as the local call, "
          f"max|gap| {gmax:.3e} <= {CERT_GAP:g}, residuals {rmax:.3e} <= "
          "tol_feas")
    ms, _ = wall(lambda: dp(Ut), reps=10)
    ms_local, _ = wall(lambda: prob.solve_certified_batch(Ut), reps=10)
    record("(a) dp shard_solve(solve_certified_batch), 1 NCCL rank", ms,
           local_ms=ms_local)
    busy(rows, "4d (a) dp K2, 1 NCCL rank", lambda: dp(Ut), 10, None)

    # (b) config 5 through the Schur consensus and its certificate
    sp = _sep_problem(dev)
    x0 = torch.zeros(sp.K, sp.nb, **f32)
    pars5 = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
    bmesh = block_mesh(device=dev)
    solver = make_sharded_schur_solver(bmesh)
    certify = make_sharded_separable_certify(bmesh)

    def config5_local():
        s = separable_barrier_solve(sp, x0, pars5)
        return s, separable_certify(sp, s.x, s.lam, s.nu)

    def config5_sharded():
        s = separable_barrier_solve(sp, x0, pars5, kkt_solver=solver)
        return s, certify(sp, s.x, s.lam, s.nu)

    zero_counts(*kernels)
    ms_l, (s_l, c_l) = wall(config5_local, reps=1)
    ms_s, (s_s, c_s) = wall(config5_sharded, reps=1)
    check_none(kernels, "(b) config 5", sync)
    for label, s, c in (("local", s_l, c_l), ("sharded", s_s, c_s)):
        print(f"  (b) config 5 {label}: {int(s.iters)} Newton steps, "
              f"gap {float(c.gap):.3e}, ineq_res {float(c.ineq_res):.3e}, "
              f"coupling {float(c.eq_res):.3e}")
        check(abs(float(c.gap)) <= CERT_GAP
              and float(c.ineq_res) <= TOL_FEAS
              and float(c.eq_res) <= TOL_FEAS,
              f"(b) config 5 {label}: measured |gap| <= {CERT_GAP:g}, "
              "ineq_res and coupling error <= tol_feas")
    dxs = float((c_s.x - c_l.x).abs().max())
    dgap = abs(float(c_s.gap) - float(c_l.gap))
    check(dxs <= SCHUR_DX and dgap <= SCHUR_DX,
          f"(b) config 5 sharded within {SCHUR_DX:g} of local: max|dx| "
          f"{dxs:.3e}, |dgap| {dgap:.3e}")
    record("(b) config 5 separable_barrier_solve + certify, local", ms_l,
           newton_steps=int(s_l.iters))
    record("(b) config 5 sharded Schur + certify, 1 NCCL rank", ms_s,
           newton_steps=int(s_s.iters))
    busy(rows, "4d (b) config 5 sharded + certify, 1 NCCL rank",
         config5_sharded, 1, int(s_s.iters))

    # (c) the m-sharded barrier and primal-dual, m = 4096, n = 128, f64
    m, n = m_shape
    G, ub, z = msharded_data(m, n)
    f64 = dict(dtype=torch.float64, device=dev)
    Gt, ubt, zt = (torch.tensor(v, **f64) for v in (G, ub, z))
    obj = QuadraticObjective(P=torch.eye(n, **f64), a=-zt,
                             r=0.5 * (zt @ zt))
    c0, x0m = torch.zeros(m, **f64), torch.zeros(n, **f64)
    cnts = ConstraintSet(blocks=(LinearBlock(G=Gt, c=c0, ub=ubt),))
    mmesh = instance_mesh(axis="m", device=dev)
    for label, sharded, plain in (
            ("barrier", lambda: barrier_solve_msharded(
                obj, Gt, c0, ubt, x0m, SolverParams(tol=1e-9, mu=20.0),
                mesh=mmesh),
             lambda: barrier_solve(obj, cnts, x0m[None],
                                   SolverParams(tol=1e-9, mu=20.0))),
            ("primal-dual", lambda: primal_dual_solve_msharded(
                obj, cnts, x0m, SolverParams(tol=1e-8), mesh=mmesh),
             lambda: primal_dual_solve(obj, cnts, x0m[None],
                                       SolverParams(tol=1e-8)))):
        zero_counts(*kernels)
        ms_s, sol_s = wall(sharded, reps=1)
        ms_l, sol_l = wall(plain, reps=1)
        check_none(kernels, f"(c) m-sharded {label}", sync)
        dx = float((sol_s.x - sol_l.x[0]).abs().max())
        check(dx < MSHARD_DX and not bool(sol_s.stalled),
              f"(c) m-sharded {label} m={m} n={n}: max|dx| {dx:.3e} < "
              f"{MSHARD_DX:g} against the local solver, not stalled")
        record(f"(c) m-sharded {label}, 1 NCCL rank", ms_s, local_ms=ms_l,
               newton_steps=int(sol_s.iters),
               local_newton_steps=int(sol_l.iters.max()))

    # (d) tp_chol: the row-sharded Cholesky on one rank
    for n_tp in tp_sizes:
        Hs = spd_f64(n_tp, n_tp, dev)
        chol = make_sharded_cholesky(instance_mesh(axis="tp", device=dev),
                                     n_tp, block=128)
        zero_counts(*kernels)
        ms_tp, L = wall(lambda: chol(Hs), reps=3)
        ms_lib, Lref = wall(lambda: torch.linalg.cholesky(Hs), reps=3)
        check_none(kernels, f"(d) tp_chol n={n_tp}", sync)
        rel = float((L - Lref).abs().max() / Lref.abs().max())
        check(rel <= TP_CHOL_REL,
              f"(d) tp_chol n={n_tp} block 128 f64: max|dL|/max|L| "
              f"{rel:.3e} <= {TP_CHOL_REL:g}")
        record(f"(d) tp_chol n={n_tp} block 128 f64, 1 NCCL rank", ms_tp,
               torch_linalg_cholesky_ms=ms_lib, overhead=ms_tp / ms_lib)
        del Hs, L, Lref
    dist.destroy_process_group()

    # (e) n_gloo gloo ranks on the one card, against (a) and (b)
    t0 = time.perf_counter()
    got = spawn_ranks(gloo_rank, n_gloo, H, U, str(dev),
                      init_method=f"tcp://localhost:{free_port()}",
                      backend="gloo", device=dev, timeout=300)[0]
    same = all(np.array_equal(got[k], getattr(local, f).cpu().numpy())
               for k, f in (("x", "x"), ("lam", "lam"), ("nu", "nu"),
                            ("gap", "duality_gap"), ("ineq", "ineq_res"),
                            ("eq", "eq_gap")))
    check(same, f"(e) {n_gloo} gloo ranks on cuda:0, "
          f"{U.shape[0] // n_gloo} instances a rank: the same bits as (a)")
    dxs = float(np.abs(got["sep_x"] - c_l.x.cpu().numpy()).max())
    dgap = abs(float(got["sep_gap"]) - float(c_l.gap))
    check(dxs <= SCHUR_DX and dgap <= SCHUR_DX,
          f"(e) config 5 on {n_gloo} gloo ranks, {sp.K // n_gloo} blocks a "
          f"rank: within {SCHUR_DX:g} of (b): max|dx| {dxs:.3e}, |dgap| "
          f"{dgap:.3e}")
    record(f"(e) {n_gloo} gloo ranks on cuda:0, (a) and (b), spawn "
           "included", (time.perf_counter() - t0) * 1e3)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.ops import _build
    from cvx_tpu_torch.ops.chol import (cholesky_batched,
                                        cholesky_batched_cuda,
                                        cholesky_batched_plain)
    from cvx_tpu_torch.ops.kl_barrier import (kl_barrier_fused,
                                              kl_barrier_fused_plain)
    from cvx_tpu_torch.ops.kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                                           kl_dual_fused_cert_plain,
                                           kl_dual_fused_plain, path_of)
    from cvx_tpu_torch.ops.kl_gap import kl_gap_fused, kl_gap_fused_plain
    kernels = (kl_dual_fused, kl_dual_fused_cert, kl_barrier_fused,
               cholesky_batched_cuda, kl_gap_fused)

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
    print(f"nvidia-smi name, power.limit: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build: one nvcc per unit (kl_dual.cu's three entries, kl_barrier.cu,
    # chol.cu, kl_gap.cu), all started together
    t0 = time.perf_counter()
    libs = _build.build_all()
    for unit in _build.UNITS:
        _build.load(unit)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{[p.name for p in libs]}")

    # 3. kernel vs plain on the card
    print("phase 3: kernels against their plain versions")
    k1_err = k2_err = 0.0
    for cname, Hs, U, A, R in dual_cases(dev):
        B_c, k_c, n_c = Hs.shape
        m_c = 0 if A is None else A.shape[1]
        print(f"  {cname}: K1 / K2 path "
              f"{path_of(k_c + 1 + m_c, k_c, m_c, n_c, B_c, torch.float32)}")
        got = kl_dual_fused(Hs, U, A, R)
        ref = kl_dual_fused_plain(Hs, U, A, R)
        torch.cuda.synchronize()
        err = compare_k1(cname, got, ref, K1_TOL, K1_DZ)
        if cname.startswith("bench"):
            k1_err = err
        got2 = kl_dual_fused_cert(Hs, U, A, R)
        ref2 = kl_dual_fused_cert_plain(Hs, U, A, R)
        torch.cuda.synchronize()
        err = compare_k2(cname, got2, ref2)
        if cname.startswith("bench"):
            k2_err = err
    H, U = bench_family(37, 77, seed=2)
    H64 = torch.tensor(H, dtype=torch.float64, device=dev)[None].expand(
        37, -1, -1)
    U64 = torch.tensor(U, dtype=torch.float64, device=dev)
    compare_k1("f64 ragged B=37 n=77", kl_dual_fused(H64, U64),
               kl_dual_fused_plain(H64, U64), K1_F64_TOL, K1_F64_DZ)
    # f64 on the group path: the ladder's batch (16 warps an instance) and
    # dual dim 16 (one-warp groups); the ragged batch above keeps the warp
    # loop (kl_dual.path_of)
    H, U = bench_family(100, 10000, seed=0)
    H16, U16, _, _ = random_family(15, 0, 100, 256)
    for cname, Hn, Un in (("f64 ladder B=100 n=10000", H, U),
                          ("f64 family k=15 n=100 (dim 16)", H16, U16)):
        k_c, n_c = Hn.shape
        print(f"  {cname}: K1 path "
              f"{path_of(k_c + 1, k_c, 0, n_c, len(Un), torch.float64)}")
        H64 = torch.tensor(Hn, dtype=torch.float64, device=dev)[None].expand(
            len(Un), -1, -1)
        U64 = torch.tensor(Un, dtype=torch.float64, device=dev)
        compare_k1(cname, kl_dual_fused(H64, U64),
                   kl_dual_fused_plain(H64, U64), K1_F64_TOL, K1_F64_DZ)
    pars = SolverParams(**PRODUCTION)
    H, U = bench_family(10000, 100, seed=0)
    prob = DistKL.create(100, H=H.astype(np.float32),
                         u=np.zeros(2, np.float32))
    k3_err = 0.0
    for cname, dtype, args, ls in primal_cases(dev):
        err, xk = compare_k3(cname, dtype, args, ls, kl_barrier_fused,
                             kl_barrier_fused_plain,
                             prob if cname.endswith("k=2") else None, pars)
        if cname.endswith("k=2"):
            k3_err = err
        if cname.startswith("x0 on a bound"):
            check(torch.equal(xk[2], args[4][2])
                  and bool(torch.isfinite(xk).all()),
                  "K3: the no-step guard holds lane 2 at x0, every x finite")
    for cname, X in k4_cases(dev):
        compare_k4(cname, X, cholesky_batched_cuda, cholesky_batched_plain)
    # the gap kernel: K3's x of the bench case (the primal route's inputs),
    # then dual dim 8 with equality rows and a prior (f64, n = 300, the
    # streamed path) and dual dim 5 (f32, n = 1,000)
    kargs3 = primal_args(H, U, feasible_points(U, 100), dev)
    kw3 = dict(mu=PRODUCTION["mu"], n_inner=PRODUCTION["max_iter"])
    x_primal = kl_barrier_fused(*kargs3, **kw3)
    gap_err = compare_gap("bench 10000 x n=100 (dim 3)",
                          gap_args(H, U, x_primal), kl_gap_fused,
                          kl_gap_fused_plain)
    for cname, (k_c, m_c, n_c, B_c), dtype, prior in (
            ("k=5 m_eq=2 n=300 prior (dim 8)", (5, 2, 300, 301),
             torch.float64, True),
            ("k=4 n=1000 (dim 5)", (4, 0, 1000, 300), torch.float32, False)):
        Hr, Ur, Ar, Rr = random_family(k_c, m_c, n_c, B_c, seed=k_c)
        opts = dict(dtype=dtype, device=dev)
        # distributions 5 % off the uniform point: a far start
        x_c = 1.0 + 0.05 * torch.randn((B_c, n_c), generator=torch.Generator(
            ).manual_seed(k_c), dtype=torch.float64).abs()
        x_c = (x_c / x_c.sum(dim=1, keepdim=True)).to(**opts)
        Ae = torch.cat([torch.ones((1, n_c), **opts),
                        torch.tensor(Ar, **opts)]) if m_c else \
            torch.ones((1, n_c), **opts)
        be = torch.cat([torch.ones((B_c, 1), **opts),
                        torch.tensor(Rr, **opts)], dim=1) if m_c else \
            torch.ones((B_c, 1), **opts)
        pr = (torch.linspace(0.5, 1.5, n_c, **opts) / n_c) if prior else None
        compare_gap(cname, (torch.tensor(Hr, **opts),
                            torch.tensor(Ur, **opts), Ae, be, x_c),
                    kl_gap_fused, kl_gap_fused_plain, prior=pr)
    check(all(k.launches > 0 for k in kernels),
          f"launch counters {kernel_counts(*kernels)}")

    # 4. the paths, through the user entry points, each with the counters
    # set to 0 just before it and read just after
    print("phase 4: the paths (10,000 instances, n = 100)")
    f32 = dict(dtype=torch.float32, device=dev)
    Ht, Ut = torch.tensor(H, **f32), torch.tensor(U, **f32)
    Hb = Ht[None].expand(10000, -1, -1)
    x32, _, _ = kl_dual_fused(Hb, Ut)    # bench.py's f32 x, judged below
    prob_d = DistKL.create(100, H=Ht, u=torch.zeros(2, **f32))
    prob_one = DistKL.create(100, H=Ht, u=Ut[0])
    torch.cuda.synchronize()

    zero_counts(*kernels)
    t0 = time.perf_counter()
    sol = prob_d.solve_certified_batch(Ut)                      # K2
    sol_k1 = prob_d.solve_certified_batch(Ut, fused_cert=False)  # K1 + f64
    one = prob_one.solve(method="dual_fused")                   # K1
    torch.cuda.synchronize()
    dual_s = time.perf_counter() - t0
    launches = kernel_counts(*kernels)
    print(f"  dual path wall {dual_s:.3f} s (first calls); launches "
          f"{launches}")
    check(launches == {"kl_dual_fused": 2, "kl_dual_fused_cert": 1,
                       "kl_barrier_fused": 0, "cholesky_batched_cuda": 0,
                       "kl_gap_fused": 0},
          "the dual path launched K1 twice (fused_cert=False, solve) and "
          "K2 once (auto)")
    main_launches = dict(launches)
    for label, s in (("auto (K2)", sol), ("fused_cert=False (K1+f64)",
                                          sol_k1)):
        gmax = float(s.duality_gap.abs().max())
        imax, emax = float(s.ineq_res.max()), float(s.eq_gap.max())
        nst = int(s.stalled.sum())
        print(f"  {label}: max|gap| {gmax:.3e}, max ineq_res {imax:.3e}, "
              f"max eq_res {emax:.3e}, stalled {nst}")
        check(tuple(s.x.shape) == (10000, 100)
              and bool(torch.isfinite(s.x).all()),
              f"{label}: x finite, shape (10000, 100)")
        check(gmax <= CERT_GAP and imax <= 1e-7 and emax <= 1e-7
              and nst == 0,
              f"{label}: max|gap| <= {CERT_GAP:g}, residuals <= tol_feas, "
              "nothing stalled")
    dx_routes = float((sol.x - sol_k1.x).abs().max())
    dz_routes = max(float(((a - b) / (1.0 + b.abs())).abs().max())
                    for a, b in ((sol.lam, sol_k1.lam), (sol.nu, sol_k1.nu)))
    dres_routes = max(float((sol.ineq_res - sol_k1.ineq_res).abs().max()),
                      float((sol.eq_gap - sol_k1.eq_gap).abs().max()))
    check(dx_routes <= K2_DX and dz_routes <= K2_DZ
          and dres_routes <= K2_DRES
          and torch.equal(sol.stalled, sol_k1.stalled),
          f"the two certified routes agree: max|dx| {dx_routes:.3e}, "
          f"lam/nu max|dz|/(1+|z|) {dz_routes:.3e}, residuals "
          f"{dres_routes:.3e}, identical stalled flags")
    check(not bool(one.stalled) and abs(float(one.duality_gap)) <= K1_TOL,
          f"solve(method='dual_fused'): gap {float(one.duality_gap):.3e}")
    cert32 = kl_gap_certificate_np(x32.cpu().numpy(), H, U)
    print(f"  kl_gap_certificate_np on K1's f32 x: max {cert32.max():.3e}, "
          f"median {np.median(cert32):.3e}")
    check(float(cert32.max()) <= K1_TOL,
          f"host f64 certificate of K1's f32 x <= {K1_TOL:g}")
    # the certified contract does not depend on n (the reference's
    # tests/test_round4.py::TestCertifiedShapeIndependent); after the
    # counted run, so these launches are not the main path's
    for n_big, B_big in ((1000, 4), (10000, 2)):
        Hn, _ = bench_family(B_big, n_big, seed=0)
        Un = np.column_stack([-np.linspace(0.25, 0.45, B_big),
                              np.linspace(0.6, 0.75, B_big)])
        prob_n = DistKL.create(n_big, H=torch.tensor(Hn, **f32),
                               u=torch.zeros(2, **f32))
        s = prob_n.solve_certified_batch(torch.tensor(Un, **f32))
        gmax = float(s.duality_gap.abs().max())
        imax, emax = float(s.ineq_res.max()), float(s.eq_gap.max())
        check(tuple(s.x.shape) == (B_big, n_big) and gmax <= CERT_GAP
              and imax <= 1e-7 and emax <= 1e-7
              and int(s.stalled.sum()) == 0,
              f"auto (K2) at n = {n_big}, B = {B_big}: max|gap| {gmax:.3e}"
              f" <= {CERT_GAP:g}, residuals {max(imax, emax):.3e} <= "
              "tol_feas, nothing stalled")

    # the group path (kl_dual.path_of): the same entry points on the
    # ladder's 100 x n = 10,000 (16 warps an instance) and at dual dim 16
    # (10,000 x n = 100, the random 15-row family), each with the counters
    # set to 0 just before it and read just after
    group = {}
    Hg, Ug = bench_family(100, 10000, seed=0)
    H16, U16, _, _ = random_family(15, 0, 100, 10000)
    for label, Hn, Un in (("n10000", Hg, Ug), ("dim16", H16, U16)):
        prob_g = DistKL.create(Hn.shape[1], H=torch.tensor(Hn, **f32),
                               u=torch.zeros(Hn.shape[0], **f32))
        Ugt = torch.tensor(Un, **f32)
        Hgb = prob_g.H[None].expand(len(Un), -1, -1)
        torch.cuda.synchronize()
        zero_counts(*kernels)
        sol_g = prob_g.solve_certified_batch(Ugt)                    # K2
        sol_g1 = prob_g.solve_certified_batch(Ugt, fused_cert=False)  # K1
        torch.cuda.synchronize()
        launches = kernel_counts(*kernels)
        print(f"  group path {label} ({len(Un)} x n={Hn.shape[1]}, dual "
              f"dim {Hn.shape[0] + 1}): launches {launches}")
        check(launches == {"kl_dual_fused": 1, "kl_dual_fused_cert": 1,
                           "kl_barrier_fused": 0,
                           "cholesky_batched_cuda": 0, "kl_gap_fused": 0},
              f"the group path {label} launched K2 once (auto) and K1 once "
              "(fused_cert=False)")
        main_launches[f"kl_dual_fused_group_{label}"] = launches[
            "kl_dual_fused"]
        main_launches[f"kl_dual_fused_cert_group_{label}"] = launches[
            "kl_dual_fused_cert"]
        for route, s in (("auto (K2)", sol_g), ("fused_cert=False (K1+f64)",
                                                sol_g1)):
            gmax = float(s.duality_gap.abs().max())
            rmax = max(float(s.ineq_res.max()), float(s.eq_gap.max()))
            check(tuple(s.x.shape) == tuple(Hgb.shape[::2])
                  and bool(torch.isfinite(s.x).all()) and gmax <= CERT_GAP
                  and rmax <= 1e-7 and int(s.stalled.sum()) == 0,
                  f"group path {label}, {route}: x finite, max|gap| "
                  f"{gmax:.3e} <= {CERT_GAP:g}, residuals {rmax:.3e} <= "
                  "tol_feas, nothing stalled")
        # the kernels against their plain versions on the path's inputs
        # (after the counted run)
        group[label] = dict(
            Hb=Hgb, U=Ugt, dim=Hn.shape[0] + 1,
            k1_err=compare_k1(f"group path {label}", kl_dual_fused(Hgb, Ugt),
                              kl_dual_fused_plain(Hgb, Ugt), K1_TOL, K1_DZ),
            k2_err=compare_k2(f"group path {label}",
                              kl_dual_fused_cert(Hgb, Ugt),
                              kl_dual_fused_cert_plain(Hgb, Ugt)))

    # the primal path: a model made from numpy data with no device lands
    # on the card
    X0 = feasible_points(U, 100).astype(np.float32)
    prob_p = DistKL.create(100, H=H.astype(np.float32),
                           u=np.zeros(2, np.float32))
    check(prob_p.H.device.type == "cuda",
          "DistKL.create with no device put the model on the card")
    X0t = torch.tensor(X0, **f32)
    torch.cuda.synchronize()
    zero_counts(*kernels)
    t0 = time.perf_counter()
    psol = prob_p.solve_jittable_batch(Ut, X0t, method="fused", pars=pars)
    prob_p1 = DistKL.create(100, H=H.astype(np.float32),
                            u=U[0].astype(np.float32))
    pone = prob_p1.solve_jittable(X0t[0], method="fused", pars=pars)
    torch.cuda.synchronize()
    primal_s = time.perf_counter() - t0
    launches = kernel_counts(*kernels)
    print(f"  primal path wall {primal_s:.3f} s (first calls); launches "
          f"{launches}")
    check(launches == {"kl_dual_fused": 0, "kl_dual_fused_cert": 0,
                       "kl_barrier_fused": 2, "cholesky_batched_cuda": 0,
                       "kl_gap_fused": 2},
          "the primal path launched K3 twice (solve_jittable_batch, "
          "solve_jittable) and the gap kernel twice (their certificates), "
          "nothing else")
    main_launches["kl_barrier_fused"] = launches["kl_barrier_fused"]
    main_launches["kl_gap_fused"] = launches["kl_gap_fused"]
    gmax = float(psol.duality_gap.abs().max())
    nst = int(psol.stalled.sum())
    print(f"  fused: max|gap| {gmax:.3e}, max ineq_res "
          f"{float(psol.ineq_res.max()):.3e}, max eq_gap "
          f"{float(psol.eq_gap.max()):.3e}, stalled {nst}, iters "
          f"{int(psol.iters[0])}")
    check(tuple(psol.x.shape) == (10000, 100)
          and bool(torch.isfinite(psol.x).all())
          and bool((psol.iters == 21).all()),
          "fused: x finite, shape (10000, 100), 21 Newton steps each")
    check(nst == 0 and gmax <= PRIMAL_GAP,
          f"fused: nothing stalled, max|gap| <= sqrt(eps_f32) = "
          f"{PRIMAL_GAP:.3e}")
    xp = psol.x.cpu().numpy()
    certp = kl_gap_certificate_np(xp, H, U)
    print(f"  kl_gap_certificate_np on the primal x: max {certp.max():.3e}, "
          f"median {np.median(certp):.3e}")
    check(float(certp.max()) <= PRIMAL_CERT,
          f"host f64 certificate of the primal x <= {PRIMAL_CERT:g}")
    xc = sol.x.cpu().numpy()
    f_p = np.sum(xp * np.log(100.0 * np.maximum(xp, 1e-300)), axis=1)
    f_c = np.sum(xc * np.log(100.0 * np.maximum(xc, 1e-300)), axis=1)
    dobj = float(np.abs(f_p - f_c).max())
    check(dobj <= PRIMAL_DOBJ,
          f"primal objective agrees with the certified dual slice's: "
          f"max|df| {dobj:.3e} <= {PRIMAL_DOBJ:g}")
    check(not bool(pone.stalled)
          and float((pone.x - psol.x[0]).abs().max()) == 0.0,
          f"solve_jittable(method='fused') on instance 0: gap "
          f"{float(pone.duality_gap):.3e}, x equal to the batch's")

    # the primal route on K3's group path (n > 256)
    primal_group = primal_group_routes(dev, kernels, pars, main_launches)

    # the batched Cholesky path
    Xc = spd_batch(4096, 100, torch.float32, dev, seed=7)
    torch.cuda.synchronize()
    zero_counts(*kernels)
    Lc = cholesky_batched(Xc, method="cuda")
    torch.cuda.synchronize()
    launches = kernel_counts(*kernels)
    print(f"  Cholesky path launches {launches}")
    check(launches == {"kl_dual_fused": 0, "kl_dual_fused_cert": 0,
                       "kl_barrier_fused": 0, "cholesky_batched_cuda": 1,
                       "kl_gap_fused": 0},
          "cholesky_batched(method='cuda') launched K4 once")
    main_launches["cholesky_batched_cuda"] = launches["cholesky_batched_cuda"]
    check(bool(torch.isfinite(Lc).all()) and tuple(Lc.shape) == (4096, 100,
                                                                  100),
          "cholesky_batched: L finite, shape (4096, 100, 100)")
    # the path's own factor against the plain version at the path's shape
    k4_err = compare_k4("the path's f32 B=4096 n=100", Xc,
                        cholesky_batched_cuda, cholesky_batched_plain, Lk=Lc)
    # the same entry point on the panel path (n > 192), the ladder's 256 x
    # 512
    Xp = spd_batch(256, 512, torch.float32, dev, seed=8)
    torch.cuda.synchronize()
    zero_counts(*kernels)
    Lp = cholesky_batched(Xp, method="cuda")
    torch.cuda.synchronize()
    launches = kernel_counts(*kernels)
    check(launches == {"kl_dual_fused": 0, "kl_dual_fused_cert": 0,
                       "kl_barrier_fused": 0, "cholesky_batched_cuda": 1,
                       "kl_gap_fused": 0},
          "cholesky_batched(method='cuda') at 256 x 512 (the panel path) "
          "launched K4 once")
    main_launches["cholesky_batched_cuda_panel"] = launches[
        "cholesky_batched_cuda"]
    check(bool(torch.isfinite(Lp).all()) and tuple(Lp.shape) == (256, 512,
                                                                  512),
          "cholesky_batched: L finite, shape (256, 512, 512)")
    k4p_err = compare_k4("the panel path's f32 B=256 n=512", Xp,
                         cholesky_batched_cuda, cholesky_batched_plain, Lk=Lp)
    del Xp, Lp

    # 4b. the generic core, held to the certified dual slice's x
    t0 = time.perf_counter()
    generic_routes = generic_core(dev, kernels, H, U, sol.x)
    print(f"  phase 4b wall {time.perf_counter() - t0:.1f} s")
    # 4c. the fleet screen, the QP family, resume and minimize
    t0 = time.perf_counter()
    fleet_rows = fleet_routes(dev, kernels)
    print(f"  phase 4c wall {time.perf_counter() - t0:.1f} s")

    # 4d. the parallel layer: a one-rank NCCL group, then gloo ranks
    t0 = time.perf_counter()
    parallel_rows = parallel_routes(dev, kernels, smi, H, U)
    print(f"  phase 4d wall {time.perf_counter() - t0:.1f} s")

    # 4e. the Ruiz variant, on the card against the same call on the CPU
    ruiz_card(dev)

    # 5. times (CUDA events, in turns), with each kernel's bound
    print("phase 5: times (CUDA events)")
    record = {}
    order = ("plain", "kernel", "kernel", "plain")
    for kname, kern, plain in (("kl_dual_fused", kl_dual_fused,
                                kl_dual_fused_plain),
                               ("kl_dual_fused_cert", kl_dual_fused_cert,
                                kl_dual_fused_cert_plain)):
        best, runs = in_turns({"plain": lambda: plain(Hb, Ut),
                               "kernel": lambda: kern(Hb, Ut)},
                              {"plain": 3, "kernel": 20}, order)
        record[kname] = dict(ms=best["kernel"], plain_ms=best["plain"],
                             library_ms=None)
        print(f"  {kname} 10000 x n=100: kernel {runs['kernel']} ms, plain "
              f"{runs['plain']} ms  [{smi}]")
    x, gap, z = kl_dual_fused(Hb, Ut)
    record["kl_dual_fused"]["bound"] = bound(
        bytes_in(Hb, Ut) + bytes_out(x, gap, z),
        ops32=10000 * 100 * k1_ops_per_coord(3, 16))
    out2 = kl_dual_fused_cert(Hb, Ut)
    record["kl_dual_fused_cert"]["bound"] = bound(
        bytes_in(Hb, Ut) + bytes_out(*out2),
        ops32=10000 * 100 * k1_ops_per_coord(3, 16),
        ops64=10000 * 100 * k2_ops64_per_coord(3, 2, 0))
    # f64 models (DistKL.create's default for f64 data) reach K1 in f64
    Hb64 = Ht.double()[None].expand(10000, -1, -1)
    Ut64 = Ut.double()
    best, runs = in_turns({"plain": lambda: kl_dual_fused_plain(Hb64, Ut64),
                           "kernel": lambda: kl_dual_fused(Hb64, Ut64)},
                          {"plain": 3, "kernel": 20}, order)
    print(f"  kl_dual_fused f64: kernel {runs['kernel']} ms, plain "
          f"{runs['plain']} ms  [{smi}]")
    # the group path at phase 4's shapes: kernel and plain in turns, and
    # each bound from these inputs
    for label, gd in group.items():
        Hgb, Ugt, dim = gd["Hb"], gd["U"], gd["dim"]
        B_g, k_g, n_g = Hgb.shape
        for kname, kern, plain, err in (
                ("kl_dual_fused", kl_dual_fused, kl_dual_fused_plain,
                 gd["k1_err"]),
                ("kl_dual_fused_cert", kl_dual_fused_cert,
                 kl_dual_fused_cert_plain, gd["k2_err"])):
            best, runs = in_turns({"plain": lambda: plain(Hgb, Ugt),
                                   "kernel": lambda: kern(Hgb, Ugt)},
                                  {"plain": 2, "kernel": 10}, order)
            out = kern(Hgb, Ugt)
            ops = dict(ops32=B_g * n_g * k1_ops_per_coord(dim, 16))
            if kname == "kl_dual_fused_cert":
                ops["ops64"] = B_g * n_g * k2_ops64_per_coord(dim, k_g, 0)
            key = f"{kname}_group_{label}"
            record[key] = dict(ms=best["kernel"], plain_ms=best["plain"],
                               library_ms=None, err=err,
                               bound=bound(bytes_in(Hgb, Ugt)
                                           + bytes_out(*out), **ops))
            print(f"  {key} {B_g} x n={n_g} dim {dim}: kernel "
                  f"{runs['kernel']} ms, plain {runs['plain']} ms, bound "
                  f"{record[key]['bound'][0]:.5f} ms  [{smi}]")

    kargs = primal_args(H, U, X0, dev)
    kw = dict(mu=PRODUCTION["mu"], n_inner=PRODUCTION["max_iter"])
    best, runs = in_turns(
        {"plain": lambda: kl_barrier_fused_plain(*kargs, **kw),
         "kernel": lambda: kl_barrier_fused(*kargs, **kw)},
        {"plain": 3, "kernel": 20}, order)
    record["kl_barrier_fused"] = dict(ms=best["kernel"],
                                      plain_ms=best["plain"],
                                      library_ms=None)
    xk = kl_barrier_fused(*kargs, **kw)
    # the bound counts the candidates these inputs need, not all 12
    _, cand = kl_barrier_fused_plain(*kargs, count_candidates=True, **kw)
    n_cand = int(cand.sum())
    record["kl_barrier_fused"]["bound"] = bound(
        bytes_in(*kargs) + bytes_out(xk),
        ops32=k3_ops(2, 100, 10000, 21, n_cand))
    print(f"  kl_barrier_fused 10000 x n=100, 21 steps: kernel "
          f"{runs['kernel']} ms, plain {runs['plain']} ms; line-search "
          f"candidates {n_cand} ({n_cand / (10000 * 21):.4f} per step), "
          f"bound {record['kl_barrier_fused']['bound'][0]:.5f} ms  [{smi}]")
    # K3's group path at phase 4's route shapes
    for label, pg in primal_group.items():
        kargs_r, steps = pg["args"], pg["steps"]
        B_r, k_r, n_r = kargs_r[0].shape
        best, runs = in_turns(
            {"plain": lambda: kl_barrier_fused_plain(*kargs_r, **kw),
             "kernel": lambda: kl_barrier_fused(*kargs_r, **kw)},
            {"plain": 2, "kernel": 10}, order)
        xk = kl_barrier_fused(*kargs_r, **kw)
        _, cand = kl_barrier_fused_plain(*kargs_r, count_candidates=True,
                                         **kw)
        n_cand = int(cand.sum())
        key = f"kl_barrier_fused_group_{label}"
        record[key] = dict(ms=best["kernel"], plain_ms=best["plain"],
                           library_ms=None, err=pg["err"],
                           bound=bound(bytes_in(*kargs_r) + bytes_out(xk),
                                       ops32=k3_ops(k_r, n_r, B_r, steps,
                                                    n_cand)))
        print(f"  {key} {B_r} x n={n_r}, {steps} steps: kernel "
              f"{runs['kernel']} ms, plain {runs['plain']} ms; line-search "
              f"candidates {n_cand / (B_r * steps):.4f} per step, bound "
              f"{record[key]['bound'][0]:.5f} ms  [{smi}]")

    # the gap kernel at the primal route's shapes: 10,000 x n = 100 (K3's
    # x of phase 3) and 100 x n = 10,000 (phase 4's group route), dual dim
    # 3, 8 polish steps
    for key, gargs, err in (
            ("kl_gap_fused", gap_args(H, U, x_primal), gap_err),
            ("kl_gap_fused_n10000", primal_group["n10000"]["gap_args"],
             primal_group["n10000"]["gap_err"])):
        best, runs = in_turns({"plain": lambda: kl_gap_fused_plain(*gargs),
                               "kernel": lambda: kl_gap_fused(*gargs)},
                              {"plain": 3, "kernel": 20}, order)
        B_g, n_g = gargs[4].shape
        out = kl_gap_fused(*gargs)
        record[key] = dict(ms=best["kernel"], plain_ms=best["plain"],
                           library_ms=None, err=err,
                           bound=bound(bytes_in(*gargs) + bytes_out(*out),
                                       ops32=kgap_ops(3, n_g, B_g, 8)))
        print(f"  {key} {B_g} x n={n_g}, dim 3, 8 polish steps: kernel "
              f"{runs['kernel']} ms, plain {runs['plain']} ms, bound "
              f"{record[key]['bound'][0]:.5f} ms  [{smi}]")

    # the held path's shapes and the panel path's (n > 192) in each type
    chol_rows = []
    for B, n, dtype in ((4096, 100, torch.float32), (4096, 128, torch.float32),
                        (1024, 256, torch.float32), (256, 512, torch.float32),
                        (1024, 256, torch.float64), (256, 512, torch.float64)):
        X = spd_batch(B, n, dtype, dev, seed=B + n)
        best, runs = in_turns(
            {"plain": lambda: cholesky_batched_plain(X),
             "kernel": lambda: cholesky_batched_cuda(X),
             "library": lambda: torch.linalg.cholesky_ex(X)},
            {"plain": 3, "kernel": 20, "library": 20},
            ("plain", "kernel", "library", "library", "kernel", "plain"))
        # a Cholesky's updates are matrix products: f64 at the tensor
        # cores' rate
        ops = {"ops32" if dtype == torch.float32 else "ops64_tc":
               B * n ** 3 / 3}
        bms, by = bound(k4_bytes(B, n, X.element_size()), **ops)
        chol_rows.append(dict(B=B, n=n, dtype=str(dtype)[6:],
                              ms=best["kernel"], plain_ms=best["plain"],
                              library_ms=best["library"], bound_ms=bms,
                              bound_by=by))
        print(f"  cholesky {str(dtype)[6:]} {B} x {n}: kernel "
              f"{runs['kernel']} ms, plain {runs['plain']} ms, "
              f"torch.linalg.cholesky_ex {runs['library']} ms, bound "
              f"{bms:.4f} ms ({by})  [{smi}]")
    # the kernels line: the held path at 4096 x 100, the panel path (its
    # own __global__ function) at phase 4's 256 x 512, both f32
    for key, row in (("cholesky_batched_cuda", chol_rows[0]),
                     ("cholesky_batched_cuda_panel", chol_rows[3])):
        record[key] = dict(ms=row["ms"], plain_ms=row["plain_ms"],
                           library_ms=row["library_ms"],
                           bound=(row["bound_ms"], row["bound_by"]))
    print(json.dumps({"cholesky_sweep": chol_rows, "card": smi}))

    # 6. where the time goes: host wall and device busy share of each path
    print("phase 6: host wall and device busy share per call")
    # the fleet routes take seconds a call: one timed call and one traced,
    # phase 4c's call their warm-up; the generic core's take tens of
    # seconds: one traced call, its host wall phase 4b's untraced call of
    # the same route (tracing a million launches slows the host)
    for label, fn, reps, steps, wall_4b in (
            ("primal fused (K3 + kl_dual_gap)",
             lambda: prob_p.solve_jittable_batch(Ut, X0t, method="fused",
                                                 pars=pars), 10, None, None),
            ("dual auto (K2)", lambda: prob_d.solve_certified_batch(Ut), 10,
             None, None),
            ("dual fused_cert=False (K1 + f64 finish)",
             lambda: prob_d.solve_certified_batch(Ut, fused_cert=False), 10,
             None, None),
            ("cholesky_batched cuda 4096 x 100",
             lambda: cholesky_batched(Xc, method="cuda"), 10, None, None),
            *((g[0], g[1], 1, g[2], g[3]) for g in generic_routes),
            *((g[0], g[1], 1, g[2], None) for g in fleet_rows)):
        wall, busy, ops = device_busy(fn, reps, warm=steps is None,
                                      raw=steps is not None,
                                      timed=wall_4b is None)
        extra = {"host_wall_of": "separate timed calls"}
        if wall_4b is not None:
            extra = {"host_wall_of": "phase 4b's untraced call",
                     "traced_wall_ms": wall}
            wall = wall_4b
        steps = steps() if callable(steps) else steps
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        busy_s = "not measured" if busy is None else f"{busy:.4f}"
        print(json.dumps({"path": label, "host_wall_ms": wall, **extra,
                          "device_busy_ms": busy, "device_ops": ops,
                          "calls": reps, "newton_steps_longest": steps,
                          "card": smi}))
        print(f"  {label}: host wall {wall:.4f} ms, device busy {busy_s} "
              f"ms, busy share {share}")
    for rec in parallel_rows:       # measured in phase 4d, the group up
        print(json.dumps(rec))

    # the group paths' entries (kl_dual_group_kernel,
    # kl_dual_cert_group_kernel and kl_barrier_group_kernel) name their
    # shape after the wrapper
    srcs = {"kl_dual_fused": "cvx_tpu_torch/ops/csrc/kl_dual.cu",
            "kl_dual_fused_cert": "cvx_tpu_torch/ops/csrc/kl_dual.cu",
            "kl_barrier_fused": "cvx_tpu_torch/ops/csrc/kl_barrier.cu",
            "cholesky_batched_cuda": "cvx_tpu_torch/ops/csrc/chol.cu",
            "cholesky_batched_cuda_panel": "cvx_tpu_torch/ops/csrc/chol.cu",
            "kl_gap_fused": "cvx_tpu_torch/ops/csrc/kl_gap.cu",
            "kl_gap_fused_n10000": "cvx_tpu_torch/ops/csrc/kl_gap.cu"}
    replaces = {"kl_dual_fused": "cvx_tpu/ops/pallas_kl_dual.py:953",
                "kl_dual_fused_cert": "cvx_tpu/ops/pallas_kl_dual.py:836",
                "kl_barrier_fused": "cvx_tpu/ops/pallas_kl.py:295",
                "cholesky_batched_cuda": "cvx_tpu/ops/pallas_chol.py:139",
                "cholesky_batched_cuda_panel":
                    "cvx_tpu/ops/pallas_chol.py:139",
                # the reference's kl_dual_gap is plain JAX, fused by XLA
                "kl_gap_fused": "none (cvx_tpu/models/dist_kl.py kl_dual_gap)",
                "kl_gap_fused_n10000":
                    "none (cvx_tpu/models/dist_kl.py kl_dual_gap)"}
    errs = {"kl_dual_fused": k1_err, "kl_dual_fused_cert": k2_err,
            "kl_barrier_fused": k3_err, "cholesky_batched_cuda": k4_err,
            "cholesky_batched_cuda_panel": k4p_err}
    for key, rec in record.items():
        if key.startswith("kl_gap_fused"):
            errs[key] = rec["err"]
        if "_group_" in key:
            base = key.split("_group_")[0]
            srcs[key], replaces[key] = srcs[base], replaces[base]
            errs[key] = rec["err"]
    line = {"kernels": []}
    for kname, rec in record.items():
        bms, by = rec["bound"]
        line["kernels"].append({
            "name": kname, "route": "cuda", "source": srcs[kname],
            "replaces": replaces[kname], "launches": main_launches[kname],
            "max_abs_err": errs[kname], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": rec["library_ms"]})
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
