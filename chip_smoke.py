"""Smoke run of ``cvx_tpu_torch`` on one NVIDIA GPU (H100).

Builds the port's CUDA kernels from ``cvx_tpu_torch/ops/csrc``, holds each
kernel against its plain PyTorch version on the card, drives the batched
certified KL solve end to end through the user entry points
(``DistKL.create`` -> ``solve_certified_batch`` / ``solve``) on the bench
family at 10,000 instances x n = 100, times the kernels with CUDA events,
and prints one JSON line per result.  Any failed check raises.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero, printing no result, without one.
Imports nothing of JAX: inputs are made with numpy from fixed seeds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

K1_TOL = 1e-5      # f32 solve: max |dx| and |gap| on converged lanes
K1_F64_TOL = 1e-9  # the same solve in f64
# K1's z on converged lanes, as max |dz| / (1 + |z|): f32, f64
K1_DZ, K1_F64_DZ = 1e-4, 1e-8
K2_DX, K2_DGAP = 1e-11, 1e-10   # f64 polish + certificate
K2_DZ = 1e-9       # K2's polished z, as max |dz| / (1 + |z|)
K2_DRES = 1e-12    # K2's ineq_res and eq_res, absolute
CERT_GAP = 1e-8    # the reference's certified contract (tolSolver)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")
    print(f"  ok: {msg}")


def bench_family(B, n, seed):
    """bench.py's family: P(A) >= pA (|A| = 3, active), P(B) <= pB."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B])
    U = np.column_stack([-rng.uniform(0.2, 0.5, B), rng.uniform(0.55, 0.8, B)])
    return H, U


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


def cases(dev):
    """(name, Hs, U, A, R) on the card: shared rows are stride-0 expands."""
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    out = []
    H, U = bench_family(10000, 100, seed=0)
    out.append(("bench 10000 x n=100 (dim 3)",
                t(H)[None].expand(10000, -1, -1), t(U), None, None))
    for k, m_eq in ((2, 0), (7, 0), (5, 2), (15, 0), (13, 2)):
        H, U, A, R = random_family(k, m_eq, 24, 256)
        Ab = t(A)[None].expand(256, -1, -1) if m_eq else None
        out.append((f"family k={k} mE={m_eq} (dim {k + 1 + m_eq})",
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
    return out


def max_abs(d, lanes):
    """max |d| over the selected lanes (rows of a 2-D d), 0 for none."""
    return float(d[lanes].abs().max()) if lanes.any() else 0.0


def compare_k1(name, got, ref, tol, ztol):
    (xk, gk, zk), (xp, gp, zp) = got, ref
    dead_k, dead_p = torch.isinf(gk) & (gk > 0), torch.isinf(gp) & (gp > 0)
    check(torch.equal(dead_k, dead_p),
          f"K1 {name}: identical dead lanes ({int(dead_p.sum())})")
    conv = torch.isfinite(gp) & (gp.abs() <= tol)
    dx = max_abs(xk - xp, conv)
    dz = max_abs((zk - zp) / (1.0 + zp.abs()), conv)
    gmax = max_abs(gk, conv)
    dx_all = max_abs(xk - xp, ~dead_p)
    print(f"  K1 {name}: {int(conv.sum())}/{len(gp)} lanes converged; "
          f"max|dx| {dx:.3e} (all live lanes {dx_all:.3e}); max|dz|/(1+|z|)"
          f" {dz:.3e}; max|gap| {gmax:.3e}")
    check(dx <= tol and gmax <= tol and dz <= ztol,
          f"K1 {name}: max|dx| and |gap| <= {tol:g}, z within {ztol:g} "
          "on converged lanes")
    return dx


def compare_k2(name, got, ref):
    xk, zk, gk, ik, ek = got
    xp, zp, gp, ip, ep = ref
    check(torch.equal(torch.isinf(gk), torch.isinf(gp)),
          f"K2 {name}: identical dead lanes")
    cert = torch.isfinite(gp) & (gp.abs() <= CERT_GAP)
    dx = max_abs(xk - xp, cert)
    dg = max_abs(gk - gp, cert)
    dz = max_abs((zk - zp) / (1.0 + zp.abs()), cert)
    dres = max(max_abs(ik - ip, cert), max_abs(ek - ep, cert))
    print(f"  K2 {name}: {int(cert.sum())}/{len(gp)} lanes certified; "
          f"max|dx| {dx:.3e}; max|dgap| {dg:.3e}; max|dz|/(1+|z|) "
          f"{dz:.3e}; max|d ineq_res|, |d eq_res| {dres:.3e}")
    check(dx <= K2_DX and dg <= K2_DGAP and dz <= K2_DZ
          and dres <= K2_DRES,
          f"K2 {name}: max|dx| <= {K2_DX:g}, |dgap| <= {K2_DGAP:g}, z "
          f"within {K2_DZ:g}, residuals within {K2_DRES:g}")
    return dx


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.ops import _build
    from cvx_tpu_torch.ops.kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                                           kl_dual_fused_cert_plain,
                                           kl_dual_fused_plain)

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

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load_kl_dual()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib._name}")

    # 3. kernel vs plain on the card
    print("phase 3: kernels against their plain versions")
    k1_err = k2_err = 0.0
    for cname, Hs, U, A, R in cases(dev):
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
    check(kl_dual_fused.launches > 0 and kl_dual_fused_cert.launches > 0,
          f"launch counters K1 {kl_dual_fused.launches}, K2 "
          f"{kl_dual_fused_cert.launches}")

    # 4. the slice, through the user entry points
    print("phase 4: the slice (10,000 instances, n = 100)")
    H, U = bench_family(10000, 100, seed=0)
    f32 = dict(dtype=torch.float32, device=dev)
    Ht, Ut = torch.tensor(H, **f32), torch.tensor(U, **f32)
    Hb = Ht[None].expand(10000, -1, -1)
    x32, _, _ = kl_dual_fused(Hb, Ut)    # bench.py's f32 x, judged below
    prob = DistKL.create(100, H=Ht, u=torch.zeros(2, **f32))
    prob_one = DistKL.create(100, H=Ht, u=Ut[0])
    torch.cuda.synchronize()
    kl_dual_fused.launches = kl_dual_fused_cert.launches = 0
    t0 = time.perf_counter()
    sol = prob.solve_certified_batch(Ut)                    # K2
    sol_k1 = prob.solve_certified_batch(Ut, fused_cert=False)  # K1 + f64
    one = prob_one.solve(method="dual_fused")               # K1
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = {"kl_dual_fused": kl_dual_fused.launches,
                "kl_dual_fused_cert": kl_dual_fused_cert.launches}
    print(f"  slice wall {slice_s:.3f} s (first calls); launches {launches}")
    check(launches == {"kl_dual_fused": 2, "kl_dual_fused_cert": 1},
          "the entry points launched K1 twice (fused_cert=False, solve) "
          "and K2 once (auto)")
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

    # 5. times at 10,000 x n = 100 (plain, kernel, kernel, plain)
    print("phase 5: times at 10,000 x n = 100 (CUDA events)")
    timed = {}
    for kname, kern, plain in (("kl_dual_fused", kl_dual_fused,
                                kl_dual_fused_plain),
                               ("kl_dual_fused_cert", kl_dual_fused_cert,
                                kl_dual_fused_cert_plain)):
        runs = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kern
            reps = 3 if which == "plain" else 20
            runs[which].append(time_ms(lambda: fn(Hb, Ut), reps))
        timed[kname] = (min(runs["kernel"]), min(runs["plain"]))
        print(f"  {kname}: kernel {runs['kernel']} ms, plain "
              f"{runs['plain']} ms  [{smi}]")
    # f64 models (DistKL.create's default for f64 data) reach K1 in f64
    Hb64 = Ht.double()[None].expand(10000, -1, -1)
    Ut64 = Ut.double()
    runs = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kl_dual_fused_plain if which == "plain" else kl_dual_fused
        runs[which].append(time_ms(lambda: fn(Hb64, Ut64),
                                   3 if which == "plain" else 20))
    print(f"  kl_dual_fused f64: kernel {runs['kernel']} ms, plain "
          f"{runs['plain']} ms  [{smi}]")

    src = "cvx_tpu_torch/ops/csrc/kl_dual.cu"
    record = {"kernels": [
        {"name": "kl_dual_fused", "route": "cuda", "source": src,
         "replaces": "cvx_tpu/ops/pallas_kl_dual.py:953",
         "launches": launches["kl_dual_fused"], "max_abs_err": k1_err,
         "ms": timed["kl_dual_fused"][0],
         "plain_ms": timed["kl_dual_fused"][1]},
        {"name": "kl_dual_fused_cert", "route": "cuda", "source": src,
         "replaces": "cvx_tpu/ops/pallas_kl_dual.py:836",
         "launches": launches["kl_dual_fused_cert"], "max_abs_err": k2_err,
         "ms": timed["kl_dual_fused_cert"][0],
         "plain_ms": timed["kl_dual_fused_cert"][1]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
