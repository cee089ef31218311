"""The scaling ladder of ``cvx_tpu_torch``: the counterpart of
``bench_scaling.py`` on the NVIDIA H100.

One function per row group of ``bench_scaling.py``'s ``main``, in its
order, each through the port's user entry points at the reference's
shapes (``docs/SCALING.md``):

* ``kl_batch``: bench.py's KL family at n = 100 / 1,000 / 10,000 with
  10,000 / 1,000 / 100 instances: the structured primal
  (``solve_jittable_batch(method="BR_fast")``) and the fused dual
  (``method="dual_fused"``, K1);
* ``kl_k3_vs_k2``: the reference's row, K1 at k = 2 and k = 3 scenario rows
  (dual dim 3 and 4) and their time ratio; then the primal route
  ``solve_jittable_batch(method="fused")`` (K3) against the certified
  ``solve_certified_batch`` (K2) at k = 2;
* ``kl_prior``: K1 with a general prior;
* ``kl_wide_dim``: the random k-row family at dual dims 6 / 8 / 12 / 16 (K1
  and the certified K2) and dim 20, past the kernels, on the fallback
  (``solve_dual_newton``, then the f64 finish);
* ``kl_certified``: ``solve_certified_batch`` (K2) at n = 100 / 1,000 /
  10,000;
* ``kl_dual_fast_rows``: ``method="dual_fast"`` at k = 2, 11, 19;
* ``phase1_fleet``: ``feasibility_batch``, the fleet screen at B = 2,000 and
  10,000, the generic ``feasibility_analysis`` and the certified route on
  the same mixed fleet (every 10th instance infeasible);
* ``qp_fleet``: ``QP`` fleets at (n, m, p, B) = (128, 64, 4, 512),
  (512, 256, 8, 128), (1000, 500, 10, 100): the barrier and the f64
  certificate (``qp_certify``) timed apart;
* ``tp_chol_row``: ``parallel.make_sharded_cholesky`` on one NCCL rank
  against ``torch.linalg.cholesky`` at n = 4,096 and 8,192;
* ``qp_n1000``: a dense QP, n = 1,000, m = 500, p = 10, by the barrier;
* ``kkt_factorizations``: ``ops.kkt_solve(method="chol")`` at n = 1,024 to
  8,192;
* ``batched_small_cholesky``: ``ops.cholesky_batched(method="cuda")`` (K4)
  against ``torch.linalg.cholesky_ex`` at 4096 x 128, 1024 x 256,
  256 x 512;
* ``big_cholesky``: ``torch.linalg.cholesky`` at n = 2,048 to 8,192 (the
  reference's XLA row; its blocked variants are not ported);
* ``separable_config5`` (off by default, as there): config 5 through
  ``parallel.schur`` and its certificate.

Every timed call ends in ``torch.cuda.synchronize()``; one setting of
``--reps`` and ``--tries`` holds for every row: a warm-up call, then the
best of ``tries`` means over ``reps`` calls.  ``ms`` is the host wall of a
call; a row whose route launches a kernel also times the kernel alone on
the route's inputs by CUDA events (``kernel_ms``) beside its bound
(``bound_ms``: bytes over the memory rate against operations over the
peak, from ``cvx_tpu_torch._bench`` as ``chip_smoke.py`` takes it) and,
for K4, ``torch.linalg.cholesky_ex`` (``library_ms``); a K1 or K2 row
also holds the kernel's outputs on the route's inputs against its plain
version's, as ``chip_smoke.py`` phase 3 does (``kernel_vs_plain``).
``launches`` are the counts of K1-K4 in the warm-up call, the counters
set to 0 just before it.  Certificates and checks are judged in f64
outside the timed region, a K1 row's host certificate on every lane; a
failed check is printed in its row and the script exits 1 after the last
row.  There is no fallback: a kernel that does not build or launch
raises.

The data comes from the reference's numpy seeds where it draws with
numpy; where it draws with ``jax.random`` (bench.py's pA / pB, the QP,
KKT and Cholesky matrices), the same distributions are drawn with numpy
from the same seed numbers, so both ladders solve the same families.
Dtype: f32 on the card (the reference's TPU dtype), f64 on the CPU (its
CPU dtype).  Multi-rank rows run on one NCCL rank; no row is a multi-card
number.

    python3 bench_scaling_torch.py [--device cuda|cpu] [--rows a,b,...]
        [--reps 3] [--tries 3] [--out _probe/bench_scaling.jsonl]

prints one JSON line per row (and the card's name and power limit);
``--device cpu`` runs every row at a tiny size.  ``--out`` writes the
same lines to a file under a path ``.gitignore`` lists.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cvx_tpu_torch._bench import (CERT_GAP, K1_DZ, K1_F64_DZ, K1_F64_TOL,
                                  K1_GAP_N, K1_TOL, K4_F64_TOL, K4_TOL,
                                  PRIMAL_CERT, PRODUCTION, TOL_FEAS,
                                  bench_family, bound, bytes_in, bytes_out,
                                  feasible_points, k1_agreement,
                                  k1_ops_per_coord, k2_agreement,
                                  k2_ops64_per_coord, k3_ops, k4_bytes,
                                  primal_args, qp_fleet_data, separable_data)

KERNELS = ("kl_dual_fused", "kl_dual_fused_cert", "kl_barrier_fused",
           "cholesky_batched_cuda")

# the row groups at the reference's shapes (the card) and at a tiny size
# (the CPU): sizes, batches and shapes each group reads
FULL = dict(kl_batch=((100, 10000), (1000, 1000), (10000, 100)),
            kl_B=10000, wide_ks=(5, 7, 11, 15, 19), cert=((100, 10000),
                                                         (1000, 1000),
                                                         (10000, 100)),
            fast_ks=(2, 11, 19), phase1_B=2000, screen_B=(2000, 10000),
            qp_fleet=((128, 64, 4, 512), (512, 256, 8, 128),
                      (1000, 500, 10, 100)),
            tp=(4096, 8192), qp_n=(1000, 500, 10), kkt=(1024, 2048, 4096,
                                                        8192),
            bchol=((128, 4096), (256, 1024), (512, 256)),
            big=(2048, 4096, 8192), sep=dict(K=64, nb=156, mb=32, p=8))
TINY = dict(kl_batch=((24, 6), (40, 3)), kl_B=6, wide_ks=(5, 15, 19),
            cert=((24, 6), (40, 3)), fast_ks=(2, 19), phase1_B=10,
            screen_B=(20,), qp_fleet=((32, 16, 2, 8),), tp=(256,),
            qp_n=(48, 24, 3), kkt=(64,), bchol=((16, 8),), big=(64,),
            sep=dict(K=4, nb=12, mb=6, p=2))


class Ladder:
    """What every row reads: the device and dtype, the shapes, one
    reps / tries setting, and the launch counters of K1-K4."""

    def __init__(self, device, reps=3, tries=3, out=None):
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.dtype = torch.float32 if self.cuda else torch.float64
        self.reps, self.tries = reps, tries
        self.shapes = FULL if self.cuda else TINY
        self.records, self.failed = [], []
        self.out = out
        from cvx_tpu_torch.ops.chol import cholesky_batched_cuda
        from cvx_tpu_torch.ops.kl_barrier import kl_barrier_fused
        from cvx_tpu_torch.ops.kl_dual import (kl_dual_fused,
                                               kl_dual_fused_cert)
        self.kernels = (kl_dual_fused, kl_dual_fused_cert, kl_barrier_fused,
                        cholesky_batched_cuda)

    def t(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype or self.dtype, device=self.dev)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def counts(self):
        return {k.__name__: k.launches for k in self.kernels}

    def run(self, fn):
        """(best ms of a call, the warm-up call's output, its launches):
        ``tries`` means over ``reps`` calls, each ending in
        synchronize()."""
        self.sync()
        for k in self.kernels:
            k.launches = 0
        out = fn()
        self.sync()
        launches = self.counts()
        best = math.inf
        for _ in range(self.tries):
            total = 0.0
            for _ in range(self.reps):
                t0 = time.perf_counter()
                fn()
                self.sync()
                total += time.perf_counter() - t0
            best = min(best, total * 1e3 / self.reps)
        return best, out, launches

    def events(self, fn):
        """Best ms of a call by CUDA events (the host clock on the CPU),
        the same reps / tries, after a warm-up call."""
        if not self.cuda:
            return self.run(fn)[0]
        fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(self.tries):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(self.reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / self.reps)
        return best

    def launched(self, launches, **want):
        """The check that the route launched exactly ``want`` (K1-K4 by
        name, the rest 0); on the CPU the plain versions count nothing."""
        expect = {k: (want.get(k, 0) if self.cuda else 0) for k in KERNELS}
        return launches == expect

    def kernel(self, name, fn, nbytes, ops32=0.0, ops64=0.0, library=None,
               matmul=False):
        """The kernel timed alone, with its bound (and a library call);
        ``matmul``: its f64 operations have a matrix-product shape."""
        ops64_tc = 0.0
        if self.dtype == torch.float64:
            ops32, ops64 = 0.0, ops32 + ops64
            if matmul:
                ops64, ops64_tc = 0.0, ops64
        bms, by = bound(nbytes, ops32, ops64, ops64_tc)
        rec = dict(name=name, kernel_ms=self.events(fn), bound_ms=bms,
                   bound_by=by)
        if library is not None:
            rec["library_ms"] = self.events(library)
        return rec

    def emit(self, group, metric, checks, dtype=None, **vals):
        rec = dict(group=group, metric=metric, device=self.dev.type,
                   dtype=str(dtype or self.dtype).replace("torch.", ""),
                   **vals, checks=checks)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            rec["failed"] = bad
            self.failed.append(f"{metric}: {bad}")
        self.records.append(rec)
        line = json.dumps(rec, default=float)
        print(line, flush=True)
        if self.out is not None:
            with open(self.out, "a") as f:
                f.write(line + "\n")
        return rec


def _np(t):
    return t.detach().cpu().double().numpy()


def _k1_cert_bound(n):
    """The host f64 certificate of K1's x: K1_TOL, growing with n past
    K1_GAP_N as K1's own gap does (chip_smoke.py)."""
    return K1_TOL * max(1.0, n / K1_GAP_N)


def _k1_row(L, group, metric, prob, Hb, U, H, u_np, *, prior=None,
            log_prior=None, want=1):
    """A K1 route row: ``solve_jittable_batch(method="dual_fused")``, the
    host certificate of its x on every lane, K1 held against its plain
    version on the route's inputs (where K1 runs), and K1 alone."""
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.ops import kl_dual_fused, kl_dual_fused_plain

    B, k, n = Hb.shape
    ms, sol, launches = L.run(
        lambda: prob.solve_jittable_batch(U, None, method="dual_fused"))
    cert = kl_gap_certificate_np(_np(sol.x), H, u_np, prior=prior)
    vals = dict(batch=B, n=n, dim=k + 1, ms=ms, value=B / ms * 1e3,
                unit="instances/s", gap_cert_max=float(cert.max()),
                gap_cert_argmax=int(cert.argmax()),
                route_gap_maxabs=float(sol.duality_gap.abs().max()),
                stalled=int(sol.stalled.sum()), launches=launches)
    checks = dict(launched=L.launched(launches, kl_dual_fused=want),
                  x_finite=bool(torch.isfinite(sol.x).all()),
                  cert=float(cert.max()) <= _k1_cert_bound(n))
    if want:
        got = kl_dual_fused(Hb, U, log_prior=log_prior)
        ref = kl_dual_fused_plain(Hb, U, log_prior=log_prior)
        f32 = L.dtype == torch.float32
        a = k1_agreement(got, ref, K1_TOL if f32 else K1_F64_TOL,
                         K1_DZ if f32 else K1_F64_DZ)
        vals["plain_gap_cert_max"] = float(kl_gap_certificate_np(
            _np(ref[0]), H, u_np, prior=prior).max())
        vals["vs_plain"] = {key: a[key] for key in (
            "converged", "dx", "dz", "gap", "dx_all")}
        checks["kernel_vs_plain"] = a["dead_same"] and a["close"]
        vals["kernel"] = L.kernel(
            "kl_dual_fused",
            lambda: kl_dual_fused(Hb, U, log_prior=log_prior),
            bytes_in(Hb, U, log_prior) + bytes_out(*got),
            ops32=B * n * k1_ops_per_coord(k + 1, 16))
    return L.emit(group, metric, checks, **vals)


def _certified_row(L, group, metric, prob, Hb, U, *, want_k2):
    """A ``solve_certified_batch`` row (K2 for f32 data within dual dim 16,
    the K1 + f64 route otherwise) and, with K2, K2 alone."""
    from cvx_tpu_torch.ops import kl_dual_fused_cert, kl_dual_fused_cert_plain

    B, k, n = Hb.shape
    ms, sol, launches = L.run(lambda: prob.solve_certified_batch(U))
    ga = float(sol.duality_gap.abs().max())
    ineq, eq = float(sol.ineq_res.max()), float(sol.eq_gap.max())
    vals = dict(batch=B, n=n, dim=k + 1, ms=ms, value=B / ms * 1e3,
                unit="instances/s", gap_measured_maxabs=ga,
                ineq_res_max=ineq, eq_res_max=eq,
                stalled=int(sol.stalled.sum()), launches=launches)
    k2 = want_k2 and L.dtype == torch.float32
    checks = dict(launched=L.launched(launches, kl_dual_fused_cert=int(k2),
                                      kl_dual_fused=int(not k2 and want_k2)),
                  contract_1e8=ga <= CERT_GAP,
                  residuals=max(ineq, eq) <= TOL_FEAS,
                  none_stalled=not bool(sol.stalled.any()))
    if k2:
        out = kl_dual_fused_cert(Hb, U)
        a = k2_agreement(out, kl_dual_fused_cert_plain(Hb, U))
        vals["vs_plain"] = {key: a[key] for key in (
            "certified", "dx", "dgap", "dz", "dres")}
        checks["kernel_vs_plain"] = a["dead_same"] and a["close"]
        vals["kernel"] = L.kernel(
            "kl_dual_fused_cert", lambda: kl_dual_fused_cert(Hb, U),
            bytes_in(Hb, U) + bytes_out(*out),
            ops32=B * n * k1_ops_per_coord(k + 1, 16),
            ops64=B * n * k2_ops64_per_coord(k + 1, k, 0))
    return L.emit(group, metric, checks, **vals)


def _bench_model(L, n, B, k_extra=()):
    """bench.py's family (numpy seed 0) with optional extra rows: the
    model, H (k, n), U (B, k) as numpy and on the device."""
    from cvx_tpu_torch import DistKL

    H, U = bench_family(B, n, seed=0)
    if k_extra:
        H = np.concatenate([H, np.stack([r for r, _ in k_extra])])
        U = np.column_stack([U] + [u for _, u in k_extra])
    prob = DistKL.create(n, H=L.t(H), u=L.t(np.zeros(H.shape[0])),
                         device=L.dev)
    Ut = L.t(U)
    return prob, H, U, Ut, prob.H[None].expand(B, -1, -1)


def kl_batch(L):
    """bench_scaling.py:80: the structured primal (BR_fast, 8 steps a
    stage at most) and the fused dual (K1) at three sizes."""
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.solvers import SolverParams

    pars = SolverParams(tol=1e-8, mu=30.0, kkt_method="chol", kkt_refine=1,
                        max_iter=8)
    for n, B in L.shapes["kl_batch"]:
        prob, H, U, Ut, Hb = _bench_model(L, n, B)
        X0 = L.t(feasible_points(U, n))
        ms, sol, launches = L.run(lambda: prob.solve_jittable_batch(
            Ut, X0, method="BR_fast", pars=pars))
        cert = kl_gap_certificate_np(_np(sol.x), H, U)
        L.emit("kl_batch", f"kl_batch_structured_n{n}",
               dict(launched=L.launched(launches),
                    x_finite=bool(torch.isfinite(sol.x).all()),
                    cert=float(cert.max()) <= PRIMAL_CERT),
               batch=B, n=n, ms=ms, value=B / ms * 1e3, unit="instances/s",
               newton_iters_per_s=float(sol.iters.sum()) / ms * 1e3,
               iters_max=int(sol.iters.max()),
               gap_cert_max=float(cert.max()), launches=launches)
        _k1_row(L, "kl_batch", f"kl_batch_dual_fused_n{n}", prob, Hb, Ut,
                H, U)


def kl_k3_vs_k2(L):
    """bench_scaling.py:159: K1 at k = 2 and k = 3 rows (dual dim 3 and 4)
    and their time ratio; then the primal route (K3 and the measured gap)
    against the certified route (K2) at k = 2."""
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
    from cvx_tpu_torch.ops import kl_barrier_fused, kl_barrier_fused_plain
    from cvx_tpu_torch.solvers import SolverParams

    n, B = 100, L.shapes["kl_B"]
    I_C = np.zeros(n); I_C[10:30] = 1.0
    pC = np.random.default_rng(2).uniform(0.35, 0.6, B)
    ms = {}
    for k, extra in ((2, ()), (3, ((I_C, pC),))):
        prob, H, U, Ut, Hb = _bench_model(L, n, B, extra)
        ms[k] = _k1_row(L, "kl_k3_vs_k2", f"kl_dual_fused_k{k}_n{n}", prob,
                        Hb, Ut, H, U)["kernel"]["kernel_ms"]
    L.emit("kl_k3_vs_k2", "kl_dual_fused_k3_over_k2_time_ratio", {},
           value=ms[3] / ms[2], unit="x (K1 alone, CUDA events)")

    prob, H, U, Ut, Hb = _bench_model(L, n, B)
    X0 = feasible_points(U, n)
    pars = SolverParams(**PRODUCTION)
    X0t = L.t(X0)
    t_k3, sol, launches = L.run(lambda: prob.solve_jittable_batch(
        Ut, X0t, method="fused", pars=pars))
    cert = kl_gap_certificate_np(_np(sol.x), H, U)
    args = primal_args(H, U, X0, L.dev, L.dtype)
    kw = dict(mu=PRODUCTION["mu"], n_inner=PRODUCTION["max_iter"])
    xk = kl_barrier_fused(*args, **kw)
    _, cand = kl_barrier_fused_plain(*args, count_candidates=True, **kw)
    steps = int(sol.iters.max())
    rec = L.emit(
        "kl_k3_vs_k2", f"kl_primal_fused_k2_n{n}",
        dict(launched=L.launched(launches, kl_barrier_fused=1),
             none_stalled=not bool(sol.stalled.any()),
             cert=float(cert.max()) <= PRIMAL_CERT),
        batch=B, n=n, ms=t_k3, value=B / t_k3 * 1e3, unit="instances/s",
        iters_max=steps, gap_cert_max=float(cert.max()), launches=launches,
        kernel=L.kernel("kl_barrier_fused",
                        lambda: kl_barrier_fused(*args, **kw),
                        bytes_in(*args) + bytes_out(xk),
                        ops32=k3_ops(2, n, B, steps, int(cand.sum()))))
    t_k2 = _certified_row(L, "kl_k3_vs_k2", f"kl_certified_k2_n{n}", prob,
                          Hb, Ut, want_k2=True)["ms"]
    L.emit("kl_k3_vs_k2", "kl_primal_fused_over_certified_time_ratio", {},
           value=rec["ms"] / t_k2, unit="x")


def kl_prior(L):
    """bench_scaling.py:208: K1 with a general prior (one shared log-prior
    row), certified against the same prior."""
    from cvx_tpu_torch import DistKL

    n, B = 100, L.shapes["kl_B"]
    rng = np.random.default_rng(0)
    p = np.exp(0.7 * rng.standard_normal(n)); p /= p.sum()
    H, U = bench_family(B, n, seed=0)
    prob = DistKL.create(n, H=L.t(H), u=L.t(np.zeros(2)), prior=L.t(p),
                         device=L.dev)
    Hb = prob.H[None].expand(B, -1, -1)
    _k1_row(L, "kl_prior", f"kl_dual_fused_prior_n{n}", prob, Hb, L.t(U), H,
            U, prior=p, log_prior=torch.log(prob.prior))


def _wide_family(rng, k, n, B):
    """bench_scaling.py:268-271: sparse random rows, every bound slack."""
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    return H, (H @ x0)[None, :] + rng.uniform(0.05, 0.15, (B, k))


def kl_wide_dim(L):
    """bench_scaling.py:249: the random k-row family at dual dims 6, 8, 12,
    16 (K1, then the certified K2) and dim 20 past the kernels (the
    fallback: ``solve_dual_newton``, then the f64 finish)."""
    from cvx_tpu_torch import DistKL

    n, B = 100, L.shapes["kl_B"]
    rng = np.random.default_rng(0)
    for k in L.shapes["wide_ks"]:
        H, U = _wide_family(rng, k, n, B)
        prob = DistKL.create(n, H=L.t(H), u=L.t(np.zeros(k)), device=L.dev)
        Ut, Hb = L.t(U), prob.H[None].expand(B, -1, -1)
        fits = k + 1 <= 16
        _k1_row(L, "kl_wide_dim", f"kl_dual_fused_dim{k + 1}_n{n}", prob,
                Hb, Ut, H, U, want=int(fits))
        _certified_row(L, "kl_wide_dim", f"kl_certified_1e8_dim{k + 1}_n{n}",
                       prob, Hb, Ut, want_k2=fits)


def kl_certified(L):
    """bench_scaling.py:315: the certified route (K2) at n = 100, 1,000
    and 10,000: max |gap| <= 1e-8, residuals <= tol_feas."""
    for n, B in L.shapes["cert"]:
        prob, _, _, Ut, Hb = _bench_model(L, n, B)
        _certified_row(L, "kl_certified", f"kl_certified_1e8_n{n}", prob, Hb,
                       Ut, want_k2=True)


def kl_dual_fast_rows(L):
    """bench_scaling.py:654: ``method="dual_fast"`` (30 projected-Newton
    steps on the dual, no kernel) at k = 2 (bench.py's family), 11 and
    19 (the random family)."""
    from cvx_tpu_torch.diagnostics import kl_gap_certificate_np

    n, B = 100, L.shapes["kl_B"]
    rng = np.random.default_rng(0)
    fams = {}
    for k in (11, 19):
        fams[k] = _wide_family(rng, k, n, B)
    for k in L.shapes["fast_ks"]:
        if k == 2:
            prob, H, U, Ut, _ = _bench_model(L, n, B)
        else:
            from cvx_tpu_torch import DistKL
            H, U = fams[k]
            prob = DistKL.create(n, H=L.t(H), u=L.t(np.zeros(k)),
                                 device=L.dev)
            Ut = L.t(U)
        ms, sol, launches = L.run(
            lambda: prob.solve_jittable_batch(Ut, None, method="dual_fast"))
        cert = kl_gap_certificate_np(_np(sol.x), H, U)
        L.emit("kl_dual_fast_rows", f"kl_dual_fast_k{k}_n{n}",
               dict(launched=L.launched(launches),
                    x_finite=bool(torch.isfinite(sol.x).all()),
                    cert=float(cert.max()) <= _k1_cert_bound(n)),
               batch=B, n=n, ms=ms, value=B / ms * 1e3, unit="instances/s",
               gap_cert_max=float(cert.max()), launches=launches)


def _mixed_fleet(rng, B, n):
    """bench_scaling.py:736-743: P(A) >= pA and P(A) <= qA, every 10th
    instance infeasible (qA < pA)."""
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[::10] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return np.stack([-pA, qA], axis=1), bad


def phase1_fleet(L):
    """bench_scaling.py:711: phase-I on a mixed feasible / infeasible KL
    fleet: ``feasibility_batch`` (flags exact), the fleet screen at two
    sizes, the generic ``feasibility_analysis`` on the batch of
    constraint sets, and the certified route's stall flags."""
    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.solvers import SolverParams
    from cvx_tpu_torch.solvers.phase1 import feasibility_analysis

    n, B = 100, L.shapes["phase1_B"]
    I_A = np.zeros(n); I_A[:3] = 1.0
    H = np.stack([-I_A, I_A])
    U, bad = _mixed_fleet(np.random.default_rng(0), B, n)
    pars = SolverParams(tol=1e-6, max_iter=60)
    prob = DistKL.create(n, H=L.t(H), u=L.t(np.zeros(2)), device=L.dev)
    Ut = L.t(U)
    ms, (s_max, _), launches = L.run(lambda: prob.feasibility_batch(Ut,
                                                                    pars))
    flags = _np(s_max) > 0.0
    L.emit("phase1_fleet", f"phase1_fleet_n{n}",
           dict(launched=L.launched(launches),
                flags_exact=bool(np.array_equal(flags, bad))),
           batch=B, n=n, ms=ms, value=B / ms * 1e3, unit="instances/s",
           infeasible_in_batch=int(bad.sum()), launches=launches)
    for Bs in L.shapes["screen_B"]:
        Us, bads = _mixed_fleet(np.random.default_rng(7), Bs, n)
        Ust = L.t(Us)
        ms, scr, launches = L.run(lambda: prob.feasibility_screen_batch(Ust))
        width = float((scr.s_upper - scr.s_lower).max())
        L.emit("phase1_fleet", f"phase1_screen_game_n{n}_B{Bs}",
               dict(launched=L.launched(launches),
                    flags_exact=bool(np.array_equal(
                        scr.infeasible.cpu().numpy(), bads)),
                    none_undecided=not bool(scr.undecided.any())),
               batch=Bs, n=n, ms=ms, value=Bs / ms * 1e3,
               unit="instances/s", infeasible_in_batch=int(bads.sum()),
               undecided=int(scr.undecided.sum()),
               interval_width_max=width, launches=launches)
    x_start = torch.full((B, n), 1.0 / n, dtype=L.dtype, device=L.dev)
    # the generic route: the per-instance constraint sets as one batch
    cnts = prob._inequalities(Ut)
    ms, rep, launches = L.run(lambda: feasibility_analysis(
        cnts, x_start, pars, prob.equalities))
    L.emit("phase1_fleet", f"phase1_fleet_generic_n{n}",
           dict(launched=L.launched(launches),
                flags_exact=bool(np.array_equal(_np(rep.s_max) > 0.0,
                                                bad))),
           batch=B, n=n, ms=ms, value=B / ms * 1e3, unit="instances/s",
           launches=launches)
    ms, sol, launches = L.run(lambda: prob.solve_certified_batch(Ut))
    stalled = sol.stalled.cpu().numpy()
    gmax = float(np.abs(_np(sol.duality_gap))[~bad].max())
    k2 = L.dtype == torch.float32
    L.emit("phase1_fleet", f"certified_mixed_fleet_n{n}",
           dict(launched=L.launched(launches, kl_dual_fused_cert=int(k2)),
                stall_flags_exact=bool(np.array_equal(stalled, bad)),
                contract_1e8_feasible=gmax <= CERT_GAP),
           batch=B, n=n, ms=ms, value=B / ms * 1e3, unit="instances/s",
           feasible_gap_max=gmax, launches=launches)


def qp_fleet(L):
    """bench_scaling.py:860: QP fleets (P, G, A shared; a, h per instance)
    by the barrier (f32 on the card, at most 40 steps a stage) and the f64
    certificate ``qp_certify``, timed apart; the certificate's measured
    gap <= 1e-8 and residuals <= tol_feas."""
    from cvx_tpu_torch import QP
    from cvx_tpu_torch.models import qp_certify
    from cvx_tpu_torch.solvers import SolverParams

    pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol", kkt_refine=1,
                        max_iter=40)
    for n, m, p, B in L.shapes["qp_fleet"]:
        qp = QP.create(**qp_fleet_data(n, m, p, B, seed=n), dtype=L.dtype,
                       device=L.dev)
        x0 = torch.zeros(n, dtype=L.dtype, device=L.dev)
        ms_b, sol, la = L.run(lambda: qp.solve_jittable(x0, "BR", pars))
        ms_c, cert, lc = L.run(lambda: qp_certify(
            qp.P, qp.a, qp.G, qp.h, qp.A, qp.b, sol.x, sol.lam, sol.nu))
        gap = float(cert.gap.abs().max())
        ineq, eq = float(cert.ineq_res.max()), float(cert.eq_res.max())
        steps = int(sol.iters.sum())
        L.emit("qp_fleet", f"qp_fleet_n{n}",
               dict(launched=L.launched(la) and L.launched(lc),
                    contract_1e8=gap <= CERT_GAP,
                    residuals=max(ineq, eq) <= TOL_FEAS,
                    x_finite=bool(torch.isfinite(cert.x).all())),
               batch=B, n=n, m=m, p=p, ms=ms_b + ms_c, barrier_ms=ms_b,
               certify_ms=ms_c, value=B / (ms_b + ms_c) * 1e3,
               unit="instances/s", iters_max=int(sol.iters.max()),
               newton_iters_per_s=steps / ms_b * 1e3,
               gap_measured_max=gap, ineq_res_max=ineq, eq_res_max=eq,
               launches=dict(barrier=la, certify=lc))


def _spd(L, n, seed, dtype=None):
    """M M^T + 2 I with M ~ N(0, 1/n) drawn by numpy from ``seed``, the
    product formed on the device."""
    M = L.t(np.random.default_rng(seed).standard_normal((n, n)) / math.sqrt(n),
            dtype or L.dtype)
    return M @ M.T + 2.0 * torch.eye(n, dtype=M.dtype, device=L.dev)


def _sampled_recon(L_, H, k=64):
    """max |L L^T - H| over ``k`` sampled rows, relative to max |H|, f64."""
    idx = torch.linspace(0, H.shape[0] - 1, k, device=H.device).long()
    Lh = torch.tril(L_).double()
    err = (Lh[idx] @ Lh.T - H.double()[idx]).abs().max()
    return float(err / H.abs().max())


def tp_chol_row(L):
    """bench_scaling.py:933: the row-sharded blocked Cholesky
    (``make_sharded_cholesky``, block 128, f64 as the port's phase 4d) on a
    one-rank group (NCCL on the card, gloo on the CPU) against
    ``torch.linalg.cholesky``."""
    import torch.distributed as dist

    from cvx_tpu_torch.parallel import (init_distributed, instance_mesh,
                                        make_sharded_cholesky)
    from cvx_tpu_torch.parallel.mesh import free_port

    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=L.dev)
    try:
        for n in L.shapes["tp"]:
            H = _spd(L, n, n, torch.float64)
            chol = make_sharded_cholesky(instance_mesh(axis="tp",
                                                       device=L.dev),
                                         n, block=128 if n >= 1024 else 64)
            ms_tp, Ltp, la = L.run(lambda: chol(H))
            ms_lib, Lref, _ = L.run(lambda: torch.linalg.cholesky(H))
            rel = float((Ltp - Lref).abs().max() / Lref.abs().max())
            L.emit("tp_chol_row", f"tp_chol_tp1rank_n{n}",
                   dict(launched=L.launched(la), against_torch=rel <= 1e-12),
                   n=n, ms=ms_tp, torch_linalg_cholesky_ms=ms_lib,
                   value=ms_tp / ms_lib, unit="x torch.linalg.cholesky",
                   max_rel_dL=rel, backend=dist.get_backend(),
                   launches=la)
            del H, Ltp, Lref
    finally:
        dist.destroy_process_group()


def qp_dense_data(n, m, p, seed=2):
    """bench_scaling.py:375-384 from one numpy stream: M ~ N(0, 1/n) (P =
    M M^T + I), z ~ N(0, 1) (a = -P z), G ~ N(0, 1/n), ub ~ U(0.5, 1.5) (x0
    = 0 strictly feasible), A ~ N(0, 1/n) (b = 0)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)) / math.sqrt(n),
            rng.standard_normal(n),
            rng.standard_normal((m, n)) / math.sqrt(n),
            rng.uniform(0.5, 1.5, m),
            rng.standard_normal((p, n)) / math.sqrt(n))


def qp_n1000(L):
    """bench_scaling.py:364: config 3, a dense QP (n = 1,000, m = 500
    inequalities, p = 10 equalities) by the generic barrier: in f32 (the
    reference's TPU dtype) and, on the card, in f64."""

    n, m, p = L.shapes["qp_n"]
    for dtype in (L.dtype, torch.float64) if L.cuda else (L.dtype,):
        _qp_dense(L, n, m, p, dtype)


def _qp_dense(L, n, m, p, dtype):
    from cvx_tpu_torch.problem.constraint_set import ConstraintSet
    from cvx_tpu_torch.problem.constraints import LinearBlock
    from cvx_tpu_torch.problem.equality import EqualityConstraint
    from cvx_tpu_torch.problem.objective import QuadraticObjective
    from cvx_tpu_torch.solvers import SolverParams, barrier_solve

    M, z, G, ub, A = (L.t(v, dtype) for v in qp_dense_data(n, m, p))
    P = M @ M.T + torch.eye(n, dtype=dtype, device=L.dev)
    obj = QuadraticObjective(P=P, a=-(P @ z), r=0.5 * (z @ (P @ z)))
    cnts = ConstraintSet(blocks=(LinearBlock(
        G=G, c=torch.zeros(m, dtype=dtype, device=L.dev), ub=ub),))
    eqs = EqualityConstraint(A=A, b=torch.zeros(p, dtype=dtype,
                                                device=L.dev))
    pars = SolverParams(tol=1e-7, mu=20.0, kkt_method="chol", kkt_refine=1)
    x0 = torch.zeros(1, n, dtype=dtype, device=L.dev)
    ms, sol, launches = L.run(lambda: barrier_solve(obj, cnts, x0, pars,
                                                    eqs=eqs))
    margin = float((ub - G @ sol.x[0]).min())
    eps = torch.finfo(dtype).eps
    # the barrier's own exit rule: a margin may round to ~0 at the final t
    slack = 100.0 * eps * (1.0 + float(ub.abs().max()))
    checks = dict(launched=L.launched(launches),
                  gap=float(sol.duality_gap[0]) <= pars.tol,
                  margins=margin >= -slack,
                  x_finite=bool(torch.isfinite(sol.x).all()))
    if dtype == torch.float64:
        # the reference's row (bench_scaling.py:364-411) reads no stall
        # flag; the f32 row records the port's flag (``stalled``) without
        # a check, the f64 row holds it
        checks["not_stalled"] = not bool(sol.stalled.any())
    L.emit("qp_n1000", f"qp_dense_n{n}_barrier_{str(dtype)[6:]}", checks,
           dtype=dtype, n=n, m=m, p=p, ms=ms, unit="ms/solve",
           stalled=bool(sol.stalled.any()),
           newton_iters=int(sol.iters[0]),
           newton_iters_per_s=int(sol.iters[0]) / ms * 1e3,
           gap=float(sol.duality_gap[0]), eq_gap=float(sol.eq_gap[0]),
           min_margin=margin, launches=launches)


def kkt_factorizations(L):
    """bench_scaling.py:466: one KKT factorize + solve (block elimination,
    ``method="chol"``, one refinement) at large n, p = 16."""
    from cvx_tpu_torch.ops import kkt_solve

    for n in L.shapes["kkt"]:
        p = min(16, n // 4)
        rng = np.random.default_rng(n)
        H = _spd(L, n, n)
        A = L.t(rng.standard_normal((p, n)) / math.sqrt(n))
        q = L.t(rng.standard_normal(n))
        b = torch.zeros(p, dtype=L.dtype, device=L.dev)
        ms, (x, _, rr), launches = L.run(
            lambda: kkt_solve(H, A, q, b, method="chol", refine=1))
        eps = torch.finfo(L.dtype).eps
        L.emit("kkt_factorizations", f"kkt_factorize_solve_n{n}",
               dict(launched=L.launched(launches),
                    relres=float(rr) <= 1e3 * eps,
                    x_finite=bool(torch.isfinite(x).all())),
               n=n, p=p, ms=ms, value=1e3 / ms, unit="factorizations/s",
               relres=float(rr), launches=launches)
        del H


def batched_small_cholesky(L):
    """bench_scaling.py:587: many small Cholesky factorizations, K4
    (``cholesky_batched(method="cuda")``) against
    ``torch.linalg.cholesky_ex``."""
    from cvx_tpu_torch.ops import cholesky_batched

    tol = K4_TOL if L.dtype == torch.float32 else K4_F64_TOL
    for n, B in L.shapes["bchol"]:
        g = np.random.default_rng(n)
        M = L.t(g.standard_normal((B, n, n)) / math.sqrt(n))
        X = M @ M.transpose(1, 2) + 2.0 * torch.eye(n, dtype=L.dtype,
                                                   device=L.dev)
        del M
        method = "cuda" if L.cuda else "torch"
        ms, Lk, launches = L.run(lambda: cholesky_batched(X, method=method))
        Lref = torch.linalg.cholesky_ex(X)[0]
        rel = float((Lk - Lref).abs().max() / Lref.abs().max())
        L0 = torch.tril(Lk[0]).double()
        err0 = float((L0 @ L0.T - X[0].double()).abs().max())
        item = X.element_size()
        kern = L.kernel(
            "cholesky_batched_cuda", lambda: cholesky_batched(X,
                                                              method=method),
            k4_bytes(B, n, item), ops32=B * n ** 3 / 3,
            library=lambda: torch.linalg.cholesky_ex(X), matmul=True)
        L.emit("batched_small_cholesky", f"batched_chol_n{n}_b{B}",
               dict(launched=L.launched(launches, cholesky_batched_cuda=1),
                    against_cholesky_ex=rel <= tol,
                    L_finite=bool(torch.isfinite(Lk).all())),
               n=n, batch=B, ms=ms, value=B / ms * 1e3,
               unit="factorizations/s", max_rel_dL=rel, max_abs_err=err0,
               launches=launches, kernel=kern)
        del X, Lk, Lref


def big_cholesky(L):
    """bench_scaling.py:528: one large Cholesky by
    ``torch.linalg.cholesky``, the port's counterpart of the reference's
    XLA row (``ops/blocked_chol.py`` is not ported)."""
    for n in L.shapes["big"]:
        H = _spd(L, n, n)
        ms, L_, launches = L.run(lambda: torch.linalg.cholesky(H))
        err = _sampled_recon(L_, H)
        eps = torch.finfo(L.dtype).eps
        L.emit("big_cholesky", f"big_chol_torch_n{n}",
               dict(launched=L.launched(launches),
                    recon=err <= 1e3 * eps),
               n=n, ms=ms, value=1e3 / ms, unit="factorizations/s",
               max_rel_err_sampled=err, launches=launches)
        del H, L_


def separable_config5(L):
    """bench_scaling.py:414: config 5 (64 blocks of 156, coupling
    equalities) by the Schur-consensus barrier and its f64 certificate,
    on one process."""
    from cvx_tpu_torch.parallel import SeparableProblem
    from cvx_tpu_torch.parallel.schur import (separable_barrier_solve,
                                              separable_certify)
    from cvx_tpu_torch.solvers import SolverParams

    prob = SeparableProblem(*(L.t(v) for v in separable_data(
        **L.shapes["sep"])))
    x0 = torch.zeros(prob.K, prob.nb, dtype=L.dtype, device=L.dev)
    pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)

    def run():
        s = separable_barrier_solve(prob, x0, pars)
        return s, separable_certify(prob, s.x, s.lam, s.nu)

    ms, (s, c), launches = L.run(run)
    L.emit("separable_config5", f"separable_config5_n{prob.K * prob.nb}_"
           f"{prob.K}blocks",
           dict(launched=L.launched(launches),
                contract_1e8=abs(float(c.gap)) <= CERT_GAP,
                residuals=max(float(c.ineq_res), float(c.eq_res))
                <= TOL_FEAS),
           ms=ms, unit="ms/solve (incl. certify)",
           newton_iters=int(s.iters), gap_measured=float(c.gap),
           ineq_res=float(c.ineq_res), eq_err=float(c.eq_res),
           launches=launches)


GROUPS = (kl_batch, kl_k3_vs_k2, kl_prior, kl_wide_dim, kl_certified,
          kl_dual_fast_rows, phase1_fleet, qp_fleet, tp_chol_row, qp_n1000,
          kkt_factorizations, batched_small_cholesky, big_cholesky,
          separable_config5)
DEFAULT_OFF = ("separable_config5",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", default="",
                    help="comma-separated row groups (default: all but "
                         "separable_config5)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tries", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines here (a gitignored "
                         "path, e.g. _probe/bench_scaling.jsonl)")
    args = ap.parse_args(argv)
    names = [g.__name__ for g in GROUPS]
    rows = [r for r in args.rows.split(",") if r] or [
        n for n in names if n not in DEFAULT_OFF]
    unknown = sorted(set(rows) - set(names))
    if unknown:
        ap.error(f"unknown row groups {unknown}; known: {names}")
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("bench_scaling_torch: no CUDA device (pass --device cpu)",
                  file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(json.dumps({"card": smi, "torch": torch.__version__,
                          "cuda": torch.version.cuda}), flush=True)
        from cvx_tpu_torch.ops import _build
        t0 = time.perf_counter()
        _build.build_all()
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        open(args.out, "w").close()
    L = Ladder(args.device, reps=args.reps, tries=args.tries, out=args.out)
    t_all = time.perf_counter()
    for g in GROUPS:
        if g.__name__ in rows:
            t0 = time.perf_counter()
            g(L)
            print(json.dumps({"group": g.__name__,
                              "wall_s": time.perf_counter() - t0}),
                  flush=True)
    print(json.dumps({"rows": len(L.records), "failed": L.failed,
                      "wall_s": time.perf_counter() - t_all}), flush=True)
    return 1 if L.failed else 0


if __name__ == "__main__":
    sys.exit(main())
