"""Variants of K3 (``cvx_tpu_torch/ops/csrc/kl_barrier.cu``) on one NVIDIA
GPU: registers, bits and times.

Builds the committed source, a baseline (an earlier ``kl_barrier.cu``,
e.g. ``git show <commit>:cvx_tpu_torch/ops/csrc/kl_barrier.cu``) and
text-substituted variants, each with ``_build.NVCC_FLAGS`` plus ``-Xptxas
-v``, one nvcc each, all started together, into ``_probe/build``
(gitignored); prints the registers and spills of every template instance;
holds the committed kernel to the plain version (``chip_smoke.py``'s
tolerances, NaN in the same places) on bench.py's family and on edge cases
at both paths (n <= 256 the register path, n > 256 the other), the
baseline to the committed kernel bit for bit on the register path, or, as
integers, on every path for a baseline that reads its schedule from
tensors (``TENSOR_SCHEDULE``: the interface before the kernel worked the
schedule out itself, launched here with ``_schedule``'s tensors made
before the launch), and every other variant to what its kind says
(``VARIANTS``); with ``--time`` times them in turns (forward, then
backward) with CUDA events at ``TIME_CASES``, the kernel alone, each
beside its bound
(``_bench.bound`` with ``k3_ops``) and, with ``--plain``, the plain
version's time.

    python3 probe_k3.py [--baseline OLD.cu] [--time] [--plain]
                        [--only V1,V2] [--out DIR]

``--only`` picks the variants built beside the committed source and the
baseline (default ``DEFAULT``; ``--only ""`` builds none).  Needs a CUDA
device and nvcc; writes nvcc's full reports to ``DIR/ptxas_<variant>.txt``
and the whole log to ``DIR/log.txt`` (default ``_probe/build``).  The
committed kernel against its parent's tensor-schedule build, times, bits
and the ptxas table:

    git show <parent>:cvx_tpu_torch/ops/csrc/kl_barrier.cu > _probe/old.cu
    python3 probe_k3.py --baseline _probe/old.cu --time --only ""
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
import time
from pathlib import Path

import torch

from chip_smoke import K3_F64_TOL, K3_TOL
from cvx_tpu_torch._bench import (bench_family, bound, bytes_in, bytes_out,
                                  feasible_points, k3_ops, primal_args)
from cvx_tpu_torch.ops import _build
from cvx_tpu_torch.ops import kl_barrier as kb
from probe_common import BUILD, build, card, parse_ptxas, same_bits, say, \
    write_log

ROOT = Path(__file__).resolve().parent
SMEM = 232448          # shared memory a block may use on the H100

# Each variant: (the source it edits, the substitutions, what it is held
# to).  "parent": the baseline when one is given, else the committed
# source; it is held to that source bit for bit ("same").  "plain": held
# to the plain version by the committed kernel's tolerances.  A variant
# may also name the shapes (n, itemsize) it takes.
VARIANTS = {
    # the one-warp scratch path of an earlier source (n > 256) hands the
    # accepted candidate's logs over in its log row, as the register path
    # does in registers: the same bits, without pass 1's logs after a step
    "logs": ("parent", [
        ("            if constexpr (NC > 0) lc[l][c] = lxs;\n",
         "            if constexpr (NC > 0) lc[l][c] = lxs; else lx[c] = "
         "lxs;\n"),
        ("          if constexpr (NC > 0) {\n            if (done) {\n"
         "#pragma unroll\n              for (int c = 0; c < nc; ++c)\n"
         "                if (lane + 32 * c < n) lx[c] = lc[l][c];\n",
         "          if (done) {\n            if constexpr (NC > 0) {\n"
         "#pragma unroll\n              for (int c = 0; c < nc; ++c)\n"
         "                if (lane + 32 * c < n) lx[c] = lc[l][c];\n"
         "            }\n            {\n"),
        ("      have_logs = handed_over;\n    }\n",
         "      have_logs = handed_over;\n    }\n"
         "    if (NC == 0 && !handed_over) have_logs = false;\n")],
        "same", None),
    # the one-warp scratch path's six rows in shared memory, not L2: the
    # same bits, where 4 instances' rows fit in a block
    "smem": ("parent", [
        ("  T* srow = scratch + (long long)b * kScratchRows * n + lane;\n",
         "  extern __shared__ unsigned char probe_smem[];\n"
         "  T* srow = reinterpret_cast<T*>(probe_smem) + (threadIdx.x >> 5)"
         " * kScratchRows * n + lane;\n"),
        ("    kl_barrier_kernel<T, K, 0><<<blocks, kThreads, 0, st>>>"
         "(KL_K3_ARGS);\n",
         "  {\n    const int sm = kWarpsPerBlock * kScratchRows * n * "
         "(int)sizeof(T);\n    cudaFuncSetAttribute(kl_barrier_kernel<T, K,"
         " 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);\n"
         "    kl_barrier_kernel<T, K, 0><<<blocks, kThreads, sm, st>>>"
         "(KL_K3_ARGS);\n  }\n")],
        "same", lambda n, size: 4 * 6 * n * size <= SMEM),
    # the register path's line-search chunk and instances a block
    "C2": ("committed", [("constexpr int kLsChunk = 1;",
                          "constexpr int kLsChunk = 2;")], "same", None),
    "W2": ("committed", [("constexpr int kWarpsPerBlock = 4;",
                          "constexpr int kWarpsPerBlock = 2;")], "same",
           None),
    # the group path (n > 256): G's fill rule and cap, groups of one warp
    # (the scratch path's layout of the work: one warp's serial chain an
    # instance), and an f32 thread's sums past 8 terms: plain, or each term
    # compensated
    "fill1024": ("committed", [("constexpr int kGroupFillWarps = 4096;",
                                "constexpr int kGroupFillWarps = 1024;")],
                 "plain", None),
    "full32": ("committed", [("constexpr int kGroupFullNC = 16;",
                              "constexpr int kGroupFullNC = 32;")],
               "plain", None),
    "M8": ("committed", [("while (G < kGroupMaxWarps &&",
                          "while (G < 8 &&")], "plain", None),
    "G1": ("committed", [("while (G < kGroupMaxWarps &&",
                          "while (G < 1 &&")], "plain", None),
    "nocomp": ("committed", [("constexpr bool BLK = sizeof(T) == "
                              "sizeof(float) && NC == 0;",
                              "constexpr bool BLK = false;")], "plain",
               None),
    "kahan": ("committed", [("if (c > 0 && c % kGroupNC == 0) flush();",
                             "if (c > 0) flush();")], "plain", None),
}
DEFAULT = "fill1024,full32,M8,G1,nocomp,kahan"

# The C interface of a source that reads its schedule from tensors: t per
# stage, the candidates' factors and log n as device pointers in place of
# t0, mu and beta (_build.UNITS["kl_barrier"] gives the committed one)
TENSOR_SCHEDULE = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 7
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] + [ctypes.c_double] * 2
                   + [ctypes.c_void_p])


def reads_tensors(src):
    """Whether a ``kl_barrier.cu`` takes its schedule as tensors."""
    return "const void* ts, const void* ls_ts" in " ".join(src.split())


# ptxas's kernel instances: "kernel f k=2 NC=4 [where=W]"
KERNELS = ((r"(kl_barrier\w*?kernel)I([fd])Li(\d)ELi(\d+)E"
            r"(?:\w*?WhereE(\d)E)?",
            lambda m: f"{m[1]} {m[2]} k={m[3]} NC={m[4]}"
                      + (f" where={m[5]}" if m[5] else "")),)


def sources(baseline, only):
    """{name: (source text, held to, takes(n, itemsize) or None)}"""
    committed = (ROOT / "cvx_tpu_torch/ops/csrc/kl_barrier.cu").read_text()
    out = {"committed": (committed, "plain", None)}
    parent = committed
    if baseline:
        parent = Path(baseline).read_text()
        out["baseline"] = (parent, "same" if reads_tensors(parent)
                           else "register", None)
    for name in only:
        base, subs, held, takes = VARIANTS[name]
        src = parent if base == "parent" else committed
        for old, new, *count in subs:
            if src.count(old) != (count[0] if count else 1):
                raise SystemExit(f"variant {name}: {old!r} does not match "
                                 "its source as often as it should")
            src = src.replace(old, new)
        out[name] = (src, held, takes)
    return out


def launcher(lib, Hs, u, A, b, x0, *, t0=1.0, mu=30.0, tol=1e-8,
             n_outer=None, n_inner=8, alpha=0.04, beta=0.8, n_ls=12):
    """A function that launches ``kl_barrier_fused``'s kernel on the
    library ``lib`` and returns x, with a scratch tensor large enough for
    every source this probe builds (the one-warp scratch path took (B, 6,
    n) above n = 256).  A library whose source reads its schedule from
    tensors (``lib.reads_tensors``, bound with ``TENSOR_SCHEDULE``) gets
    ``_schedule``'s tensors, made here, before any launch."""
    n_outer = kb._check_args(Hs, u, A, b, x0, t0=t0, mu=mu, tol=tol,
                             n_outer=n_outer, n_inner=n_inner, n_ls=n_ls)
    strides = kb._kernel_strides(Hs, u, A, b, x0)
    B, k, n = Hs.shape
    dtype, dev = Hs.dtype, Hs.device
    x = torch.empty((B, n), dtype=dtype, device=dev)
    scratch = (torch.empty((B, 6, n), dtype=dtype, device=dev)
               if n > kb._REG_MAX_N else x)
    fn = ("kl_barrier_fused_f32" if dtype == torch.float32
          else "kl_barrier_fused_f64")
    p = _build.ptr
    head = (p(Hs), p(u), p(A), p(b), p(x0), *strides)
    sizes = (B, n, k, n_outer, n_inner, n_ls)
    delta = kb.default_delta(dtype)
    if lib.reads_tensors:
        ts, ls_ts, lognv = kb._schedule(n, dtype, dev, t0=t0, mu=mu,
                                        n_outer=n_outer, beta=beta,
                                        n_ls=n_ls)
        args = (*head, p(ts), p(ls_ts), p(x), p(scratch), *sizes, p(lognv),
                delta, float(alpha))
    else:
        args = (*head, p(x), p(scratch), *sizes, float(t0), float(mu),
                float(beta), delta, float(alpha))

    def launch():
        _build.launch(lib, fn, "probe_k3", dev, *args)
        return x

    return launch


def run(lib, *a, **kw):
    """One launch of ``launcher(lib, *a, **kw)``; returns x."""
    return launcher(lib, *a, **kw)()


def int_bits(t):
    """A float tensor's bit patterns as integers of its width."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def family(B, n, k, seed, dev, dtype):
    """chip_smoke.py's K3 inputs: bench.py's family, its first k rows, from
    its analytic feasible start."""
    H, U = bench_family(B, n, seed)
    return list(primal_args(H[:k], U[:, :k], feasible_points(U, n), dev,
                            dtype))


PROD = dict(mu=55.0, n_inner=3)


def cases(dev):
    """(name, K3 args, options) to check."""
    f32, f64 = torch.float32, torch.float64
    out = [("bench 10000x100 k=2 f32", family(10000, 100, 2, 0, dev, f32),
            PROD),
           ("bench 10000x100 k=1 f32", family(10000, 100, 1, 0, dev, f32),
            PROD),
           ("bench 10000x100 k=2 f64", family(10000, 100, 2, 0, dev, f64),
            PROD),
           ("1000x100 default schedule", family(1000, 100, 2, 3, dev, f32),
            {})]
    for n, B in ((77, 37), (200, 64)):
        for k, dtype in ((2, f32), (1, f64)):
            out.append((f"{B}x{n} k={k} {str(dtype)[6:]}",
                        family(B, n, k, n, dev, dtype), PROD))
    for ls in (dict(n_ls=1), dict(n_ls=40), dict(beta=1.25),
               dict(beta=-0.8)):
        out.append((f"1000x100 {ls}", family(1000, 100, 2, 1100, dev, f32),
                    dict(PROD, **ls)))
    bound_case = family(4, 100, 2, 3, dev, f32)
    bound_case[4] = bound_case[4].clone()
    bound_case[4][2, 40] = 0.0
    out.append(("x0 on a bound n=100", bound_case, PROD))
    # n > 256: every n in f32 and f64, ragged batches, the acceptance
    # table's shapes, f64 past a block's shared memory
    for B, n, k, dtype in ((37, 257, 2, f32), (37, 257, 1, f64),
                           (16, 300, 2, f32), (16, 300, 1, f64),
                           (13, 1000, 1, f32), (1000, 1000, 2, f32),
                           (1000, 1000, 2, f64), (100, 10000, 2, f32),
                           (100, 10000, 1, f64), (10000, 300, 2, f32),
                           (4, 30000, 2, f64)):
        out.append((f"{B}x{n} k={k} {str(dtype)[6:]}",
                    family(B, n, k, n + k, dev, dtype), PROD))
    out.append((f"1000x1000 {dict(beta=1.25)}",
                family(1000, 1000, 2, 7, dev, f32), dict(PROD, beta=1.25)))
    bound_case = family(4, 300, 2, 3, dev, f32)
    bound_case[4] = bound_case[4].clone()
    bound_case[4][2, 40] = 0.0
    out.append(("x0 on a bound n=300", bound_case, PROD))
    return out


# (name, B, n, k, dtype): the shapes timed, bench.py's schedule
TIME_CASES = (("100x10000 k=2 f32", 100, 10000, 2, torch.float32),
              ("1000x1000 k=2 f32", 1000, 1000, 2, torch.float32),
              ("10000x300 k=2 f32", 10000, 300, 2, torch.float32),
              ("10000x1000 k=2 f32", 10000, 1000, 2, torch.float32),
              ("1000x1000 k=2 f64", 1000, 1000, 2, torch.float64),
              ("100x10000 k=2 f64", 100, 10000, 2, torch.float64),
              ("10000x100 k=2 f32 (register path)", 10000, 100, 2,
               torch.float32))


def check(libs, srcs, dev):
    """Holds every build to what it is held to; returns whether all held."""
    all_ok = True
    for cname, a, kw in cases(dev):
        B, _, n = a[0].shape
        size = a[0].element_size()
        xp, cand = kb.kl_barrier_fused_plain(*a, count_candidates=True, **kw)
        ref = run(libs["committed"], *a, **kw)
        parent = run(libs["baseline"], *a, **kw) if "baseline" in libs \
            else ref
        torch.cuda.synchronize()
        tol = K3_TOL if a[0].dtype == torch.float32 else K3_F64_TOL
        dx = float((ref - xp).nan_to_num().abs().max())
        nan_ok = torch.equal(torch.isnan(ref), torch.isnan(xp))
        ok = nan_ok and dx <= tol
        if cname.startswith("x0 on a bound"):
            ok = ok and torch.equal(ref[2], a[4][2]) and bool(
                torch.isfinite(ref).all())
        all_ok &= ok
        steps = kb.fused_n_outer(a[0].shape[1] + n, mu=kw.get("mu", 30.0)) \
            * kw.get("n_inner", 8)
        line = [f"{cname}: path {kb.path_of(n, B, a[0].dtype)}; committed - "
                f"plain max|dx| {dx:.3e} (tol {tol:g}, NaN same {nan_ok})"
                f"{'' if ok else ' FAILS'}, candidates/step "
                f"{float(cand.double().mean()) / steps:.4f}"]
        for name, lib in libs.items():
            held, takes = srcs[name][1], srcs[name][2]
            if name == "committed" or (takes and not takes(n, size)):
                continue
            got = parent if name == "baseline" else run(lib, *a, **kw)
            if held == "register":
                if n > kb._REG_MAX_N:
                    e = float((got - xp).nan_to_num().abs().max())
                    line.append(f"{name} - plain {e:.3e}")
                    continue
                same = same_bits(got, ref)
            elif held == "same" and name == "baseline":
                same = torch.equal(int_bits(got), int_bits(ref))
            elif held == "same":
                same = same_bits(got, parent)
            else:                      # "plain"
                e = float((got - xp).nan_to_num().abs().max())
                same = e <= tol and torch.equal(torch.isnan(got),
                                                torch.isnan(xp))
                line.append(f"{name} - plain {e:.3e}"
                            f"{'' if same else ' FAILS'}")
                all_ok &= same
                continue
            all_ok &= same
            line.append(f"{name} {'same bits' if same else 'DIFFERS'}")
        say(" | ".join(line))
    return all_ok


def time_cases(libs, srcs, dev, smi, plain):
    for cname, B, n, k, dtype in TIME_CASES:
        a = family(B, n, k, 0, dev, dtype)
        size = a[0].element_size()
        fns = {name: launcher(lib, *a, **PROD)
               for name, lib in libs.items()
               if not (srcs[name][2] and not srcs[name][2](n, size))}
        if plain:
            fns["plain"] = lambda: kb.kl_barrier_fused_plain(*a, **PROD)
        first = {}
        for name, fn in fns.items():       # clocks up, and the reps
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            first[name] = time.perf_counter() - t0
        reps = {name: max(2, min(50, math.ceil(0.05 / s)))
                for name, s in first.items()}
        runs = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps[name]):
                fns[name]()
            stop.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(stop) / reps[name])
        xk = run(libs["committed"], *a, **PROD)
        _, cand = kb.kl_barrier_fused_plain(*a, count_candidates=True,
                                            **PROD)
        steps = kb.fused_n_outer(k + n, mu=PROD["mu"]) * PROD["n_inner"]
        ops = k3_ops(k, n, B, steps, int(cand.sum()))
        bms, by = bound(bytes_in(*a) + bytes_out(xk),
                        **{"ops32" if dtype == torch.float32 else "ops64":
                           ops})
        say(json.dumps({"case": cname, "card": smi,
                        "path": str(kb.path_of(n, B, dtype)), "ms": runs,
                        "bound_ms": bms, "bound_by": by}))
        say(f"time {cname}: " + ", ".join(
            f"{name} {min(v):.4f}" for name, v in runs.items())
            + f"; bound {bms:.5f} ({by})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier kl_barrier.cu")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="with --time, also time the plain version")
    ap.add_argument("--only", default=DEFAULT,
                    help="variants to build beside committed and baseline")
    ap.add_argument("--out", type=Path, default=BUILD,
                    help="directory for nvcc's reports and the log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k3: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    t0 = time.perf_counter()
    srcs = sources(args.baseline,
                   [v for v in args.only.split(",") if v])
    libs = build({name: s[0] for name, s in srcs.items()}, args.out,
                 "kl_barrier.cu",
                 lambda name, report: parse_ptxas(report, KERNELS))
    for name, lib in libs.items():
        lib.reads_tensors = reads_tensors(srcs[name][0])
        if lib.reads_tensors:
            for fn in ("kl_barrier_fused_f32", "kl_barrier_fused_f64"):
                getattr(lib, fn).argtypes = TENSOR_SCHEDULE
    say(f"build {time.perf_counter() - t0:.1f} s ({len(libs)} variants)")
    if len(libs) < len(srcs):
        write_log(args.out)
        return 1
    try:
        ok = check(libs, srcs, dev)
        say(f"every check held: {ok}")
        if args.time:
            time_cases(libs, srcs, dev, smi, args.plain)
    finally:
        write_log(args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
