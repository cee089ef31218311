"""Variants of K3 (``cvx_tpu_torch/ops/csrc/kl_barrier.cu``) on one NVIDIA
GPU: registers, bits and times.

Builds the committed source and its variants (the line-search chunk
``kLsChunk`` in {1, 2, 4}, with and without ``__launch_bounds__(kThreads,
8)``; ``kWarpsPerBlock`` in {1, 2, 8}), each with ``_build.NVCC_FLAGS``
plus ``-Xptxas -v``, one nvcc each, all started together, into
``_probe/build`` (gitignored); prints the
registers and spills of every template instance; holds every variant, and
the baseline source if one is given, to the committed kernel bit for bit
and to the plain version on bench.py's family and on edge cases; with
``--time`` times them at 10,000 x n = 100 (k = 2 and k = 1 in f32, k = 2
in f64) with CUDA events, in turns (forward, then backward), the committed
and baseline kernels also with the schedule's scalars copied from the
host (``host_schedule``: each copy waits for the stream).

    python3 probe_k3.py [--baseline OLD.cu] [--time] [--out DIR]

The baseline is any earlier version of ``kl_barrier.cu`` with the same C
interface, e.g. ``git show <commit>:cvx_tpu_torch/ops/csrc/kl_barrier.cu``.
Needs a CUDA device and nvcc; writes nvcc's full reports to
``DIR/ptxas_<variant>.txt`` (default ``_probe/build``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from chip_smoke import bench_family, feasible_points, primal_args
from cvx_tpu_torch.ops import _build
from cvx_tpu_torch.ops import kl_barrier as kb

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "_probe" / "build"
SIG = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 7 + [ctypes.c_void_p] * 4
       + [ctypes.c_int] * 6 + [ctypes.c_void_p] + [ctypes.c_double] * 2
       + [ctypes.c_void_p])
CHUNK = re.compile(r"constexpr int kLsChunk = \d+;")
WARPS = re.compile(r"constexpr int kWarpsPerBlock = \d+;")


def variants(baseline):
    src = (ROOT / "cvx_tpu_torch/ops/csrc/kl_barrier.cu").read_text()
    assert len(CHUNK.findall(src)) == 1 and len(WARPS.findall(src)) == 1
    out = {"committed": src}
    if baseline:
        out["baseline"] = Path(baseline).read_text()
    for c in (1, 2, 4):
        for m in (None, 8):
            s = CHUNK.sub(f"constexpr int kLsChunk = {c};", src)
            if m:
                s = s.replace("__launch_bounds__(kThreads)",
                              f"__launch_bounds__(kThreads, {m})")
            out[f"C{c}" + (f"_M{m}" if m else "")] = s
    for w in (1, 2, 8):
        out[f"W{w}"] = WARPS.sub(f"constexpr int kWarpsPerBlock = {w};", src)
    return out


def parse_ptxas(report):
    """{"f k=2 NC=4": {"regs": r, "spill": "stores/loads"}, ...}"""
    res, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\S*kl_barrier_kernelI([fd])"
                      r"Li(\d)ELi(\d+)E", line)
        if m:
            cur = res.setdefault(f"{m[1]} k={m[2]} NC={m[3]}", {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill"] = f"{m[1]}/{m[2]}"
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m[1])
    return res


def build(srcs, out):
    BUILD.mkdir(parents=True, exist_ok=True)
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = BUILD / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(BUILD / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        (out / f"ptxas_{name}.txt").write_text(report)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{report[-4000:]}")
        print("ptxas", name, json.dumps(parse_ptxas(report), sort_keys=True))
        lib = ctypes.CDLL(str(BUILD / f"{name}.so"))
        for fn in ("kl_barrier_fused_f32", "kl_barrier_fused_f64"):
            getattr(lib, fn).argtypes = SIG
            getattr(lib, fn).restype = ctypes.c_int
        lib.kl_barrier_error_string.argtypes = [ctypes.c_int]
        lib.kl_barrier_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.kl_barrier_error_string
        libs[name] = lib
    return libs


def host_schedule(n, dtype, device, *, t0, mu, n_outer, beta, n_ls):
    """``_schedule`` with its scalars copied from the host, each copy
    waiting for the stream, as the wrapper built them before it filled
    them on the device: the same values."""
    def c(v):
        return torch.tensor(v, dtype=dtype, device=device)

    stage = torch.arange(n_outer, device=device).to(dtype)
    ts = t0 * torch.exp(stage * torch.log(c(float(mu))))
    kk = torch.arange(n_ls, device=device)
    expo = torch.where(kk < 32, kk, 32 + 3 * (kk - 32)).to(dtype)
    return ts, torch.pow(c(float(beta)), expo), torch.log(c(float(n)))


def run(lib, Hs, u, A, b, x0, *, t0=1.0, mu=30.0, tol=1e-8, n_outer=None,
        n_inner=8, alpha=0.04, beta=0.8, n_ls=12, schedule=kb._schedule):
    """``kl_barrier_fused`` on the library ``lib``."""
    n_outer = kb._check_args(Hs, u, A, b, x0, t0=t0, mu=mu, tol=tol,
                             n_outer=n_outer, n_inner=n_inner, n_ls=n_ls)
    strides = kb._kernel_strides(Hs, u, A, b, x0)
    B, k, n = Hs.shape
    dtype, dev = Hs.dtype, Hs.device
    ts, ls_ts, lognv = schedule(n, dtype, dev, t0=t0, mu=mu,
                                n_outer=n_outer, beta=beta, n_ls=n_ls)
    x = torch.empty((B, n), dtype=dtype, device=dev)
    scratch = (torch.empty((B, 6, n), dtype=dtype, device=dev)
               if n > kb._REG_MAX_N else x)
    fn = ("kl_barrier_fused_f32" if dtype == torch.float32
          else "kl_barrier_fused_f64")
    p = _build.ptr
    _build.launch(lib, fn, "probe_k3", dev, p(Hs), p(u), p(A), p(b), p(x0),
                  *strides, p(ts), p(ls_ts), p(x), p(scratch), B, n, k,
                  n_outer, n_inner, n_ls, p(lognv), kb.default_delta(dtype),
                  float(alpha))
    return x


def family(B, n, k, seed, dev, dtype):
    """chip_smoke.py's K3 inputs: bench.py's family, its first k rows, from
    its analytic feasible start."""
    H, U = bench_family(B, n, seed)
    return list(primal_args(H[:k], U[:, :k], feasible_points(U, n), dev,
                            dtype))


def same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(a[~na], b[~nb]))


def cases(dev):
    f32, f64 = torch.float32, torch.float64
    prod = dict(mu=55.0, n_inner=3)
    out = [("bench 10000x100 k=2 f32", family(10000, 100, 2, 0, dev, f32),
            prod),
           ("bench 10000x100 k=1 f32", family(10000, 100, 1, 0, dev, f32),
            prod),
           ("bench 10000x100 k=2 f64", family(10000, 100, 2, 0, dev, f64),
            prod),
           ("1000x100 default schedule", family(1000, 100, 2, 3, dev, f32),
            {})]
    for n, B, NC in ((77, 37, 4), (200, 64, 8), (300, 16, 0)):
        for k, dtype in ((2, f32), (1, f64)):
            out.append((f"{B}x{n} k={k} {str(dtype)[6:]} (NC={NC})",
                        family(B, n, k, n, dev, dtype), prod))
    for ls in (dict(n_ls=1), dict(n_ls=40), dict(beta=1.25),
               dict(beta=-0.8)):
        out.append((f"1000x100 {ls}", family(1000, 100, 2, 1100, dev, f32),
                    dict(prod, **ls)))
    bound = family(4, 100, 2, 3, dev, f32)
    bound[4] = bound[4].clone()
    bound[4][2, 40] = 0.0
    out.append(("x0 on a bound", bound, prod))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier kl_barrier.cu")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", type=Path, default=BUILD,
                    help="directory for nvcc's reports")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k3: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build(variants(args.baseline), args.out)
    print(f"build {time.perf_counter() - t0:.1f} s ({len(libs)} variants)")

    all_same = True
    for cname, a, kw in cases(dev):
        xp, cand = kb.kl_barrier_fused_plain(*a, count_candidates=True, **kw)
        ref = run(libs["committed"], *a, **kw)
        steps = kb.fused_n_outer(a[0].shape[1] + a[0].shape[2],
                                 mu=kw.get("mu", 30.0)) * kw.get("n_inner", 8)
        line = [f"{cname}: committed - plain max|dx| "
                f"{float((ref - xp).nan_to_num().abs().max()):.3e}, "
                f"candidates/step {float(cand.double().mean()) / steps:.4f}"]
        for name, lib in libs.items():
            if name != "committed":
                same = same_bits(run(lib, *a, **kw), ref)
                all_same &= same
                line.append(f"{name} {'same bits' if same else 'DIFFERS'}")
        print(" | ".join(line))
    print(f"every variant the same bits as the committed kernel: {all_same}")
    if not args.time:
        return 0 if all_same else 1

    for cname, a, kw in cases(dev)[:3]:
        fns = {name: (lambda lib=lib: run(lib, *a, **kw))
               for name, lib in libs.items()}
        for name in ("committed", "baseline"):
            if name in libs:
                fns[name + "_host_schedule"] = (
                    lambda lib=libs[name]: run(lib, *a, schedule=host_schedule,
                                               **kw))
        end = time.perf_counter() + 1.0      # clocks up before the turns
        while time.perf_counter() < end:
            fns["committed"]()
        torch.cuda.synchronize()
        runs = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            fns[name]()
            torch.cuda.synchronize()
            start.record()
            for _ in range(50):
                fns[name]()
            stop.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(stop) / 50)
        print(json.dumps({"case": cname, "card": smi, "ms": runs}))
        print(f"time {cname}: " + ", ".join(
            f"{name} {min(v):.4f}" for name, v in runs.items()))
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
