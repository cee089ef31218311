"""Variants of K1 and K2 (``cvx_tpu_torch/ops/csrc/kl_dual.cu``) on one
NVIDIA GPU: registers, bits, agreement and times.

Builds the committed source, an earlier copy if one is given, and
text-substituted variants of the committed source, each with
``_build.NVCC_FLAGS`` plus ``-Xptxas -v``, one nvcc each, all started
together, into ``_probe/build`` (gitignored).  Variants: ``inline``
(``newton_z`` and ``newton_group`` inlined: nvcc 12.9 miscompiles an
inlined ``newton_z`` in K2); of the held path, ``dim4`` (held up to dual
dim 4 only), ``copy0`` / ``copy16`` (``newton_z``'s register copies of w
and z), ``W1`` / ``W2`` / ``W8`` (``kWarpsPerBlock``), ``M6`` / ``M8`` /
``K2M6`` / ``K2M8`` (a second ``__launch_bounds__`` argument on both
held kernels or on K2's); of the group path, ``GB1`` / ``GB8``
(``kGroupBlockWarps``), ``NC2`` / ``NC8`` (``kGroupNC``: G twice or half
as large), ``G8`` (``kGroupMaxWarps`` = 8), ``F512`` / ``F2048``
(``kGroupFillWarps``), ``WS5`` / ``WS9`` (``kWarpSolveMinDim``:
solve_small in every lane of warp 0 below it), ``ONE0`` (no instance for
one-warp groups: f32 at the narrow dims runs the 128-register kernel at
G = 1 too) and ``OMB4`` (that instance at 4 blocks an SM, 128 registers),
``nowarploop`` (K1 f64 on the group path at every shape), ``TB1`` /
``TB16`` (one block an SM at every wide dim / two up to dim 16),
``CT4`` (lanes compensate past 4 terms) and ``nokahan`` (never); and the
time-only ``nobfly`` (warp butterflies
cut out) and ``nosolve`` (the small solve replaced by the Jacobi
direction), whose results are wrong and only their times are read.  A
variant whose text is not in the source is skipped.  A probe build keeps
only the dual dims of ``--dims`` so that a round stays short.

Prints the registers, spill and stack of every kernel instance and of
every ``newton_z`` / ``newton_group`` behind its call boundary.  On every
case of ``chip_smoke.dual_cases`` and each of K1 f32, K2 and K1 f64
(``kl_dual.path_of`` names the path): a held or warp-loop case must
give the baseline's bits (else the committed kernel's) on every output;
a group-path case is held to the plain version by ``_bench.k1_agreement``
/ ``k2_agreement`` at the tolerances of ``chip_smoke.py``.  Exit code 1
if the committed source fails either.  With ``--time``: K1 f32, K2 and K1
f64 on the shapes of ``time_cases`` with CUDA events, in turns (forward,
then backward), each with its bound (``_bench.bound``); with ``--plain``
also the plain versions (three calls each).  With ``--sass``: the SASS instructions of the Newton
step loop of K1 f32 at dim 3 in the committed and baseline builds
(``cuobjdump -sass``).

    python3 probe_k12.py [--baseline OLD.cu] [--time [--plain]] [--sass] [--dims 3,4] [--only a,b] [--out DIR]

The baseline is any earlier version of ``kl_dual.cu`` with the same C
interface, e.g. ``git show <commit>:cvx_tpu_torch/ops/csrc/kl_dual.cu``.
Needs a CUDA device and nvcc; writes nvcc's full reports to
``DIR/ptxas_<variant>.txt`` (default ``_probe/build``) and its whole log
to ``DIR/log.txt``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import torch

from chip_smoke import bench_family, dual_cases, random_family
from cvx_tpu_torch._bench import (K1_DZ, K1_F64_DZ, K1_F64_TOL, K1_TOL,
                                  bound, bytes_in, bytes_out,
                                  k1_agreement, k1_ops_per_coord,
                                  k2_agreement, k2_ops64_per_coord)
from cvx_tpu_torch.ops import _build
from cvx_tpu_torch.ops import kl_dual as kd
from probe_common import BUILD, build, card, parse_ptxas, same_bits, \
    sass_loops, say, write_log

ROOT = Path(__file__).resolve().parent
CASE = re.compile(r"KL_K[12]_CASE\((\d+)\)")
SCHEDULE = dict(n_steps=16, z0=1e-3, n_ls=5)
# variants whose results are wrong: only their times are read
TIME_ONLY = ("nobfly", "nosolve")
# ptxas's kernel instances and the functions behind a call boundary
# ("K1 f dim=3 NC=4", "K1 f dim=9 group", "newton_z f dim=3 NC=4 lp=d",
# ...); a newton_z / newton_group has no register count of its own
KERNELS = ((r"kl_dual_kernelILi(\d+)ELi(\d+)E([fd])",
            lambda m: f"K1 {m[3]} dim={m[1]} NC={m[2]}"),
           (r"kl_dual_cert_kernelILi(\d+)ELi(\d+)EE",
            lambda m: f"K2 dim={m[1]} NC={m[2]}"),
           (r"newton_zILi(\d+)ELi(\d+)E([fd])f?([fd])",
            lambda m: f"newton_z {m[3]} dim={m[1]} NC={m[2]} lp={m[4]}"),
           (r"kl_dual_group_kernelILi(\d+)E([fd])Lb([01])E",
            lambda m: f"K1 {m[2]} dim={m[1]} group"
                      + (" one-warp" if m[3] == "1" else "")),
           (r"kl_dual_cert_group_kernelILi(\d+)ELb([01])E",
            lambda m: f"K2 dim={m[1]} group"
                      + (" one-warp" if m[2] == "1" else "")),
           (r"newton_groupILi(\d+)E([fd])[fd]([fd])",
            lambda m: f"newton_group {m[2]} dim={m[1]} lp={m[3]}"),
           # an earlier source: no NC parameter
           (r"kl_dual_kernelILi(\d+)E([fd])",
            lambda m: f"K1 {m[2]} dim={m[1]}"),
           (r"kl_dual_cert_kernelILi(\d+)EE", lambda m: f"K2 dim={m[1]}"),
           (r"newton_zILi(\d+)E([fd])f?([fd])",
            lambda m: f"newton_z {m[2]} dim={m[1]} lp={m[3]}"))


def variants(baseline, dims, only):
    src = (ROOT / "cvx_tpu_torch/ops/csrc/kl_dual.cu").read_text()
    out = {"committed": src}
    if baseline:
        out["baseline"] = Path(baseline).read_text()
    subs = {
        "inline": [("__device__ __noinline__ void newton_",
                    "__device__ __forceinline__ void newton_")],
        "dim4": [("constexpr int kHeldMaxDim = 8;",
                  "constexpr int kHeldMaxDim = 4;")],
        "nobfly": [("for (int o = 16; o > 0; o >>= 1)",
                    "for (int o = 16; o > 16; o >>= 1)")],
        "nokahan": [("constexpr int kGroupCompTerms = 8;",
                     "constexpr int kGroupCompTerms = 1 << 30;")],
        "CT4": [("constexpr int kGroupCompTerms = 8;",
                 "constexpr int kGroupCompTerms = 4;")],
        "G8": [("constexpr int kGroupMaxWarps = 16;",
                "constexpr int kGroupMaxWarps = 8;")]}
    for d in (0, 16):
        subs[f"copy{d}"] = [("constexpr int kCopyMaxDim = 5;",
                             f"constexpr int kCopyMaxDim = {d};")]
    for w in (1, 2, 8):
        subs[f"W{w}"] = [("constexpr int kWarpsPerBlock = 4;",
                          f"constexpr int kWarpsPerBlock = {w};")]
    for w in (1, 8):
        subs[f"GB{w}"] = [("constexpr int kGroupBlockWarps = 4;",
                           f"constexpr int kGroupBlockWarps = {w};")]
    for c in (2, 8):
        subs[f"NC{c}"] = [("constexpr int kGroupNC = 4;",
                           f"constexpr int kGroupNC = {c};")]
    for f in (512, 2048):
        subs[f"F{f}"] = [("constexpr int kGroupFillWarps = 1024;",
                          f"constexpr int kGroupFillWarps = {f};")]
    for d in (5, 9):
        subs[f"WS{d}"] = [("constexpr int kWarpSolveMinDim = 4;",
                           f"constexpr int kWarpSolveMinDim = {d};")]
    subs["ONE0"] = [("constexpr int kGroupOneMaxDim = 4;",
                     "constexpr int kGroupOneMaxDim = 0;")]
    subs["OMB4"] = [("constexpr int kGroupOneMinBlocks = 8;",
                     "constexpr int kGroupOneMinBlocks = 4;")]
    subs["nowarploop"] = [("constexpr int kWarpLoopMaxDimF64 = 4;",
                           "constexpr int kWarpLoopMaxDimF64 = 0;")]
    subs["TB1"] = [("constexpr int kGroupTwoBlocksK1 = 12;",
                    "constexpr int kGroupTwoBlocksK1 = 0;"),
                   ("constexpr int kGroupTwoBlocksK2 = 9;",
                    "constexpr int kGroupTwoBlocksK2 = 0;")]
    subs["TB16"] = [("constexpr int kGroupTwoBlocksK1 = 12;",
                     "constexpr int kGroupTwoBlocksK1 = 16;"),
                    ("constexpr int kGroupTwoBlocksK2 = 9;",
                     "constexpr int kGroupTwoBlocksK2 = 16;")]
    for name, pairs in subs.items():
        if all(old in src for old, _ in pairs):
            v = src
            for old, new in pairs:
                v = v.replace(old, new)
            out[name] = v
    bounds = "__launch_bounds__(kWarpsPerBlock * 32)"
    if src.count(bounds) == 2:       # the held K1's, then K2's
        for m in (6, 8):
            out[f"M{m}"] = src.replace(bounds, bounds[:-1] + f", {m})")
            k1, k2 = src.split(bounds, 1)
            out[f"K2M{m}"] = k1 + bounds + k2.replace(
                bounds, bounds[:-1] + f", {m})")
    # the small solve replaced by the Jacobi direction (sick everywhere)
    jac = re.sub(r"const bool sick = (solve_small<DIM>\(m, gf, dz\)"
                 r"|M\.solve\(gf, dz\));",
                 "const bool sick = true; for (int j_ = 0; j_ < DIM; ++j_) "
                 "dz[j_] = -gf[j_];", src)
    if jac != src:
        out["nosolve"] = jac
    if only:
        missing = only - set(out)
        if missing:
            say(f"variants not in this source, skipped: {sorted(missing)}")
        out = {k: v for k, v in out.items()
               if k in only or k in ("committed", "baseline")}
    if dims:
        out = {k: CASE.sub(lambda m: m[0] if int(m[1]) in dims else "", v)
               for k, v in out.items()}
    return out


def run_k1(lib, Hs, u, A=None, r=None):
    """``kl_dual_fused`` on the library ``lib``: (x, gap, z)."""
    A, r = kd._check_args("kl_dual_fused", Hs, u, A, r, None,
                          n_steps=SCHEDULE["n_steps"], n_ls=SCHEDULE["n_ls"])
    B, k, n = Hs.shape
    dt, dev = Hs.dtype, Hs.device
    lp = kd._uniform_log_prior(n, dt, dev)
    strides = kd._kernel_args("kl_dual_fused", dt, (Hs, u, A, r), lp, dt)
    x = torch.empty((B, n), dtype=dt, device=dev)
    gap = torch.empty((B,), dtype=dt, device=dev)
    z = torch.empty((B, k + 1 + A.shape[1]), dtype=dt, device=dev)
    p = _build.ptr
    _build.launch(lib, "kl_dual_fused_f32" if dt == torch.float32
                  else "kl_dual_fused_f64", "probe_k12", dev, p(Hs), p(u),
                  p(A), p(r), p(lp), *strides, p(x), p(gap), p(z), B, n, k,
                  A.shape[1], SCHEDULE["n_steps"], SCHEDULE["z0"],
                  SCHEDULE["n_ls"])
    return x, gap, z


def run_k2(lib, Hs, u, A=None, r=None, polish_steps=2):
    """``kl_dual_fused_cert`` on ``lib``: (x, z, gap, ineq_res, eq_res) and
    the leaves (stalled, nan, iters, maxed_out) at the default tolerances."""
    A, r = kd._check_args("kl_dual_fused_cert", Hs, u, A, r, None,
                          n_steps=SCHEDULE["n_steps"], n_ls=SCHEDULE["n_ls"],
                          polish_steps=polish_steps)
    B, k, n = Hs.shape
    dev = Hs.device
    lp = kd._uniform_log_prior(n, torch.float64, dev)
    strides = kd._kernel_args("kl_dual_fused_cert", torch.float32,
                              (Hs, u, A, r), lp, torch.float64)
    f64 = dict(dtype=torch.float64, device=dev)
    x = torch.empty((B, n), **f64)
    z = torch.empty((B, k + 1 + A.shape[1]), **f64)
    gap, ineq, eq, nan = (torch.empty((B,), **f64) for _ in range(4))
    stalled, maxed = (torch.empty((B,), dtype=torch.bool, device=dev)
                      for _ in range(2))
    iters = torch.empty((B,), dtype=torch.int64, device=dev)
    out = (x, z, gap, ineq, eq, stalled, nan, iters, maxed)
    p = _build.ptr
    _build.launch(lib, "kl_dual_fused_cert_f32", "probe_k12", dev, p(Hs),
                  p(u), p(A), p(r), p(lp), *strides, *(p(t) for t in out),
                  B, n, k, A.shape[1], SCHEDULE["n_steps"], SCHEDULE["z0"],
                  SCHEDULE["n_ls"], polish_steps, 1e-8, 1e-7)
    return out


def max_abs(d, lanes):
    return float(d[lanes].abs().max()) if lanes.any() else 0.0


def doubled(args):
    return tuple(None if a is None else a.double() for a in args)


def time_cases(dev):
    """(name, kernels to time, args): the main shape first, then shapes
    either side of the dispatch (n for the held path, dual dim)."""
    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    out = []
    for n in (100, 24, 77, 128, 200):
        H, U = bench_family(10000, n, seed=0)
        out.append((f"10000 x n={n} dim 3",
                    ("K1", "K2", "K1f64") if n in (100, 200)
                    else ("K1", "K2"),
                    (t(H)[None].expand(10000, -1, -1), t(U), None, None)))
    for k, m_eq in ((1, 0), (2, 1), (3, 0), (4, 0), (7, 0), (3, 2), (5, 2),
                    (8, 0), (11, 0), (15, 0)):
        H, U, A, R = random_family(k, m_eq, 100, 10000)
        held = m_eq == 0 and k + 1 <= 8
        out.append((f"10000 x n=100 dim {k + 1 + m_eq} (k = {k}, mE = "
                    f"{m_eq})", ("K1", "K2") if held else ("K1", "K2",
                                                           "K1f64"),
                    (t(H)[None].expand(10000, -1, -1), t(U),
                     t(A)[None].expand(10000, -1, -1) if m_eq else None,
                     t(R.copy()) if m_eq else None)))
    for n, B in ((1000, 1000), (10000, 100)):
        H, U = bench_family(B, n, seed=0)
        out.append((f"{B} x n={n} dim 3", ("K1", "K2", "K1f64"),
                    (t(H)[None].expand(B, -1, -1), t(U), None, None)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier kl_dual.cu")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--plain", action="store_true",
                    help="with --time, also time the plain versions")
    ap.add_argument("--dims", default="2,3,4,5,6,7,8,9,12,16",
                    help="dual dims a probe build keeps ('all' for 2-16)")
    ap.add_argument("--only", default="",
                    help="variants to build beside committed and baseline")
    ap.add_argument("--out", type=Path, default=BUILD,
                    help="directory for nvcc's reports")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k12: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    dims = (None if args.dims == "all"
            else {int(d) for d in args.dims.split(",")})
    t0 = time.perf_counter()
    libs = build(variants(args.baseline, dims,
                          set(args.only.split(",")) - {""}), args.out,
                 "kl_dual.cu", lambda name, report: parse_ptxas(
                     report, KERNELS, ("regs", "spill", "stack")))
    say(f"build {time.perf_counter() - t0:.1f} s ({len(libs)} variants)")
    ref_name = "baseline" if "baseline" in libs else "committed"
    if args.sass:
        for name, key in (("committed", "kl_dual_kernelILi3ELi4EfEE"),
                          ("baseline", "kl_dual_kernelILi3EfEE")):
            if name in libs:
                total, ops = max(sass_loops(BUILD / f"{name}.so", key),
                                 key=lambda loop: loop[0], default=(0, {}))
                say(f"sass {name} K1 f32 dim 3 step loop: {total} "
                    f"instructions {json.dumps(ops)}")

    differing, failing = set(), set()
    for cname, *a in dual_cases(dev):
        k = a[0].shape[1]
        m_eq = a[2].shape[1] if a[2] is not None else 0
        dim, n = k + 1 + m_eq, a[0].shape[2]
        if dims and dim not in dims:
            say(f"{cname}: dim {dim} not built")
            continue
        runs = {"K1": (run_k1, a), "K2": (run_k2, a),
                "K1f64": (run_k1, doubled(a))}
        paths = {kn: kd.path_of(dim, k, m_eq, n, a[0].shape[0],
                                torch.float64 if kn == "K1f64"
                                else torch.float32)
                 for kn in runs}
        plain = {"K1": kd.kl_dual_fused_plain(*a),
                 "K2": kd.kl_dual_fused_cert_plain(*a),
                 "K1f64": kd.kl_dual_fused_plain(*doubled(a))}

        def agree(kname, got):
            if kname == "K2":
                return k2_agreement(got, plain[kname])
            tol = (K1_TOL, K1_DZ) if kname == "K1" else (K1_F64_TOL,
                                                          K1_F64_DZ)
            return k1_agreement(got, plain[kname], *tol)

        refs = {kname: fn(libs[ref_name], *ka)
                for kname, (fn, ka) in runs.items()}
        line = [f"{cname}: paths {paths}"]
        for name, lib in libs.items():
            if name in TIME_ONLY:
                continue
            bits_bad, plain_bad, figs = [], [], []
            for kname, (fn, ka) in runs.items():
                got = fn(lib, *ka)
                if paths[kname] in ("held", "warp loop"):
                    if name != ref_name and not same_bits(got, refs[kname]):
                        dx = (got[0] - refs[kname][0]).nan_to_num().abs()
                        bits_bad.append(f"{kname} (max|dx| "
                                        f"{float(dx.max()):.1e})")
                    continue
                ag = agree(kname, got)
                figs.append(f"{kname} dx {ag['dx']:.1e} dz {ag['dz']:.1e}")
                if not (ag["close"] and ag["dead_same"]):
                    plain_bad.append(f"{kname} {json.dumps(ag)}")
            if name != ref_name:
                if bits_bad:
                    differing.add(name)
                if plain_bad:
                    failing.add(name)
            line.append(
                f"{name} " + ("; ".join(figs) or "same bits")
                + (" DIFFERS on " + ", ".join(bits_bad) if bits_bad else "")
                + (" FAILS " + ", ".join(plain_bad) if plain_bad else ""))
        say(" | ".join(line))
    # the exit code speaks for the committed source; a variant that
    # differs or fails (``inline`` may: nvcc 12.9 miscompiles an inlined
    # newton_z) is only reported
    ok = "committed" not in differing | failing
    say(f"the committed source: held cases the same bits as {ref_name}, "
        f"group-path cases within the plain version's tolerances: {ok}; "
        f"variants that differ on a held case: "
        f"{sorted(differing - {'committed'}) or 'none'}; variants that "
        f"fail a check: {sorted(failing - {'committed'}) or 'none'}")
    if not args.time:
        write_log(args.out)
        return 0 if ok else 1

    for cname, kernels, a in time_cases(dev):
        dim = a[0].shape[1] + 1 + (a[2].shape[1] if a[2] is not None else 0)
        if dims and dim not in dims:
            continue
        for kname in kernels:
            fn, ka = {"K1": (run_k1, a), "K2": (run_k2, a),
                      "K1f64": (run_k1, doubled(a))}[kname]
            fns = {name: (lambda lib=lib: fn(lib, *ka))
                   for name, lib in libs.items()}
            end = time.perf_counter() + 0.5     # clocks up before the turns
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
                for _ in range(30):
                    fns[name]()
                stop.record()
                torch.cuda.synchronize()
                runs[name].append(start.elapsed_time(stop) / 30)
            B, k, n = a[0].shape
            m_eq = a[2].shape[1] if a[2] is not None else 0
            dim = k + 1 + m_eq
            path = kd.path_of(dim, k, m_eq, n, B, torch.float64
                              if kname == "K1f64" else torch.float32)
            # the bound from these inputs and the committed kernel's outputs
            ops = {"ops32" if kname != "K1f64" else "ops64":
                   B * n * k1_ops_per_coord(dim, SCHEDULE["n_steps"])}
            if kname == "K2":
                ops["ops64"] = B * n * k2_ops64_per_coord(dim, k, m_eq)
            bms, by = bound(bytes_in(*ka) + bytes_out(*fns["committed"]()),
                            **ops)
            if args.plain:
                plain = (kd.kl_dual_fused_cert_plain if kname == "K2"
                         else kd.kl_dual_fused_plain)
                runs["plain"] = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    plain(*ka)
                    stop.record()
                    torch.cuda.synchronize()
                    runs["plain"].append(start.elapsed_time(stop))
            say(json.dumps({"case": cname, "kernel": kname, "card": smi,
                            "path": path, "bound_ms": bms, "bound_by": by,
                            "ms": runs}))
            say(f"time {kname} {cname}: " + ", ".join(
                f"{name} {min(v):.4f}" for name, v in runs.items())
                + f"; bound {bms:.5f} ({by})")
    write_log(args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
