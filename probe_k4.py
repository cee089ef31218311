"""Variants of K4 (``cvx_tpu_torch/ops/csrc/chol.cu``) on one NVIDIA GPU:
registers, SASS, checks and times.

Builds the committed source, an earlier copy if one is given, and
text-substituted variants of the committed source, each with
``_build.NVCC_FLAGS`` plus ``-Xptxas -v``, one nvcc each, all started
together, into ``_probe/build`` (gitignored):

* ``nofma``: the held path's update as a multiply and an addition (two
  roundings under ``--fmad=false``) instead of one fma;
* ``rs2``: the row factor left unscaled and the column factor scaled by
  rs * rs (one multiply fewer per row and column, other roundings);
* ``lb4``: ``__launch_bounds__(256, 4)`` on the held kernel (64 registers);
* ``panel``: every n on the panel path;
* the panel path's shapes (the committed: bk = 32, register tiles of 4
  slabs x 4 columns, a ring of 3 tiles, registers for 2 blocks an SM):
  ``bk64`` (column blocks of 64, tiles of 4 x 8), ``tile84`` (8 x 4),
  ``tile84_1blk`` (8 x 4, registers for 1 block an SM), ``tile48`` (4 x
  8) and ``ring4`` (a ring of 4);
  ``elemcopy``: L's tiles copied element by element at every n (the
  committed source copies 16 bytes at a time where n allows);
  ``oneslab``: the update's product as one body of kTm slabs a chunk,
  the chunk's empty slabs skipped by runtime tests (the committed source
  compiles a body for each slab count);
* ``nosync``: the held path's barrier per column cut out, so that its
  results are wrong and only its time is read: what the barriers and the
  column chain's latency cost;
* time-only, what each step of the panel path costs: ``noproduct`` (the
  update's fmas cut out, and with them its shared loads: the copies and
  barriers remain), ``nodiag`` (the diagonal tile's factor cut out) and
  ``nosolve`` (the rows' solve cut out);
* time-only, what each step of the first baseline's panel kernel cost (a
  right-looking factor, the first panel design): ``parent_notrail`` (its
  trailing update cut out) and ``parent_norank1`` (its in-block rank-1
  updates cut out).

Prints the registers, spill and shared memory of every kernel instance;
holds every variant but the time-only ones to the plain version with
``chip_smoke.compare_k4``'s checks (NaN pattern, max |dL|, backward error
against ``torch.linalg.cholesky``'s, upper triangle 0) on every case of
``chip_smoke.k4_cases``, and on the held path's cases (n <= 192) the
committed source to the first baseline bit for bit; with ``--sass`` lists
the loops of the SASS (``cuobjdump -sass``: each backward branch, its
static instructions and their opcodes) of the f32 panel kernels (committed
and baseline) and of the held kernel at n = 100; with ``--time`` times
every variant, the baseline and ``torch.linalg.cholesky_ex`` with CUDA
events in turns (forward, then backward) at 4096 x 100 and 4096 x 128
(f32, f64), either side of the held path's limits (f32 4096 x 129 / 144 /
160 / 176 / 192 / 193, f64 4096 x 144 / 192 / 193) and at the sweep's
panel shapes 1024 x 256 and 256 x 512 (f32 and f64).

    python3 probe_k4.py [--baseline OLD.cu ...] [--time] [--sass] [--out DIR]

A baseline is any earlier version of ``chol.cu`` with the same C
interface, e.g. ``git show <commit>:cvx_tpu_torch/ops/csrc/chol.cu``;
the first is named ``baseline``, the next ``baseline_2`` and so on.
Needs a CUDA device and nvcc; writes nvcc's reports to
``DIR/ptxas_<variant>.txt`` and the whole log to ``DIR/log.txt`` (default
``_probe/build``).  Exit code 1 if the committed source fails a check or
differs from the first baseline in a bit on a held-path case.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

import torch

from chip_smoke import compare_k4, k4_cases, spd_batch
from cvx_tpu_torch.ops import _build
from cvx_tpu_torch.ops.chol import cholesky_batched_plain
from probe_common import BUILD, build, card, parse_ptxas, sass_loops, say, \
    write_log

ROOT = Path(__file__).resolve().parent
TIME_ONLY = ("nosync", "noproduct", "nodiag", "nosolve", "parent_notrail",
             "parent_norank1")
# ptxas's kernel instances: "held f G=7", "panel f left-looking", ...
KERNELS = ((r"chol_held_kernelI([fd])Li(\d+)E",
            lambda m: f"held {m[1]} G={m[2]}"),
           (r"chol_panel_kernelI([fd])Lb([01])E",
            lambda m: f"panel {m[1]} left-looking"
                      f"{' 16-byte copies' if m[2] == '1' else ''}"),
           (r"chol_kernelI([fd])E", lambda m: f"panel {m[1]}"))


def substitute(src, old, new):
    assert src.count(old) == 1, old
    return src.replace(old, new)


def variants(baseline):
    src = (ROOT / "cvx_tpu_torch/ops/csrc/chol.cu").read_text()
    out = {"committed": src}
    for k, path in enumerate(baseline or ()):
        out["baseline" + (f"_{k + 1}" if k else "")] = Path(path).read_text()
    out["nofma"] = substitute(substitute(src, "return fmaf(a, b, c);",
                                         "return a * b + c;"),
                              "return fma(a, b, c);", "return a * b + c;")
    rs2 = substitute(src, "const T rs = rsq[j];",
                     "const T rs = rsq[j], rs2 = rs * rs;")
    rs2 = substitute(rs2, "lr[i] = cj[ty + kSide * i] * rs;",
                     "lr[i] = cj[ty + kSide * i];")
    rs2 = substitute(rs2, "cj[tx + kSide * G0] * rs;",
                     "cj[tx + kSide * G0] * rs2;")
    out["rs2"] = substitute(rs2, "cj[tx + kSide * s] * rs;",
                            "cj[tx + kSide * s] * rs2;")
    out["lb4"] = substitute(src, "__launch_bounds__(kSide * kSide)",
                            "__launch_bounds__(kSide * kSide, 4)")
    out["panel"] = re.sub(r"constexpr int kHeldMaxN(F64)? = \d+;",
                          r"constexpr int kHeldMaxN\1 = 0;", src)
    def shape(bk=32, tm=4, tn=4, stages=3, blocks=2):
        v = src
        for key, val in (("kBk", bk), ("kTm", tm), ("kTn", tn),
                         ("kStages", stages), ("kMinBlocks", blocks)):
            v = re.sub(rf"constexpr int {key} = \d+;",
                       f"constexpr int {key} = {val};", v)
        return v
    out["bk64"] = shape(bk=64, tn=8)
    out["tile84"] = shape(tm=8)
    out["tile84_1blk"] = shape(tm=8, blocks=1)
    out["tile48"] = shape(tn=8)
    out["ring4"] = shape(stages=4)
    out["elemcopy"] = substitute(src, "const bool vec = n %",
                                 "const bool vec = false && n %")
    out["oneslab"] = substitute(src, "update_slabs<T, VL, kTm>(sc, stage,",
                                "update_chunk<T, VL, kTm>(sc, stage,")
    loop_sync = "    __syncthreads();\n    T* t = cj;"
    out["nosync"] = substitute(src, loop_sync,
                               loop_sync.replace("__syncthreads();", ""))
    out["noproduct"] = substitute(
        src, "acc[i][j] = kfma(ra[i][v], rb[j][v], acc[i][j]);", ";")
    out["nodiag"] = substitute(src, "if (tid < 32) factor_diag",
                               "if (tid < 0) factor_diag")
    out["nosolve"] = substitute(src, "if (r < rows) solve_row",
                                "if (r < 0) solve_row")
    if "baseline" in out:     # the first, right-looking panel kernel
        old = out["baseline"]
        for name, loop in (("parent_notrail", "e < mt * mt;"),
                           ("parent_norank1", "e < mr * wr;")):
            if old.count(loop) == 1:
                out[name] = old.replace(loop, "e < 0;")
    return out


def panel_smem(src, f64):
    """Dynamic shared memory of the panel kernel, bytes, from the source's
    constants (``Panel<T, kBk, kTm, kTn>::smem()``)."""
    c = {m[1]: int(m[2]) for m in
         re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    size = 8 if f64 else 4
    vec, kt = 16 // size, 8 if f64 else 16
    rows = c["kThreads"] // (c["kBk"] // c["kTn"]) * c["kTm"]
    stage = (rows + c["kBk"]) * (kt + vec)
    return (c["kStages"] * stage + rows * (c["kBk"] + 1) + c["kBk"] ** 2
            + c["kBk"]) * size


def blocks_per_sm(rec, threads=256):
    """Blocks of ``threads`` one SM holds by registers (65,536, allocated
    in units of 8 a thread) and shared memory (233,472 bytes, 1 KB of it
    reserved a block)."""
    regs = -(-rec["regs"] // 8) * 8
    smem = rec["smem"] + rec["dyn_smem"]
    return min(65536 // (regs * threads), 233472 // (smem + 1024), 8)


def ptxas_table(srcs, name, report):
    """``parse_ptxas`` of variant ``name``, and for the panel kernels their
    dynamic shared memory and blocks an SM."""
    res = parse_ptxas(report, KERNELS, ("regs", "spill", "smem"))
    for label, rec in res.items():
        if "left-looking" in label:
            rec["dyn_smem"] = panel_smem(src=srcs[name],
                                         f64=label.startswith("panel d"))
            rec["blocks_per_sm"] = blocks_per_sm(rec)
    return res


def run(lib, X):
    """``cholesky_batched_cuda`` on the library ``lib``."""
    B, n, _ = X.shape
    L = torch.empty((B, n, n), dtype=X.dtype, device=X.device)
    fn = "chol_batched_f32" if X.dtype == torch.float32 else "chol_batched_f64"
    _build.launch(lib, fn, "probe_k4", X.device, _build.ptr(X), X.stride(0),
                  X.stride(1), _build.ptr(L), B, n)
    return L


def check(libs, dev):
    """Every variant but the time-only ones on every phase-3 case, and the
    committed source against the first baseline bit for bit on the held
    path's; returns the names of those that failed a check ("committed"
    also where a held case's bits differ)."""
    from cvx_tpu_torch.ops.chol import held_max_n

    failed = set()
    for cname, X in k4_cases(dev):
        line = [cname]
        if "baseline" in libs and X.shape[-1] <= held_max_n(X.dtype):
            same = torch.equal(run(libs["committed"], X).view(torch.uint8),
                               run(libs["baseline"], X).view(torch.uint8))
            line.append(f"held path: same bits as the baseline {same}")
            if not same:
                failed.add("committed")
        for name, lib in libs.items():
            if name in TIME_ONLY:
                continue
            try:
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    dL = compare_k4(cname, X, lambda x, lib=lib: run(lib, x),
                                    cholesky_batched_plain)
                rk = re.search(r"kernel (\S+), torch\S* (\S+)",
                               buf.getvalue())
                line.append(f"{name} ok (dL {dL:.2e}, backward "
                            f"{rk[1]} vs {rk[2]})" if name == "committed"
                            else f"{name} ok ({dL:.1e})")
            except RuntimeError as e:
                failed.add(name)
                line.append(f"{name} FAILED ({str(e)[20:]})")
        say(" | ".join(line))
    return failed


def time_all(libs, dev, smi):
    shapes = [(4096, 100, torch.float32), (4096, 128, torch.float32),
              (4096, 100, torch.float64), (4096, 128, torch.float64),
              (4096, 129, torch.float32), (4096, 144, torch.float32),
              (4096, 160, torch.float32), (4096, 176, torch.float32),
              (4096, 192, torch.float32), (4096, 193, torch.float32),
              (4096, 144, torch.float64), (4096, 192, torch.float64),
              (4096, 193, torch.float64),
              (1024, 256, torch.float32), (256, 512, torch.float32),
              (1024, 256, torch.float64), (256, 512, torch.float64)]
    for B, n, dtype in shapes:
        X = spd_batch(B, n, dtype, dev, seed=B + n)
        fns = {name: (lambda lib=lib: run(lib, X))
               for name, lib in libs.items()}
        fns["cholesky_ex"] = lambda: torch.linalg.cholesky_ex(X)
        end = time.perf_counter() + 0.5       # clocks up before the turns
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
            for _ in range(20):
                fns[name]()
            stop.record()
            torch.cuda.synchronize()
            runs[name].append(start.elapsed_time(stop) / 20)
        shape = f"{str(dtype)[6:]} {B} x {n}"
        say(json.dumps({"shape": shape, "card": smi, "ms": runs}))
        say(f"time {shape}: " + ", ".join(
            f"{name} {min(v):.4f}" for name, v in runs.items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", nargs="+", help="earlier chol.cu files")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out", type=Path, default=BUILD,
                    help="directory for nvcc's reports and the log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k4: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    srcs = variants(args.baseline)
    libs = build(srcs, args.out, "chol.cu",
                 lambda name, report: ptxas_table(srcs, name, report))
    say(f"build {time.perf_counter() - t0:.1f} s ({len(libs)} variants)")
    if args.sass:
        for name, key in (("committed", "chol_held_kernelIfLi7E"),
                          ("committed", "chol_panel_kernelIf"),
                          ("baseline", "chol_kernelIfE")):
            if name in libs:
                for size, ops in sass_loops(BUILD / f"{name}.so", key,
                                            args.out / f"sass_{name}_{key}"
                                            ".txt"):
                    say(f"sass {name} {key} loop: {size} instructions "
                        f"{json.dumps(ops)}")
    failed = check(libs, dev)
    ok = "committed" in libs and "committed" not in failed
    say(f"the committed source passes every check: {ok}; variants that "
        f"fail: {sorted(failed - {'committed'}) or 'none'}")
    if args.time:
        time_all(libs, dev, smi)
    write_log(args.out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
