"""Newton steps and times of the structured barrier's routes
(``cvx_tpu_torch/solvers/structured.py``, BR_fast) for one or more trees.

Each tree given (default: this checkout) runs in a process of its own,
which imports that tree's ``cvx_tpu_torch`` and runs on ``--device``:

* the n = 12 LP of ``tests/test_torch_qp.py::TestStructuredEquality``
  (tol 1e-10, mu 20), stopped after 3, 4, 5, 6 and 8 outer stages and run
  to its end: Newton steps and sum(x) - 1;
* ``TestDiagQP``'s simplex LP (n = 8) and dense-row DiagQP (n = 10) at the
  default parameters: Newton steps and sum(x) - 1;
* three batched routes: ``DistKL.solve_jittable_batch(method="BR_fast")``
  on bench.py's family (B instances, n = 100, k = 2, f64); a DiagQP batch
  (n = 100, k = 4 random rows, one sum-to-one row, tol 1e-9) and a capped
  LP batch (tol 1e-7), as ``chip_smoke.py`` phase 4c draws them: Newton
  steps of the longest instance and in all, the masked loop's steps (the
  batch's: one a call of ``structured._woodbury_solver``), stalled
  instances, and on the card the host wall (median of 5 calls, each
  ending in synchronize()).

Prints one JSON line per route and tree, and on the card the card's name
and power limit.  To compare two commits on one card, unpack the parent
into a gitignored directory and give ``PARENT . . PARENT``.  With
``--profile`` each batched route runs once more under ``torch.profiler``
(host and card), and the ops with the most self device time and the most
self host time are listed, with their counts.

    python3 probe_structured.py [--device cuda|cpu] [--batch B]
                                [--profile] [TREE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def run_tree(tree: str, device: str, batch: int, profile: bool) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import cvx_tpu_torch.solvers.structured as structured
    from chip_smoke import bench_family, feasible_points
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.models import LP, DiagQP

    # one call of the Woodbury factory a step of the masked loop
    loop_steps, woodbury = [0], structured._woodbury_solver

    def counted(*args):
        loop_steps[0] += 1
        return woodbury(*args)

    structured._woodbury_solver = counted

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def emit(route, **vals):
        print(json.dumps({"tree": tree, "route": route, **vals}), flush=True)

    n = 12
    lp = LP(np.linspace(1.0, 2.0, n), A=np.ones((1, n)), b=np.ones(1),
            device=dev)
    for stages in (3, 4, 5, 6, 8, None):
        kw = dict(tol=1e-10, mu=20.0)
        if stages is not None:
            kw["outer_max_iter"] = stages
        sol = lp.solve_jittable(torch.full((n,), 1.0 / n, **f64),
                                SolverParams(**kw))
        emit(f"LP n=12 stages={stages}", iters=int(sol.iters),
             sum_x_minus_1=float(sol.x.sum() - 1.0))
    lp8 = LP(np.linspace(2.0, 1.0, 8), A=np.ones((1, 8)), b=np.ones(1),
             device=dev)
    sol = lp8.solve_jittable(torch.full((8,), 1.0 / 8, **f64))
    emit("simplex LP n=8", iters=int(sol.iters),
         sum_x_minus_1=float(sol.x.sum() - 1.0))
    n = 10
    dq = DiagQP.create(np.linspace(1.0, 3.0, n), -np.ones(n),
                       np.ones((1, n)) * np.linspace(0, 1, n)[None],
                       np.array([10.0]), np.ones((1, n)), np.ones(1),
                       device=dev)
    sol = dq.solve_jittable(torch.full((n,), 1.0 / n, **f64))
    emit("DiagQP n=10", iters=int(sol.iters),
         sum_x_minus_1=float(sol.x.sum() - 1.0))

    # the batched routes
    n = 100
    H, U = bench_family(batch, n, seed=0)
    prob = DistKL.create(n, H=torch.tensor(H, **f64),
                         u=torch.zeros(2, **f64), device=dev)
    Ut = torch.tensor(U, **f64)
    X0 = torch.tensor(feasible_points(U, n), **f64)
    rng = np.random.default_rng(11)
    k = 4
    c = rng.uniform(0.5, 1.5, n)
    Ud = rng.uniform(0.0, 1.0, (k, n))
    x_ref = np.full(n, 1.0 / n)
    ubd = (Ud @ x_ref)[None, :] + rng.uniform(0.1, 0.3, (batch, k))
    ad = rng.standard_normal((batch, n))
    dqb = DiagQP.create(c, ad, Ud, ubd, np.ones((1, n)), np.ones(1),
                        device=dev)
    a_lp = np.linspace(2.0, 1.0, n)[None] + 1e-3 * rng.standard_normal(
        (batch, n))
    cap = np.zeros((1, n)); cap[0, n - 1] = 1.0
    lpb = LP(a_lp, U=cap, ub=rng.uniform(0.2, 0.4, (batch, 1)),
             A=np.ones((1, n)), b=np.ones(1), device=dev)
    x0 = torch.tensor(x_ref, **f64)
    routes = (
        (f"DistKL BR_fast {batch} x n={n}", SolverParams(),
         lambda p: prob.solve_jittable_batch(Ut, X0, method="BR_fast",
                                             pars=p)),
        (f"DiagQP batch {batch} x n={n}, k={k}", SolverParams(tol=1e-9),
         lambda p: dqb.solve_jittable(x0, p)),
        (f"capped LP batch {batch} x n={n}", SolverParams(tol=1e-7),
         lambda p: lpb.solve_jittable(x0, p)),
    )
    for route, pars, solve in routes:
        def fn():
            return solve(pars)

        loop_steps[0] = 0
        sol = fn()
        sync()
        vals = dict(loop_steps=loop_steps[0], iters_max=int(sol.iters.max()),
                    iters_sum=int(sol.iters.sum()),
                    stalled=int(sol.stalled.sum()),
                    max_abs_sum_x_minus_1=float((sol.x.sum(-1) - 1).abs()
                                                .max()))
        if dev.type == "cuda":
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                sync()
                walls.append((time.perf_counter() - t0) * 1e3)
            vals["host_wall_ms"] = statistics.median(walls)
            vals["host_walls_ms"] = walls
        emit(route, **vals)
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as traced

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with traced(activities=acts) as prof:
                sol = solve(pars)
                sync()
            print(f"profile of {route}, {int(sol.iters.max())} steps",
                  flush=True)
            keys = prof.key_averages()
            for sort in (("self_cuda_time_total",) if dev.type == "cuda"
                         else ()) + ("self_cpu_time_total",):
                print(keys.table(sort_by=sort, row_limit=12), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[HERE])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=10000)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_tree(args.trees[0], args.device, args.batch, args.profile)
        return 0
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
    rc = 0
    for tree in args.trees:
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree,
             "--device", args.device, "--batch", str(args.batch)]
            + (["--profile"] if args.profile else [])).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
