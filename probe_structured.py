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
  batch's: one a call of ``structured._woodbury_solver``) and, where the
  tree has ``structured.record_stages``, their split by outer stage, stalled
  instances, and on the card the host wall (median of 5 calls, each
  ending in synchronize()).

Prints one JSON line per route and tree, and on the card the card's name
and power limit.  To compare two commits on one card, unpack the parent
into a gitignored directory and give ``PARENT . . PARENT``.  With
``--profile`` each batched route runs once more under ``torch.profiler``
(host and card), and the ops with the most self device time and the most
self host time are listed, with their counts.

``--stages`` runs instead, in each tree, the Newton steps by outer stage
of the DiagQP batch (``--batch`` instances) and of the instances ``--br``
of phase 4b's ``"BR"`` batch (bench.py's family, 10,000 instances, f64):
a stage's steps per instance are the difference of ``iters`` between runs
cut after s and s - 1 outer stages (``outer_max_iter``; the cut changes no
iterate, only where the loop stops), printed as the per-stage maxima over
the instances (the masked loop runs a stage as long as its slowest
instance), their sum, and the (stage, instance) pairs at ``max_iter``.
``tests/_structured_spin.py`` prints the same table for the reference.
``--br-scan`` lists the longest instances of the whole ``"BR"`` batch.

    python3 probe_structured.py [--device cuda|cpu] [--batch B]
                                [--profile] [TREE ...]
    python3 probe_structured.py --stages --device cpu [--batch 2000]
                                [--br 2478,0,...] [TREE ...]
    python3 probe_structured.py --br-scan [--device cuda] [TREE ...]

The data come from this checkout's recipes (``cvx_tpu_torch/_bench.py``,
loaded by path, so that each tree's own ``cvx_tpu_torch`` is the one
that runs).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from contextlib import nullcontext
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DIAG_TOL = 1e-9      # phase 4c's DiagQP batch
BR_B, BR_N = 10000, 100   # phase 4b's "BR" batch


def recipes():
    """This checkout's data recipes (``cvx_tpu_torch/_bench.py``, which
    imports only numpy and torch), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_bench_recipes", os.path.join(HERE, "cvx_tpu_torch", "_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def br_data(idx, B=BR_B, n=BR_N):
    """Phase 4b's "BR" batch (bench.py's family, numpy seed 0), the
    instances ``idx``: (H (2, n), U (len, 2), X0 (len, n))."""
    rec = recipes()
    H, U = rec.bench_family(B, n, seed=0)
    U = U[list(idx)]
    return H, U, rec.feasible_points(U, n)


def stage_table(iters_by_cut, max_iter):
    """(S + 1, B) cumulative iters -> per-stage maxima, their sum and the
    (stage, instance) pairs at ``max_iter``."""
    import numpy as np

    cum = np.asarray(iters_by_cut)
    per = np.diff(cum, axis=0)                      # (S, B)
    spins = [(int(s) + 1, int(i)) for s, i in zip(*np.nonzero(
        per >= max_iter))]
    maxima = [int(v) for v in per.max(axis=1)]
    return dict(stage_max=maxima, loop_steps=int(sum(maxima)),
                spins=spins, iters_max=int(cum[-1].max()),
                iters_sum=int(cum[-1].sum()))


def cut_runs(run, pars_cut):
    """Cumulative iters of runs cut after 0, 1, 2, ... outer stages, until
    a cut changes nothing."""
    import numpy as np

    full = run(pars_cut(None))
    out = [np.zeros_like(full)]
    s = 1
    while True:
        it = run(pars_cut(s))
        out.append(it)
        if np.array_equal(it, full):
            return out
        s += 1


def stages_tree(tree, device, batch, br):
    """``--stages`` in one tree: the DiagQP batch and the "BR" instances."""
    import numpy as np
    import torch

    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.models import DiagQP
    from cvx_tpu_torch.solvers import SolverParams

    def cut(s, **kw):
        return SolverParams(**kw) if s is None else SolverParams(
            outer_max_iter=s, **kw)

    max_iter = SolverParams().max_iter
    f64 = dict(dtype=torch.float64, device=device)
    if batch:
        c, a, U, ub, x0 = recipes().diagqp_data(batch)
        dq = DiagQP.create(c, a, U, ub, np.ones((1, c.size)), np.ones(1),
                           device=device)
        table = stage_table(cut_runs(
            lambda p: dq.solve_jittable(torch.tensor(x0, **f64), p).iters
            .cpu().numpy(),
            lambda s: cut(s, tol=DIAG_TOL, kkt_method="chol")), max_iter)
        print(json.dumps(dict(pkg="port", tree=tree, family="DiagQP",
                              B=batch, **table)), flush=True)
    if br:
        H, U, X0 = br_data(br)
        prob = DistKL.create(H.shape[1], H=torch.tensor(H, **f64),
                             u=torch.zeros(2, **f64), device=device)
        table = stage_table(cut_runs(
            lambda p: prob.solve_jittable_batch(
                torch.tensor(U, **f64), torch.tensor(X0, **f64),
                method="BR", pars=p).iters.cpu().numpy(), cut), max_iter)
        print(json.dumps(dict(pkg="port", tree=tree, family="BR",
                              instances=br, **table)), flush=True)


def br_scan_tree(tree, device):
    """``--br-scan`` in one tree: the whole "BR" batch (on the CPU in
    chunks of 500: each instance's steps do not depend on its batch), the
    distribution of ``iters`` and the longest instances."""
    import numpy as np
    import torch

    from cvx_tpu_torch import DistKL
    from cvx_tpu_torch.solvers import SolverParams

    chunk = BR_B if device.startswith("cuda") else 500
    H, U, X0 = br_data(range(BR_B))
    f64 = dict(dtype=torch.float64, device=device)
    prob = DistKL.create(BR_N, H=torch.tensor(H, **f64),
                         u=torch.zeros(2, **f64), device=device)
    iters = np.concatenate([prob.solve_jittable_batch(
        torch.tensor(U[i:i + chunk], **f64),
        torch.tensor(X0[i:i + chunk], **f64), method="BR",
        pars=SolverParams()).iters.cpu().numpy()
        for i in range(0, BR_B, chunk)])
    top = np.argsort(-iters, kind="stable")[:8]
    print(json.dumps(dict(pkg="port", tree=tree, family="BR scan",
                          device=device, median=float(np.median(iters)),
                          max=int(iters.max()),
                          over_500=int((iters > 500).sum()),
                          longest=[[int(i), int(iters[i])] for i in top])),
          flush=True)


def run_tree(tree: str, device: str, batch: int, profile: bool) -> None:
    import numpy as np
    import torch

    import cvx_tpu_torch.solvers.structured as structured
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.models import LP, DiagQP

    rec = recipes()
    bench_family, feasible_points = rec.bench_family, rec.feasible_points

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
    c, ad, Ud, ubd, x_ref = rec.diagqp_data(batch, n, k, rng=rng)
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
        # a tree from before record_stages counts the masked loop only
        with getattr(structured, "record_stages", lambda: nullcontext([]))(
                ) as stages:
            sol = fn()
        sync()
        vals = dict(loop_steps=loop_steps[0], iters_max=int(sol.iters.max()),
                    stage_steps=stages[0] if stages else "not recorded",
                    iters_sum=int(sol.iters.sum()),
                    over_max_iter=int((sol.iters >= pars.max_iter).sum()),
                    spun=[int(i) for i in torch.nonzero(
                        sol.iters >= pars.max_iter).flatten()][:50],
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
    ap.add_argument("--stages", action="store_true",
                    help="Newton steps by outer stage (cut runs)")
    ap.add_argument("--br", default="",
                    help="with --stages: instances of the BR batch")
    ap.add_argument("--br-scan", action="store_true",
                    help="the longest instances of the BR batch")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        sys.path.insert(0, os.path.abspath(args.trees[0]))
        if args.stages or args.br_scan:
            import torch
            torch.set_num_threads(1)
        if args.stages:
            stages_tree(args.trees[0], args.device, args.batch,
                        [int(v) for v in args.br.split(",") if v])
        elif args.br_scan:
            br_scan_tree(args.trees[0], args.device)
        else:
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
             "--device", args.device, "--batch", str(args.batch),
             "--br", args.br]
            + [f"--{f}" for f in ("profile", "stages", "br-scan")
               if getattr(args, f.replace("-", "_"))]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
