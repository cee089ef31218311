"""Shared by the benchmark's CPU tests: a cell at a size a test run can
hold, and one run of it on the CPU (the program's plain versions)."""

import time

import torch

from benchmark import harness, spec

# batch a cell keeps on the CPU: its n and rows stay as configured
SMALL_BATCH = {"kl_n100_b10k": 32, "kl_n10000_b100": 2}


def small_cell(workload, root=None):
    cell = spec.load(workload, root)
    cfg = next(name for name in SMALL_BATCH if workload.startswith(name))
    cell.config["batch"] = SMALL_BATCH[cfg]
    cell.mix["pool"] = 2
    cell.mix["warm_rounds"] = 1
    cell.mix["sample_calls"] = 2
    return cell


def cpu_run(cell, traced=False, seed=2**33 + 17, seconds=0.2):
    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter())


TOY_FAMILY = '''"""A family that is not KL, for the harness's tests: y = v w / 3 for a
batch of rows v and a shared w.  In a cell of several ranks each rank
computes its share of the rows (rank r the rows r, r + R, ...) and the
program's block mesh sums the shares (one all-reduce a call), so every
rank returns the whole y.

``compare`` returns ``y_err`` (max |y - v w / 3|, a float) and ``wrong``
(the rows with any difference, a count).  A configuration's ``fault``
plants one on one rank: ``{"rank": r, "add": e}`` adds e to its y,
``{"rank": r, "exit_at": c}`` kills the rank at its first model's c-th
call, saying when on standard error.
"""

import math
import os
import signal
import sys
import time

import torch


def make_inputs(config, mix, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, B = config["n"], config["batch"]
    w = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    pool = [{"v": torch.rand((B, n), generator=gen, dtype=torch.float64,
                             device=device)} for _ in range(mix["pool"])]
    return w, pool


def make_model(config, H, world=None):
    mesh = None
    if world is not None:
        from cvx_tpu_torch.parallel.mesh import block_mesh

        mesh = block_mesh(world.size, device=world.device)
    return {"w": H, "mesh": mesh, "rank": world.rank if world else 0,
            "calls": 0, "fault": config.get("fault", {})}


def call(model, mix, batch):
    model["calls"] += 1
    fault, mesh = model["fault"], model["mesh"]
    planted = fault.get("rank") == model["rank"]
    if planted and model["calls"] == fault.get("exit_at"):
        print(f"toy: rank {model['rank']} killed at {time.time()!r}",
              file=sys.stderr, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    y = batch["v"] * model["w"] / 3
    if mesh is not None:
        share = torch.zeros_like(y)
        share[mesh.rank::mesh.size] = y[mesh.rank::mesh.size]
        y = mesh.sum(share)
    return y + fault["add"] if planted and "add" in fault else y


def outputs(y):
    return {"y": y}


def failed(out):
    return torch.zeros(out["y"].shape[0], dtype=torch.bool,
                       device=out["y"].device)


def reference(H, batch):
    return batch["v"] * H / 3


def compare(H, batch, out, ref, mix):
    d = torch.nan_to_num((out["y"].double() - ref).abs(), nan=math.inf)
    return {"y_err": float(d.max()), "wrong": int((d != 0).any(-1).sum())}


def control(H, batch, mix, precision):
    dt = getattr(torch, precision)
    return {"y": (batch["v"].to(dt) * H.to(dt) / 3).double()}
'''

TOY_SPANS = '''"""The calls in the traced slice of ``benchmark/spans.py``."""

from benchmark import spans


def read(run):
    got = spans.read(run)
    return float(got.calls) if got is not None else None
'''


def toy_benchmark(root):
    """A copy of the benchmark under ``root`` with the toy family as new
    files and entries: its configuration ``toy`` and cells ``toy.r1``,
    ``toy.r2`` and ``toy.r4`` on 1, 2 and 4 ranks, and a per-layer metric
    ``toy.spans_calls``."""
    import json
    import shutil
    from pathlib import Path

    repo = Path(__file__).resolve().parents[2]
    root = Path(root)
    shutil.copy(repo / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(repo / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "benchmark"
    (here / "families" / "toy_rows.py").write_text(TOY_FAMILY)
    (here / "metrics" / "toy.spans_calls.py").write_text(TOY_SPANS)
    (here / "configs" / "toy.json").write_text(json.dumps(
        {"family": "toy_rows", "n": 24, "batch": 8}))
    (here / "traffic" / "toy.json").write_text(json.dumps(
        {"pool": 2, "warm_rounds": 2, "sample_calls": 4, "trace_calls": 10,
         "breakdown_calls": 3, "control": "float32"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a test",
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "a test"})
    names = []
    for chips in (1, 2, 4):
        name = f"toy.r{chips}"
        names.append(name)
        limits = {"y_err": 0.0, "wrong": 0}
        if chips > 1:
            limits["rank_diff"] = 0.0
        (here / "limits" / f"{name}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": name, "config": "toy",
                                   "traffic": "toy", "chips": chips,
                                   "why": "a test"})
    bench["per_layer"].append({"name": "toy.spans_calls", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "entry", "moves": "instances_per_s",
                               "workloads": names})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
