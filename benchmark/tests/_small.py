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
