"""Runs one cell of the benchmark once, on the cards of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
comparison held beside its limit (also the last lines of standard error).
Exits 1 and prints no result when there is no CUDA device or fewer than
the cell asks for, and when JAX or the JAX package was loaded.

A cell of R > 1 chips runs on R ranks, this process rank 0 on the first
card and the others started by it (``ranks.py``); only rank 0 times,
traces and prints, ``device.count`` is R and ``memory_peak_bytes`` the
peak of the fullest card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cvx_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules, compared whole, that the run must
    not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"


def result_line(r, cell, traced, kind, power):
    """The last line's object from a run's record ``r``: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` in a
    traced run, and ``checks`` last."""
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": r.peak, "power_limit": power}
    if traced:
        dev["busy_s"], dev["window_s"] = r.busy_s, r.window_s
    result = {"correct": r.correct, "attempted": r.attempted,
              "failed": r.failed, "metrics": r.metrics, "device": dev}
    if traced and r.breakdown is not None:
        result["breakdown"] = r.breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in r.rows}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing was run", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}: nothing was run",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded modules the run must not hold: {bad}",
              file=sys.stderr)
        return 1
    result = result_line(r, cell, bool(args.trace),
                         torch.cuda.get_device_name(device), power_limit())
    for name, value, limit in r.rows:
        print(f"check {name} {value!r} <= {limit!r}: "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)     # the checkout's root, not benchmark/
    sys.exit(main())
