"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 7,8,9 --seconds 2 [--out FILE]

For each seed it runs the cell as ``run.py`` does (``harness.run_cell``:
its ranks, set-up, a closed-loop window of ``--seconds``, the same sampled
calls) and prints the family's numbers of the program; for each control
seed it makes the cell's inputs, puts the reference, in the precision the
mix names as its control, in the program's place and prints the same
numbers, with the largest ``reference_certificate`` of the reference's own
answer where the family gives one (how far the reference is from exact).
One JSON line per reading; with ``--out`` also appended to FILE.  Not part
of a run.  Exits 1 when there is no CUDA device or fewer than the cell
asks for.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed, device):
    """The family's numbers of the control on the inputs of ``seed``, and
    the largest certificate of the reference's answers (None where the
    family gives none)."""
    from benchmark.reference import judge

    fam, mix = cell.family, cell.mix
    H, pool = fam.make_inputs(cell.config, mix, seed, device)
    certify = getattr(fam, "reference_certificate", None)
    numbers, cert = None, None
    for batch in pool:
        ref = fam.reference(H, batch)
        numbers = judge.merge(numbers, fam.compare(
            H, batch, fam.control(H, batch, mix, mix["control"]), ref, mix))
        if certify:
            cert = max(cert or 0.0, certify(H, batch, ref))
    return numbers, cert


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing was read", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}: nothing was read",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for seed in seeds(args.seeds):
        r = harness.run_cell(cell, seed, args.seconds, False, device,
                             time.perf_counter())
        emit({"workload": cell.name, "side": "program", "seed": seed,
              "attempted": r.attempted, "failed": r.failed, **r.numbers})

    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        numbers, cert = control_numbers(cell, seed, device)
        emit({"workload": cell.name, "side": f"control {cell.mix['control']}",
              "seed": seed, "reference_cert_max": cert,
              "reference_and_control_s": time.perf_counter() - t0,
              **numbers})
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
