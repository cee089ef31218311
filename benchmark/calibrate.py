"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 7,8,9 --seconds 2 [--out FILE]

For each seed it makes the cell's inputs, warms the route, runs a short
closed-loop window as a run does (the same sampled calls) and prints the
judge's numbers of the program; for each control seed it puts the
reference, in the precision the mix names as its control, in the program's
place and prints the same numbers, and the f64 certificate of the
reference's own optimum (how far the reference is from exact).  One JSON
line per reading; with ``--out`` also appended to FILE.  Not part of a
run.  Exits 1 when there is no CUDA device.
"""

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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
    from benchmark.reference import judge
    from benchmark.reference.certificate import kl_gap_certificate

    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: nothing was read", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    fam, mix, config = cell.family, cell.mix, cell.config
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
        H, pool = fam.make_inputs(config, mix, seed, device)
        model = fam.make_model(config, H)

        def call(b):
            return fam.outputs(fam.call(model, mix, pool[b]))

        for b in range(len(pool)):
            call(b)
        window = harness.closed_loop(call, pool, args.seconds, device,
                                     mix["sample_calls"],
                                     random.Random(seed))
        numbers = harness.compare(fam, H, pool, window.kept, mix)
        emit({"workload": cell.name, "side": "program", "seed": seed,
              "calls": window.calls, "failed": window.failed, **numbers})
        del model, call, window

    for seed in seeds(args.control_seeds):
        H, pool = fam.make_inputs(config, mix, seed, device)
        numbers, cert = None, 0.0
        t0 = time.perf_counter()
        for batch in pool:
            ref = fam.reference(H, batch)
            numbers = judge.merge(numbers, judge.compare(
                H, batch["u"], fam.control(H, batch, mix, mix["control"]),
                ref, mix["contract"]))
            c = kl_gap_certificate(ref["x"].cpu().numpy(), H.cpu().numpy(),
                                   batch["u"].double().cpu().numpy())
            cert = max(cert, float(abs(c).max()))
        emit({"workload": cell.name, "side": f"control {mix['control']}",
              "seed": seed, "reference_cert_max": cert,
              "reference_and_control_s": time.perf_counter() - t0,
              **numbers})
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
