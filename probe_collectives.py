"""Host cost of the parallel layer's collectives on one card: a one-rank
NCCL group through ``cvx_tpu_torch.parallel`` (``Mesh.sum``, ``agree``,
``gather``, ``broadcast``) and the bare ``dist.all_reduce``, beside a
one-element kernel.

Each is timed two ways over 200 calls after a warm-up: synced (the median
of calls each ending in ``torch.cuda.synchronize()``) and queued (the mean
of 200 calls with one synchronize at the end).  Prints the card's name
and power limit, then one JSON line per operation.

    python3 probe_collectives.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch
import torch.distributed as dist


def timed(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return statistics.median(walls), (time.perf_counter() - t0) * 1e6 / reps


def main() -> None:
    from cvx_tpu_torch.parallel import init_distributed, instance_mesh
    from cvx_tpu_torch.parallel.mesh import free_port

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    mesh = instance_mesh(device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    s = torch.ones((), **f64)
    M = torch.ones(128, 128, **f64)
    X = torch.ones(10000, 100, dtype=torch.float32, device=dev)
    P = torch.ones(128, 4096, **f64)
    for label, fn in (
            ("one-element kernel (s + 1)", lambda: s + 1),
            ("dist.all_reduce f64 scalar", lambda: dist.all_reduce(s)),
            ("dist.all_reduce f64 128 x 128", lambda: dist.all_reduce(M)),
            ("Mesh.sum f64 scalar", lambda: mesh.sum(s)),
            ("Mesh.agree", lambda: mesh.agree(s > 0)),
            ("Mesh.gather f32 10000 x 100", lambda: mesh.gather(X)),
            ("Mesh.broadcast f64 128 x 4096", lambda: mesh.broadcast(P, 0))):
        synced, queued = timed(fn)
        print(json.dumps({"op": label, "synced_us": synced,
                          "queued_us": queued}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
