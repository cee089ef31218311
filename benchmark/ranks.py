"""A cell over several ranks: rank 0 is the process ``run.py`` runs in, on
the first card, and it starts ranks 1 to R - 1 itself, rank r on card r
(gloo ranks on the host where the run is on the CPU, as in the tests).

The ranks form one default ``torch.distributed`` group, NCCL on cards and
gloo on the CPU, through a TCP store that rank 0 holds on a free port of
localhost, and a second group, gloo, for the harness's own messages on the
host.  A family's program uses the default group: ``make_model`` gets a
``World`` where the cell takes several ranks.  Rank 0 makes the inputs and
sends them (the skeleton through the store, the tensors over the default
group), so every rank holds rank 0's bits; the followers take rank 0's
settings of TF32 too.  Before each step of the program rank 0 broadcasts a
command on the host group, and every follower takes the same step on its
own device, in the same order:

* ``MODEL``: make a model;
* ``CALL model batch``: call that model on that batch of the pool, then
  ``synchronize()``;
* ``AGREE model batch``: the same call; then rank 0 sends its outputs and
  the largest |difference| of any follower's outputs from them is reduced
  (MAX) into ``rank_diff``, a number the cell's limits hold;
* ``PEAK``: each rank's peak of device memory, gathered on rank 0;
* ``STOP``: the follower checks that it holds no JAX, says on standard
  error what it followed, leaves the groups and exits.

Bounds.  Rank 0 polls its followers every ``POLL_S`` s: one that exits
before it was told to stop fails the run within ``DEATH_S`` s, and so does
an exception on rank 0; rank 0 then ends the others and exits with code 1,
printing no result.  A rank that hangs holds the others in a collective,
or in the wait for the next command, for at most ``TIMEOUT_S`` s, the
groups' timeout, after which they raise (gloo) or NCCL's watchdog ends
them.  A follower whose rank 0 is gone exits within ``POLL_S`` s, so no
process outlives the run.  Rank 0 starts each follower as

    python3 -m benchmark.ranks --rank r --world R --port P --device cuda \\
        --threads T

from the checkout's root, its standard output sent to standard error.
"""

import argparse
import datetime
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
POLL_S = 0.2
DEATH_S = 10.0
TIMEOUT_S = 120.0
MODEL, CALL, AGREE, PEAK, STOP = range(5)
STEPS = ("models", "calls", "agree", "peak", "stop")


@dataclass(frozen=True)
class World:
    """What a family's ``make_model`` gets in a cell of several ranks: this
    process's rank, the number of ranks, its device and the default
    group."""

    rank: int
    size: int
    device: torch.device
    group: object


def _device(kind, rank):
    return (torch.device("cuda", rank) if kind == "cuda"
            else torch.device("cpu"))


def _join(store, rank, size, device):
    """Join the default group and make the host group: (World, host)."""
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=size,
                            timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout)
    return World(rank, size, device, dist.group.WORLD), host


def _flatten(tree, leaves):
    """The JSON skeleton of a tree of dicts, lists and tensors; its tensors
    are appended to ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"t": [list(tree.shape), str(tree.dtype).split(".")[-1]]}
    if isinstance(tree, dict):
        return {"d": {key: _flatten(v, leaves) for key, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"l": [_flatten(v, leaves) for v in tree]}
    return {"v": tree}


def _empty(skel, device, leaves):
    """A tree of empty tensors on ``device`` with the skeleton ``skel``."""
    if "t" in skel:
        shape, dtype = skel["t"]
        leaves.append(torch.empty(shape, dtype=getattr(torch, dtype),
                                  device=device))
        return leaves[-1]
    if "d" in skel:
        return {key: _empty(v, device, leaves)
                for key, v in skel["d"].items()}
    if "l" in skel:
        return [_empty(v, device, leaves) for v in skel["l"]]
    return skel["v"]


def _broadcast(t):
    """``t`` from rank 0 over the default group, in place (bool as
    bytes)."""
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                   src=0)


def _send(store, key, tree):
    leaves = []
    store.set(key, json.dumps(_flatten(tree, leaves)))
    for t in leaves:
        _broadcast(t.contiguous())


def _receive(store, key, device):
    leaves = []
    tree = _empty(json.loads(store.get(key)), device, leaves)
    for t in leaves:
        _broadcast(t)
    return tree


def _largest_diff(mine, theirs):
    """The largest |difference| of two trees, exactly: NaN against NaN and
    equal infinities read 0, any other non-finite difference +inf, and so
    does a tree of another structure, shape or dtype."""
    ours, their = [], []
    if _flatten(mine, ours) != _flatten(theirs, their):
        return math.inf
    worst = 0.0
    for a, b in zip(ours, their):
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        d = torch.nan_to_num(torch.where(same, 0.0, (a - b).abs()),
                             nan=math.inf)
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def _gather(value, host, size):
    parts = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
    dist.all_gather(parts, torch.tensor([value], dtype=torch.int64),
                    group=host)
    return [int(p) for p in parts]


def peak_bytes(device):
    """This process's peak of allocated memory on ``device`` (0 off the
    card)."""
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


class Leader:
    """Rank 0's side: starts the followers, and announces each step of the
    program before it takes it itself."""

    def __init__(self, cell, device, log):
        self.size, self.device, self.log = cell.chips, device, log
        self.sent = dict.fromkeys(STEPS, 0)
        self.trees = (f"tree{i}" for i in itertools.count())
        self.stopping = False
        self.world = self.host = None
        self.store = dist.TCPStore(
            "127.0.0.1", 0, self.size, True, wait_for_workers=False,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.store.set("cell", json.dumps({
            "root": str(cell.root), "name": cell.name,
            "config": cell.config, "mix": cell.mix,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}))
        args = [sys.executable, "-m", f"{__package__}.ranks",
                "--world", str(self.size), "--port", str(self.store.port),
                "--device", device.type,
                "--threads", str(torch.get_num_threads())]
        self.procs = []
        for r in range(1, self.size):
            self.procs.append(subprocess.Popen(args + ["--rank", str(r)],
                                               cwd=ROOT, stdout=2))
            print(f"ranks: rank {r} is process {self.procs[-1].pid} on "
                  f"{_device(device.type, r)}", file=log)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.stopping:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and not self.stopping:
                    self.fail(f"rank {r} exited with code {code} before it "
                              "was told to stop")
            time.sleep(POLL_S)

    def fail(self, why):
        """End every follower and this process at once, with code 1 and no
        result (a group whose peers are gone can hang in its
        destructor)."""
        print(f"ranks: {why}: the run fails", file=sys.stderr, flush=True)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        os._exit(1)

    def connect(self):
        """Join the groups; the followers have been starting meanwhile."""
        self.world, self.host = _join(self.store, 0, self.size, self.device)

    def step(self, op, model=0, batch=0):
        """Announce a step to the followers."""
        self.sent[STEPS[op]] += 1
        dist.broadcast(torch.tensor([op, model, batch]), src=0,
                       group=self.host)

    def share(self, tree):
        """Send ``tree`` to every follower; returns it."""
        _send(self.store, next(self.trees), tree)
        return tree

    def spread(self, out):
        """After an AGREE step: send rank 0's outputs ``out``, and return
        the largest difference of any follower's outputs from them."""
        self.share(out)
        d = torch.zeros(1, dtype=torch.float64)
        dist.all_reduce(d, op=dist.ReduceOp.MAX, group=self.host)
        return float(d)

    def peak(self):
        """The peak of device memory on the fullest rank."""
        self.step(PEAK)
        peaks = _gather(peak_bytes(self.device), self.host, self.size)
        print(f"ranks: memory_peak_bytes by rank {peaks}", file=self.log)
        return max(peaks)

    def stop(self):
        """Tell the followers to stop, leave the groups and wait for each
        to exit: the run fails unless each exits with 0 within
        ``TIMEOUT_S``."""
        self.stopping = True
        self.step(STOP)
        print(f"ranks: rank 0 sent {json.dumps(self.sent)}", file=self.log)
        dist.destroy_process_group()
        for r, p in enumerate(self.procs, 1):
            try:
                code = p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.fail(f"rank {r} ended with {code} after it was told "
                          "to stop")


def _orphaned(parent):
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(1)


def follow(rank, size, port, kind, threads):
    """A follower's life: join, take the cell and its inputs from rank 0,
    and take each step rank 0 announces until STOP.  Returns the exit
    code."""
    from . import spec
    from .run import loaded_forbidden

    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    torch.set_num_threads(threads)
    device = _device(kind, rank)
    store = dist.TCPStore("127.0.0.1", port, size, False,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    world, host = _join(store, rank, size, device)
    desc = json.loads(store.get("cell"))
    torch.set_float32_matmul_precision(desc["matmul_precision"])
    torch.backends.cudnn.allow_tf32 = desc["cudnn_tf32"]
    fam = spec.load(desc["name"], desc["root"]).family
    config, mix = desc["config"], desc["mix"]
    trees = (f"tree{i}" for i in itertools.count())
    H, pool = _receive(store, next(trees), device)
    models, done = [], dict.fromkeys(STEPS, 0)
    while True:
        cmd = torch.zeros(3, dtype=torch.int64)
        dist.broadcast(cmd, src=0, group=host)
        op, k, b = cmd.tolist()
        done[STEPS[op]] += 1
        if op == MODEL:
            models.append(fam.make_model(config, H, world=world))
        elif op in (CALL, AGREE):
            result = fam.call(models[k], mix, pool[b])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if op == AGREE:
                theirs = _receive(store, next(trees), device)
                d = torch.tensor([_largest_diff(fam.outputs(result), theirs)],
                                 dtype=torch.float64)
                dist.all_reduce(d, op=dist.ReduceOp.MAX, group=host)
        elif op == PEAK:
            _gather(peak_bytes(device), host, size)
        else:
            break
    bad = loaded_forbidden()
    print(f"rank {rank}: followed {json.dumps(done)}", file=sys.stderr,
          flush=True)
    dist.destroy_process_group()
    if bad:
        print(f"rank {rank}: loaded modules the run must not hold: {bad}",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="a follower rank of a benchmark cell; rank 0 starts it")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--threads", type=int, required=True)
    a = ap.parse_args(argv)
    try:
        return follow(a.rank, a.world, a.port, a.device, a.threads)
    except BaseException:   # noqa: BLE001 -- reported, then the process ends
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    sys.exit(main())
