"""Process groups for the parallel layer, and a launcher of ranks.

Counterpart of ``cvx_tpu/parallel/mesh.py``.  The reference builds a JAX
``Mesh`` over devices and runs ONE program over it (``shard_map`` with
``psum`` / ``all_gather`` over ICI).  The port follows PyTorch's idiom:
one process per rank, each running the local body, joined by the
collectives of a ``torch.distributed`` process group:

* ``psum``                  -> ``all_reduce(SUM)``      (``Mesh.sum``)
* ``pmax`` / ``pmin``       -> ``all_reduce(MAX / MIN)`` (``Mesh.max``)
* the psum-AND of a mask    -> ``all_reduce(MIN)`` on an integer
                               (``Mesh.all``)
* ``all_gather``            -> ``all_gather``           (``Mesh.gather``)
* the owner's broadcast     -> ``broadcast``            (``Mesh.broadcast``)

A ``Mesh`` is a small record: the group, the axis name, its size, this
rank and the device the rank works on.  The backend is NCCL when the
tensors are on the card and gloo on the CPU; the caller can choose it.
NCCL refuses two ranks on one GPU, so several ranks sharing one card use
gloo (which stages CUDA tensors through the host).

A solver's loops read the host, so every loop exit of a sharded solver
goes through ``Mesh.agree``: a rank that left a loop while another calls
a collective would hang the group.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..tree import tree_map


@dataclass(frozen=True)
class Mesh:
    """One axis of ranks: ``group`` (None: the default group), ``axis``
    its name, ``size`` ranks, this process's ``rank`` and ``device``."""

    group: Any
    axis: str
    size: int
    rank: int
    device: torch.device

    def _live(self) -> bool:
        """Whether the collectives run: on an initialized group, always.
        With no group a one-rank mesh keeps its values (there is nothing to
        combine); a wider one raises, since its solvers cut the data by
        ``local_rows`` and would otherwise sum this rank's share alone."""
        if dist.is_initialized():
            return True
        if self.size > 1:
            raise RuntimeError(
                f"mesh axis {self.axis!r} spans {self.size} ranks but no "
                "process group is initialized (call init_distributed)")
        return False

    def _reduce(self, t, op):
        out = t.clone()
        if self._live():
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def sum(self, t):
        """The sum of ``t`` over the ranks (``lax.psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def max(self, t):
        """The elementwise maximum over the ranks (``lax.pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def min(self, t):
        """The elementwise minimum over the ranks (``lax.pmin``)."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def all(self, mask):
        """True where ``mask`` holds on every rank (the psum-AND)."""
        return self._reduce(mask.to(torch.int32), dist.ReduceOp.MIN) > 0

    def agree(self, flag) -> bool:
        """One loop decision for all ranks: True if it holds on any rank.
        Every loop of a sharded solver tests its exit through this, so no
        rank leaves a loop in which another still calls a collective."""
        t = torch.as_tensor(flag, device=self.device).reshape(1)
        return bool(self._reduce(t.to(torch.int32), dist.ReduceOp.MAX)
                    .item())

    def gather(self, t):
        """The ranks' ``t`` concatenated on the leading axis, rank order
        (``lax.all_gather(..., tiled=True)``)."""
        if not self._live():
            return t
        src = t.contiguous()
        if src.dtype == torch.bool:
            return self.gather(src.to(torch.uint8)).to(torch.bool)
        if dist.get_backend(self.group) == "nccl":
            out = src.new_empty((self.size * src.shape[0], *src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=self.group)
            return out
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0)

    def broadcast(self, t, src: int):
        """``t`` as rank ``src`` holds it, on every rank."""
        out = t.contiguous().clone()
        if self._live():
            dist.broadcast(out, src=self._global(src), group=self.group)
        return out

    def _global(self, r: int) -> int:
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def check_axis(self, axis: str) -> None:
        """Raise unless ``axis`` is this mesh's axis: a function's
        ``axis`` argument (the reference's) names the mesh axis it shards
        over, and ``shard_map`` raises on a name the mesh does not carry."""
        if axis != self.axis:
            raise ValueError(f"axis {axis!r}: this mesh's axis is "
                             f"{self.axis!r}")

    def local_rows(self, n: int, what: str = "rows") -> slice:
        """This rank's share of ``n`` rows; ``n`` must divide by the size."""
        if n % self.size != 0:
            raise ValueError(f"{what}: {n} not divisible by the mesh axis "
                             f"size {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, *, backend: str | None = None,
                     device=None, timeout: float = 300.0) -> int:
    """Join the process group of this run and return its world size.

    ``init_method`` (``"tcp://host:port"``, ``"file:///path"``), ``rank``
    and ``world_size`` are explicit, or read from the ``env://`` variables
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) when ``init_method`` is
    None.  ``device`` is where this rank works: the card by default
    (``cuda:<rank mod count>``), ``"cpu"`` for CPU ranks.  ``backend``
    defaults to NCCL for the card and gloo for the CPU.  ``timeout``
    (seconds) bounds every collective, so a lost rank fails the others
    instead of hanging them.  A second call returns the world size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is None:
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' for CPU ranks")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.get_world_size()


def instance_mesh(n_devices: int | None = None, axis: str = "dp",
                  device=None) -> Mesh:
    """1-D mesh over the ranks of the default group for instance-batch
    (data) parallelism.  ``n_devices`` must be None or the world size.
    ``device`` is where this rank works: by default the card
    ``init_distributed`` set (raises without one); ``"cpu"`` for CPU
    ranks."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed before building a mesh")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"world of {size} ranks")
    dev = (torch.device(device) if device is not None
           else torch.device("cuda", torch.cuda.current_device()))
    return Mesh(group=None, axis=axis, size=size, rank=dist.get_rank(),
                device=dev)


def block_mesh(n_devices: int | None = None, axis: str = "blocks",
               device=None) -> Mesh:
    """1-D mesh for block-separable Schur-consensus problems."""
    return instance_mesh(n_devices, axis, device)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """This rank's shard of a batched tree: every leaf's leading axis cut
    into ``mesh.size`` equal parts over the mesh axis ``axis``, the rank's
    part on ``mesh.device``."""
    mesh.check_axis(axis)
    def put(leaf):
        return leaf[mesh.local_rows(leaf.shape[0], "batch")].to(mesh.device)

    return tree_map(put, x)


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               results):
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # one card a rank where there are enough, else they share
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cpu":
            # ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
        init_distributed(init_method, world_size, rank, backend=backend,
                         device=dev)
        out = fn(rank, world_size, *args)
        dist.barrier()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, n_ranks: int, *args, init_method: str,
                backend: str | None = None, device="cuda",
                timeout: float = 300.0) -> list:
    """Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` new processes
    (start method ``spawn``: CUDA does not survive a fork), each joined to
    one group through ``init_method``; returns the ranks' return values in
    rank order.

    Every rank must finish within ``timeout`` seconds.  A rank that raises
    or exits, or a world that runs out of time, stops every rank and
    raises here (RuntimeError, TimeoutError): a hung group fails the
    caller instead of blocking it.  ``fn`` and its arguments must be
    importable and picklable; the caller's main module must guard its
    work with ``if __name__ == "__main__":`` (the ranks import it).
    ``device`` is where the ranks work: the card by default (rank r on
    card r mod the card count), ``"cpu"`` for CPU ranks.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spawn_ranks: no CUDA device; pass device='cpu' "
                           "for CPU ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n_ranks, init_method, backend,
                               str(device), args, results), daemon=True)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        while len(out) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_ranks: {n_ranks - len(out)} of {n_ranks} ranks "
                    f"did not finish within {timeout:g} s")
            try:
                r, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for i, p in enumerate(procs)
                        if i not in out and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"spawn_ranks: a rank exited with code "
                        f"{dead[0].exitcode} and reported nothing")
                continue
            if not ok:
                raise RuntimeError(f"spawn_ranks: rank {r} failed:\n{val}")
            out[r] = val
    finally:
        for p in procs:
            p.join(timeout=0 if len(out) < n_ranks else 10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(n_ranks)]


def free_port() -> int:
    """A free TCP port on localhost, for ``tcp://localhost:<port>``."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

