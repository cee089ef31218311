"""One run of one cell: set-up, the measured window, the traced slices, and
the comparison that decides ``correct``.

The loop is closed with one caller: each call takes the next batch of the
pool, and ends in ``synchronize()`` before the next is issued.  For each
call the harness records a pair of CUDA events around it (the stream is
empty when the first is recorded, so the pair spans the call from its
issue to its last kernel on the device's clock) and, as a witness, the
host clock from the call to the return of ``synchronize()``; it keeps the
family's failure flags (added up on the device every ``TALLY`` calls and
read once after the window), and keeps a sample of the calls' outputs,
drawn from the seed, for the comparison.  Nothing is compiled or built
inside the window: the set-up warms every batch of the pool, and moves
what it made out of the garbage collector's sight (``gc.freeze``), so that
a full collection in the window does not walk the libraries' objects.

A cell whose ``chips`` R is above 1 runs on R ranks (``ranks.py``): this
process is rank 0, it starts the others, and each step of the program here
is first announced to them, so that they take it too.  With R = 1 nothing
of that runs: no process, no group, no message.
"""

import gc
import random
import statistics
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from . import ranks, spec, stats, trace
from .reference import judge

TALLY = 256


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call, pool, seconds, device, keep, rng, failed):
    """Calls ``call(i)`` on batch i of the pool, cycling, until ``seconds``
    have passed; returns the window's record.  ``keep`` calls are sampled
    uniformly from all calls (reservoir) for the comparison; ``failed(out)``
    gives a call's failure flags."""
    cuda = device.type == "cuda"
    ev0, ev1 = ((torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) if cuda
                else (None, None))
    latencies, host_ms, flags, tallies, kept = [], [], [], [], []
    calls = 0
    t0 = time.perf_counter()
    while True:
        b = calls % len(pool)
        t_call = time.perf_counter()
        if cuda:
            ev0.record()
        out = call(b)
        if cuda:
            ev1.record()
        _sync(device)
        t_done = time.perf_counter()
        host_ms.append((t_done - t_call) * 1e3)
        if cuda:
            latencies.append(ev0.elapsed_time(ev1))
        flags.append(failed(out))
        if len(flags) == TALLY:
            tallies.append(torch.stack(flags).sum())
            flags = []
        if calls < keep:
            kept.append((b, out))
        else:
            j = rng.randrange(calls + 1)
            if j < keep:
                kept[j] = (b, out)
        calls += 1
        if t_done - t0 >= seconds:
            break
    wall = t_done - t0
    if flags:
        tallies.append(torch.stack(flags).sum())
    failed = int(sum(int(t) for t in tallies))
    return SimpleNamespace(calls=calls, wall_s=wall, latencies_ms=latencies,
                           host_ms=host_ms, failed=failed, kept=kept)


def _tenths(values):
    step = max(1, len(values) // 10)
    return [values[i:i + step] for i in range(0, len(values), step)][:10]


class Program:
    """The family's program as the harness drives it.  ``make()`` makes a
    model and returns its ``call(b)`` on batch b of the pool; ``agree(b)``
    calls the first model once more.  With a ``ranks.Leader`` each step is
    first announced to the followers, which take it too."""

    def __init__(self, fam, cell, H, pool, leader):
        self.fam, self.config, self.mix = fam, cell.config, cell.mix
        self.H, self.pool, self.leader = H, pool, leader
        self.models = []

    def make(self):
        kwargs = {}
        if self.leader:
            self.leader.step(ranks.MODEL)
            kwargs["world"] = self.leader.world
        self.models.append(self.fam.make_model(self.config, self.H,
                                               **kwargs))
        k = len(self.models) - 1
        return lambda b: self.call(k, b)

    def call(self, k, b):
        if self.leader:
            self.leader.step(ranks.CALL, k, b)
        return self.fam.call(self.models[k], self.mix, self.pool[b])

    def agree(self, b, sync):
        """The largest difference of any rank's outputs on batch b from
        rank 0's."""
        self.leader.step(ranks.AGREE, 0, b)
        out = self.fam.outputs(self.fam.call(self.models[0], self.mix,
                                             self.pool[b]))
        sync()
        return self.leader.spread(out)


def run_cell(cell, seed, seconds, traced, device, t_start, log=sys.stderr):
    """One run: set-up from ``t_start`` (the process's start), the window
    of ``seconds``, with ``traced`` the traced slices and the per-layer
    metrics (else the end-to-end ones), then the comparison.

    The cell's family (``families/<name>.py``) provides

    * ``make_inputs(config, mix, seed, device)`` -> (H, pool): what every
      call shares (a tensor, or dicts and lists of them) and a list of
      batches, each a dict of tensors, made on the device from the seed;
    * ``make_model(config, H)``: the program's model, built through the
      program; where the cell takes several ranks it is called with
      ``world=`` a ``ranks.World`` (rank, size, device, group) as well;
    * ``call(model, mix, batch)``: one call of the program;
    * ``outputs(result)``: what ``compare`` judges of a call's result, a
      dict of tensors;
    * ``failed(out)``: the call's failure flags, one bool a returned
      instance (counted in ``failed``);
    * ``reference(H, batch)``: the plain reference's answer for a batch;
    * ``compare(H, batch, out, ref, mix)``: the numbers by name, each a
      float (the worst over the batch) or an int (a count), that the
      cell's limits hold; the family's docstring lists them;
    * ``control(H, batch, mix, precision)``: the reference in the
      program's place, one precision down (``calibrate.py``, the tests);
    * optional: ``counters()``, the program's counters read around a traced
      slice (none without it), ``KERNEL_NAMES`` for the metrics that read
      them, and ``reference_certificate(H, batch, ref)`` for
      ``calibrate.py``.

    ``config["batch"]`` counts the instances one call returns: 1 for a
    single program.  With several ranks the judged numbers gain
    ``rank_diff``."""
    leader = ranks.Leader(cell, device, log) if cell.chips > 1 else None
    try:
        return _run(cell, seed, seconds, traced, device, t_start, log, leader)
    except BaseException:
        if leader is None:
            raise
        traceback.print_exc()
        leader.fail("rank 0 raised")


def _run(cell, seed, seconds, traced, device, t_start, log, leader):
    fam, mix, config = cell.family, cell.mix, cell.config
    B = config["batch"]
    H, pool = fam.make_inputs(config, mix, seed, device)
    if leader:
        leader.connect()
        leader.share((H, pool))
    program = Program(fam, cell, H, pool, leader)
    raw = program.make()

    def call(b):
        return fam.outputs(raw(b))

    for _ in range(mix["warm_rounds"]):
        for b in range(len(pool)):
            call(b)
    _sync(device)
    # what set-up made stays alive: the collector's full passes in the
    # window then walk only what the calls make
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s (process start to the first timed call)",
          file=log)

    window = closed_loop(call, pool, seconds, device, mix["sample_calls"],
                         random.Random(seed), fam.failed)
    gc.unfreeze()
    peak = leader.peak() if leader else ranks.peak_bytes(device)
    print(f"window: {window.calls} calls of {B} instances in "
          f"{window.wall_s:.6f} s; failed {window.failed}", file=log)
    if window.latencies_ms:
        lat = sorted(window.latencies_ms)
        print("call ms: min {:.4f}, median {:.4f}, p95 {:.4f}, max {:.4f}; "
              "by tenth of the window, median {}".format(
                  lat[0], lat[len(lat) // 2],
                  stats.percentile(lat, 95), lat[-1],
                  [round(statistics.median(part), 4) for part in
                   _tenths(window.latencies_ms)]), file=log)
        host = sorted(window.host_ms)
        print("host clock, call to synchronize()'s return, ms: median "
              "{:.4f}, p95 {:.4f}; p95 of (host - events) {:.4f}".format(
                  host[len(host) // 2], stats.percentile(host, 95),
                  stats.percentile(sorted(
                      h - e for h, e in zip(window.host_ms,
                                            window.latencies_ms)), 95)),
              file=log)

    def sync():
        _sync(device)

    run = SimpleNamespace(cell=cell, B=B, H=H, pool=pool,
                          setup_s=setup_s, window=window, trace=None,
                          log=log, device=device, program=program, sync=sync)
    breakdown = None
    if traced:
        acts = trace.device_activities(device)
        if acts:
            run.trace = trace.device_slice(call, mix["trace_calls"],
                                           len(pool), sync,
                                           getattr(fam, "counters", dict),
                                           acts)
            breakdown = {
                "device_ops": trace.top_ops(run.trace.ops),
                "idle_gaps": trace.host_slice(call, mix["breakdown_calls"],
                                              len(pool), sync, acts)}
        else:
            run.trace = trace.Slice(calls=0, window_s=0.0, ops=[])
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    busy = run.trace.busy_s() if run.trace else None
    window_s = run.trace.window_s if run.trace else None
    attempted, failed = window.calls * B, window.failed
    rank_diff = None
    if leader:
        rank_diff = max(program.agree(b, sync) for b in range(len(pool)))
        leader.stop()

    # the program's state goes before the reference runs on the card
    kept = window.kept
    del program, raw, call, run, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(fam, H, pool, kept, mix)
    if rank_diff is not None:
        numbers["rank_diff"] = rank_diff
    correct, rows = judge.decide(numbers, cell.limits)
    return SimpleNamespace(correct=correct, attempted=attempted,
                           failed=failed, metrics=metrics, peak=peak,
                           breakdown=breakdown, busy_s=busy,
                           window_s=window_s, rows=rows, numbers=numbers)


def compare(fam, H, pool, kept, mix):
    """The family's numbers over the sampled calls, each against the
    reference of its batch (solved once per batch)."""
    refs, numbers = {}, None
    for b, out in kept:
        if b not in refs:
            refs[b] = fam.reference(H, pool[b])
        numbers = judge.merge(numbers, fam.compare(H, pool[b], out, refs[b],
                                                   mix))
    return numbers
