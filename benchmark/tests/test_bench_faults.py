"""A run with the timed path broken underneath comes out not correct.  The
run is driven as on the card, past the look for a card, on the CPU, where
the program runs its kernels' plain versions; each fault is planted where
the answer is produced, in the kernel wrapper the route calls."""

import pytest
import torch

from _small import cpu_run, small_cell

import cvx_tpu_torch.models.dist_kl as dist_kl

CELLS = ("kl_n100_b10k.certified", "kl_n10000_b100.certified",
         "kl_n100_b10k.primal")
WRAPPER = {"certified": "kl_dual_fused_cert", "primal": "kl_barrier_fused"}


def altered(fn):
    """One instance's answer replaced by another's where the kernel
    returns it (an indexing fault)."""
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        x = out[0] if isinstance(out, tuple) else out
        x[1] = x[0]
        return out
    return wrapped


def unchanged(fn):
    """The solve returns its start: no step taken."""
    def wrapped(*a, **kw):
        if fn.__name__ == "kl_dual_fused_cert":
            return fn(*a, **{**kw, "n_steps": 0, "polish_steps": 0})
        return fn(*a, **{**kw, "n_inner": 0})
    return wrapped


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = cpu_run(small_cell(workload))
    assert r.correct, r.rows
    assert r.failed == 0 and r.attempted > 0


@pytest.mark.parametrize("fault", [altered, unchanged])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_run_is_not_correct(workload, fault, monkeypatch):
    name = WRAPPER[workload.split(".")[1]]
    monkeypatch.setattr(dist_kl, name, fault(getattr(dist_kl, name)))
    r = cpu_run(small_cell(workload))
    assert not r.correct, r.rows
