"""Each family judges its own outputs: the KL family's ``compare`` is the
comparison the harness made before, bit for bit; a family that is not KL
is new files and entries only, through ``harness.run_cell`` and
``calibrate.py``'s comparison; and a cell of one chip starts no process
and forms no process group."""

import subprocess

import pytest
import torch
import torch.distributed as dist

from _small import cpu_run, small_cell, toy_benchmark

from benchmark import calibrate, ranks, spec
from benchmark.families import kl_bounds
from benchmark.reference import judge, kl_projection


@pytest.mark.parametrize("workload", ["kl_n100_b10k.certified",
                                      "kl_n100_b10k.primal"])
def test_kl_compare_is_the_old_call_bit_for_bit(workload):
    """``kl_bounds.compare`` against the call the harness made before,
    ``compare(H, batch["u"], out, ref, mix["contract"])`` (then
    ``judge.compare``, now ``kl_projection.compare``), on a program's
    outputs and on the control's."""
    torch.set_num_threads(2)
    cell = small_cell(workload)
    fam, mix = cell.family, cell.mix
    assert fam is spec.load(workload).family
    H, pool = fam.make_inputs(cell.config, mix, 2**34 + 9,
                              torch.device("cpu"))
    model = fam.make_model(cell.config, H)
    for batch in pool:
        ref = fam.reference(H, batch)
        for out in (fam.outputs(fam.call(model, mix, batch)),
                    fam.control(H, batch, mix, mix["control"])):
            got = kl_bounds.compare(H, batch, out, ref, mix)
            old = kl_projection.compare(H, batch["u"], out, ref,
                                        mix["contract"])
            assert list(got) == list(kl_projection.NUMBERS)
            assert got == old
            assert all(type(got[k]) is type(old[k]) for k in got)


def test_merge_adds_counts_and_keeps_the_worst():
    a = {"x_err": 1e-9, "stall_diff": 2}
    b = {"x_err": 3e-9, "stall_diff": 1}
    assert judge.merge(None, a) == a
    assert judge.merge(a, b) == {"x_err": 3e-9, "stall_diff": 3}


def test_a_family_that_is_not_kl_is_new_files_only(tmp_path):
    """The toy family, new files and entries in a copy of the benchmark,
    runs through the harness on one chip and through the control's
    comparison: correct, the control not."""
    root = toy_benchmark(tmp_path)
    cell = spec.load("toy.r1", root)
    assert cell.family.__file__ == str(
        (root / "benchmark" / "families" / "toy_rows.py").resolve())
    r = cpu_run(cell, traced=False)
    assert r.correct, r.rows
    assert set(r.numbers) == {"y_err", "wrong"}
    assert r.numbers == {"y_err": 0.0, "wrong": 0}
    assert r.attempted > 0 and r.failed == 0
    numbers, cert = calibrate.control_numbers(cell, 2**33 + 5,
                                              torch.device("cpu"))
    assert cert is None
    assert numbers["y_err"] > 0 and numbers["wrong"] > 0
    correct, rows = judge.decide(numbers, cell.limits)
    assert not correct, rows


def test_one_chip_starts_no_process_and_no_group(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a cell of one chip started a rank")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(ranks, "Leader", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "new_group", refuse)
    assert not dist.is_initialized()
    r = cpu_run(small_cell("kl_n100_b10k.certified"))
    assert r.correct, r.rows
    assert "rank_diff" not in r.numbers
    assert not dist.is_initialized()
