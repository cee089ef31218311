"""The last line's keys, and a run with no card prints no result."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import run, spec

ROOT = Path(__file__).resolve().parents[2]


def record(**kw):
    base = dict(correct=True, attempted=10, failed=0, peak=123,
                metrics={"setup_s": {"value": 1.5, "unit": "s"}},
                breakdown={"device_ops": [["k", 0.1]], "idle_gaps": []},
                busy_s=0.2, window_s=0.5, rows=[("x_err", 1e-16, 1e-12)])
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    cell = spec.load("kl_n100_b10k.certified")
    line = run.result_line(record(), cell, traced, "NVIDIA H100 80GB HBM3",
                           "700.00 W")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + [
        "checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] == 123
    assert ("busy_s" in dev and "window_s" in dev) == traced
    assert line["checks"] == {"x_err": {"value": 1e-16, "limit": 1e-12}}
    json.dumps(line)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "kl_n100_b10k.certified", "--seed", str(2**40),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cvx_tpu_torch_like", sys)
    assert run.loaded_forbidden() == [
        m for m in run.FORBIDDEN if m in {n.split(".")[0]
                                          for n in sys.modules}]
    monkeypatch.setitem(sys.modules, "jax.numpy_fake", sys)
    assert "jax" in run.loaded_forbidden()


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "kl_n100_b10k.certified", "--seed", str(2**33 + 1),
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert set(line["metrics"]) == {"instances_per_s", "call_ms_p95",
                                    "setup_s"}
