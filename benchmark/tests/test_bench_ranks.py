"""A cell over several ranks, run through the harness with the toy family of
``_small.py`` (one all-reduce a call, through the program's block mesh):
on 2 and 4 gloo ranks on the CPU, and, marked ``cuda``, on as many NCCL
ranks on cards.  Rank 0 runs in a process of its own, as ``run.py`` starts
it, and starts the others; each run has a time limit of its own, after
which every process of it is ended.

The CPU has no device trace, so there the script lets the profiler's CPU
activity stand in for the card's: the traced slices then run, and the
followers have to mirror them too."""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from _small import toy_benchmark

from benchmark import ranks

REPO = Path(__file__).resolve().parents[2]
LIMIT_S = 240
SCRIPT = """
import json, sys, time
T_START = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
from torch.profiler import ProfilerActivity
from benchmark import harness, run, spec, trace
torch.set_num_threads(1)
if {device!r} == "cpu":
    trace.device_activities = lambda device: [ProfilerActivity.CPU]
cell = spec.load({name!r})
cell.config.update({config!r})
device = torch.device("cuda", 0) if {device!r} == "cuda" else \\
    torch.device("cpu")
r = harness.run_cell(cell, {seed!r}, {seconds!r}, True, device, T_START)
print(json.dumps(run.result_line(r, cell, True, "test", "none")))
"""


def _run(tmp_path, chips, device, config=None, seconds=1.0):
    """Rank 0 of cell toy.r<chips> in a process of its own: (returncode,
    stdout, stderr, the time it ended)."""
    root = toy_benchmark(tmp_path)
    code = SCRIPT.format(root=str(root), name=f"toy.r{chips}",
                         config=config or {}, device=device,
                         seed=2**40 + chips, seconds=seconds)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        pytest.fail(f"the run took over {LIMIT_S} s:\n{err[-3000:]}")
    return p.returncode, out, err, time.time()


def _followed(err, chips):
    sent = json.loads(re.search(r"ranks: rank 0 sent (\{.*\})", err)[1])
    for r in range(1, chips):
        got = json.loads(re.search(rf"rank {r}: followed (\{{.*\}})",
                                   err)[1])
        assert got == sent, (r, got, sent)
    return sent


def _pids(err):
    return [int(p) for p in re.findall(r"ranks: rank \d+ is process (\d+)",
                                       err)]


def _gone(pid, wait_s=10.0):
    """Whether process ``pid`` has ended (a zombie counts) within
    ``wait_s``."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            state = Path(f"/proc/{pid}/stat").read_text().split()[2]
        except (FileNotFoundError, ProcessLookupError):
            return True
        if state in ("Z", "X"):
            return True
        time.sleep(0.1)
    return False


def _sound(tmp_path, chips, device):
    rc, out, err, _ = _run(tmp_path, chips, device)
    assert rc == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    line = json.loads(lines[0])
    assert line["correct"], line["checks"]
    assert line["checks"]["rank_diff"] == {"value": 0.0, "limit": 0.0}
    assert line["device"]["count"] == chips
    sent = _followed(err, chips)
    # the main model and spans.py's; warm rounds, the window, both traced
    # slices and spans.py's calls; one agreement call a batch of the pool
    assert sent["models"] == 2 and sent["agree"] == 2
    assert sent["peak"] == 1 and sent["stop"] == 1
    warm, traced, spans = 2 * 2, 10 + 3, 2 + 3
    assert line["attempted"] >= 8
    assert sent["calls"] == warm + line["attempted"] // 8 + traced + spans
    assert line["metrics"]["toy.spans_calls"]["value"] == 3.0
    assert all(_gone(pid) for pid in _pids(err))


def _perturbed(tmp_path, chips, device):
    rc, out, err, _ = _run(tmp_path, chips, device,
                           {"fault": {"rank": 1, "add": 1e-6}})
    assert rc == 0, err[-4000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert not line["correct"]
    assert line["checks"]["y_err"]["value"] == 0.0    # rank 0 is right
    assert line["checks"]["rank_diff"]["value"] >= 1e-6


def _killed(tmp_path, chips, device):
    rc, out, err, ended = _run(tmp_path, chips, device,
                               {"fault": {"rank": 1, "exit_at": 2 * 2 + 20}},
                               seconds=30.0)
    assert rc != 0
    assert out == "", out
    killed = float(re.search(r"toy: rank 1 killed at (\S+)", err)[1])
    assert ended - killed < ranks.DEATH_S, err[-3000:]
    pids = _pids(err)
    assert len(pids) == chips - 1
    assert all(_gone(pid) for pid in pids), err[-3000:]


CASES = [_sound, _perturbed, _killed]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("chips", [2, 4])
def test_gloo_ranks(tmp_path, chips, case):
    case(tmp_path, chips, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("chips", [2, 4])
def test_nccl_ranks(tmp_path, chips, case):
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA GPUs")
    case(tmp_path, chips, "cuda")


def test_largest_diff_is_exact():
    a = {"x": torch.tensor([1.0, float("nan"), float("inf")]),
         "flags": torch.tensor([True, False]), "parts": [torch.ones(2)]}

    def changed(**kw):
        b = {"x": a["x"].clone(), "flags": a["flags"].clone(),
             "parts": [a["parts"][0].clone()]}
        b.update(kw)
        return b

    assert ranks._largest_diff(a, changed()) == 0.0
    x = a["x"].clone()
    x[0] = 1.5
    assert ranks._largest_diff(a, changed(x=x)) == 0.5
    x = a["x"].clone()
    x[1] = 0.0
    assert ranks._largest_diff(a, changed(x=x)) == float("inf")
    assert ranks._largest_diff(a, changed(flags=torch.tensor([True,
                                                              True]))) == 1.0
    for other in (torch.ones(3), torch.ones(2, dtype=torch.float64)):
        assert ranks._largest_diff(a, changed(parts=[other])) == float("inf")
