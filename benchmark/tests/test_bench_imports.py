"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the program.
Each check runs in a fresh interpreter, so what the test process holds
does not count."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NAMES = """
import json, sys
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

RUN = """
import sys, time, torch
sys.path.insert(0, ROOT_DIR)
torch.set_num_threads(2)
from benchmark import calibrate, harness, run, spec, stats, trace
from benchmark.work import kl_barrier, kl_dual, peaks
cell = spec.load("kl_n100_b10k.primal")
cell.config["batch"] = 8
cell.mix["pool"] = 1
for m in cell.per_layer + cell.end_to_end:
    spec.reader(m["name"], cell.root)
r = harness.run_cell(cell, 5, 0.1, True, torch.device("cpu"),
                     time.perf_counter())
assert r.correct
cell = spec.load("kl_n100_b10k.certified")
cell.config["batch"] = 8
r = harness.run_cell(cell, 5, 0.1, False, torch.device("cpu"),
                     time.perf_counter())
assert r.correct
# the yardstick is the benchmark's own copy, not the program's
assert "cvx_tpu_torch._bench" not in sys.modules
""" + NAMES

REFERENCE = """
import sys, torch
sys.path.insert(0, ROOT_DIR)
from benchmark.reference import certificate, judge, kl_projection
H = torch.zeros((2, 10), dtype=torch.float64)
H[0, :3] = -1.0
H[1, 5:] = 1.0
u = torch.tensor([[-0.4, 0.7]], dtype=torch.float64)
s = kl_projection.solve(H, u)
certificate.kl_gap_certificate(s["x"].numpy(), H.numpy(), u.numpy())
""" + NAMES


def loaded(code):
    p = subprocess.run([sys.executable, "-c",
                        code.replace("ROOT_DIR", repr(str(ROOT)))],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    names = loaded(RUN)
    assert "cvx_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "cvx_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert not names & {"cvx_tpu_torch", "cvx_tpu", "jax", "jaxlib", "flax"}
