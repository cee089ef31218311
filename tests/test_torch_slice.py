"""The port's first slice end to end against the reference: the batched
certified KL scenario solve on bench.py's family (P(A) >= pA with |A| = 3,
P(B) <= pB), ``DistKL.create(n, H, u) -> solve_certified_batch(U)``,
through both packages on the same numpy inputs; the host certificate; the
package boundary (no JAX in the port); and ``chip_smoke.py``'s refusal to
run without a GPU.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.diagnostics import kl_gap_certificate_np as ref_certificate
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu_torch import DistKL
from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
from cvx_tpu_torch.interop import solution_to_numpy
from cvx_tpu_torch.ops.kl_dual import kl_dual_fused

ROOT = pathlib.Path(__file__).resolve().parent.parent

# per-leaf tolerances for the certified Solution (f64 leaves, both sides
# polished to f64 rounding from f32 solves that agree to ~1e-6)
LEAF_TOL = {"x": 1e-11, "lam": 1e-9, "nu": 1e-9, "duality_gap": 1e-12,
            "eq_gap": 1e-12, "ineq_res": 1e-12}


def _bench_family(B, n, seed=0):
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B]).astype(np.float32)
    U = np.column_stack([-rng.uniform(0.2, 0.5, B),
                         rng.uniform(0.55, 0.8, B)]).astype(np.float32)
    return H, U


@pytest.mark.timeout(90)
@pytest.mark.parametrize("fused_cert", [None, False])
def test_certified_batch_matches_reference(fused_cert):
    n, B = 100, 64
    H, U = _bench_family(B, n)
    ref = RefDistKL.create(n, H=jnp.asarray(H),
                           u=jnp.zeros((2,), jnp.float32), dtype=jnp.float32)
    s_ref = ref.solve_certified_batch(jnp.asarray(U))
    port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(2))
    got = solution_to_numpy(port.solve_certified_batch(torch.from_numpy(U),
                                                       fused_cert=fused_cert))
    for leaf, ref_val in vars(s_ref).items():
        a, b = got[leaf], np.asarray(ref_val)
        assert a.shape == b.shape, leaf
        if leaf in LEAF_TOL:
            assert np.max(np.abs(a - b)) <= LEAF_TOL[leaf], leaf
        elif a.dtype.kind == "f":           # unmeasured diagnostics: NaN
            assert np.all(np.isnan(a)) and np.all(np.isnan(b)), leaf
        else:                               # iters and the flags
            assert np.array_equal(a, b), leaf
    assert np.max(np.abs(got["duality_gap"])) <= 1e-8
    assert not got["stalled"].any()


@pytest.mark.timeout(60)
def test_host_certificate_matches_reference():
    n, B = 100, 64
    H, U = _bench_family(B, n, seed=1)
    x, gap, _ = kl_dual_fused(torch.from_numpy(H)[None].expand(B, -1, -1),
                              torch.from_numpy(U))
    X = x.numpy()
    ours = kl_gap_certificate_np(X, H, U)
    assert np.array_equal(ours, ref_certificate(X, H, U))
    assert np.max(ours) <= 1e-5                 # K1's f32 x: f32 floor
    w = np.random.default_rng(2).uniform(0.5, 1.5, n)
    p = w / w.sum()
    assert np.array_equal(kl_gap_certificate_np(X, H, U, prior=p),
                          ref_certificate(X, H, U, prior=p))


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.timeout(30)
def test_port_imports_no_jax():
    # an AST scan: sys.modules cannot tell here, because this process
    # already imported jax for the reference
    files = sorted((ROOT / "cvx_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 8
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "cvx_tpu"}, (path, roots)


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.timeout(150)
def test_chip_smoke_refuses_without_gpu(tmp_path):
    # in the checkout without a card, and alone in an empty directory:
    # non-zero exit and no result line either way
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        proc = _run_smoke(cwd, script)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
