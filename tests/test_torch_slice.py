"""The port's slices end to end against the reference, on bench.py's
family (P(A) >= pA with |A| = 3, P(B) <= pB) through both packages on the
same numpy inputs: the batched certified KL scenario solve
(``DistKL.create(n, H, u) -> solve_certified_batch(U)``), the batched
primal solve (``solve_jittable_batch(U, X0, method="fused")`` against the
reference's ``vmap`` of ``solve_jittable``) and its fallback to
``BR_fast``; the host certificate; the package boundary (no JAX in the
port); and ``chip_smoke.py``'s refusal to run without a GPU.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.diagnostics import kl_gap_certificate_np as ref_certificate
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.diagnostics import kl_gap_certificate_np
from cvx_tpu_torch.interop import solution_to_numpy
from cvx_tpu_torch.ops.kl_dual import kl_dual_fused

ROOT = pathlib.Path(__file__).resolve().parent.parent

# per-leaf tolerances for the certified Solution (f64 leaves, both sides
# polished to f64 rounding from f32 solves that agree to ~1e-6)
LEAF_TOL = {"x": 1e-11, "lam": 1e-9, "nu": 1e-9, "duality_gap": 1e-12,
            "eq_gap": 1e-12, "ineq_res": 1e-12}


# the primal slice's Solution in f32: x and ineq_res to 1e-6 (late Armijo
# decisions at t ~ 1e10 sit at the f32 resolution of the barrier value and
# move x by ~1e-7); the measured gap and its duals from kl_dual_gap's f32
# fit and polish on those x, to 1e-5 absolute and 1e-4 relative to
# 1 + |z|; eq_gap = |sum x - 1| to 2e-6 (f32 sums of 100 terms)
PRIMAL_TOL = {"x": 1e-6, "ineq_res": 1e-6, "duality_gap": 1e-5,
              "eq_gap": 2e-6}
PRIMAL_ZTOL = 1e-4
PRODUCTION = dict(max_iter=3, mu=55.0, tol=1e-8)   # bench.py's schedule


def _bench_family(B, n, seed=0):
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B]).astype(np.float32)
    U = np.column_stack([-rng.uniform(0.2, 0.5, B),
                         rng.uniform(0.55, 0.8, B)]).astype(np.float32)
    return H, U


def _feasible_points(U, n):
    """bench.py:164-168: weight pA + 0.05 on A, the rest spread evenly."""
    w = -U[:, 0].astype(np.float64) + 0.05
    I_A = np.zeros(n); I_A[:3] = 1.0
    return ((w / 3)[:, None] * I_A
            + ((1 - w) / (n - 3))[:, None] * (1 - I_A)).astype(U.dtype)


@pytest.mark.timeout(90)
@pytest.mark.parametrize("fused_cert", [None, False])
def test_certified_batch_matches_reference(fused_cert):
    n, B = 100, 64
    H, U = _bench_family(B, n)
    ref = RefDistKL.create(n, H=jnp.asarray(H),
                           u=jnp.zeros((2,), jnp.float32), dtype=jnp.float32)
    s_ref = ref.solve_certified_batch(jnp.asarray(U))
    port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(2),
                         device="cpu")
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


@pytest.mark.timeout(120)
def test_primal_slice_matches_reference():
    n, B = 100, 64
    H, U = _bench_family(B, n, seed=3)
    X0 = _feasible_points(U, n)

    def one(u, x0):
        return RefDistKL.create(n, H=jnp.asarray(H), u=u).solve_jittable(
            x0, method="fused", pars=RefParams(**PRODUCTION))

    s_ref = jax.jit(jax.vmap(one))(jnp.asarray(U), jnp.asarray(X0))
    port = DistKL.create(n, H=torch.from_numpy(H), u=torch.zeros(2),
                         device="cpu")
    sol = port.solve_jittable_batch(torch.from_numpy(U),
                                    torch.from_numpy(X0), method="fused",
                                    pars=SolverParams(**PRODUCTION))
    got = solution_to_numpy(sol)
    for leaf, ref_val in vars(s_ref).items():
        a, b = got[leaf], np.asarray(ref_val)
        assert a.shape == b.shape and a.dtype == b.dtype, leaf
        if leaf in PRIMAL_TOL:
            assert np.max(np.abs(a - b)) <= PRIMAL_TOL[leaf], leaf
        elif leaf in ("lam", "nu"):
            assert np.max(np.abs(a - b) / (1.0 + np.abs(b))) <= \
                PRIMAL_ZTOL, leaf
        elif a.dtype.kind == "f":           # unmeasured diagnostics: NaN
            assert np.all(np.isnan(a)) and np.all(np.isnan(b)), leaf
        else:                               # iters and the flags
            assert np.array_equal(a, b), leaf
    assert np.all(got["iters"] == 21) and not got["stalled"].any()
    assert np.max(np.abs(got["duality_gap"])) <= np.sqrt(
        np.finfo(np.float32).eps)
    # the host f64 certificate of the f32 x
    assert np.max(kl_gap_certificate_np(got["x"], H, U)) <= 1e-4
    # solve_jittable is the batch of one
    one_sol = port.solve_jittable(torch.from_numpy(X0[5]), method="fused",
                                  pars=SolverParams(**PRODUCTION))
    port5 = DistKL.create(n, H=torch.from_numpy(H),
                          u=torch.from_numpy(U[5]), device="cpu")
    five = port5.solve_jittable(torch.from_numpy(X0[5]), method="fused",
                                pars=SolverParams(**PRODUCTION))
    assert torch.equal(five.x, sol.x[5])
    assert one_sol.x.shape == (n,) and int(one_sol.iters) == 21


@pytest.mark.timeout(60)
def test_fused_falls_back_to_br_fast_on_three_rows():
    # tests/test_round2.py::TestFusedFallback::test_k3_falls_back_to_
    # structured and tests/test_kl.py::TestFusedRoute
    n = 24
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    I_C = np.zeros(n); I_C[5:9] = 1.0
    H, u = np.stack([-I_A, I_B, I_C]), np.array([-0.2, 0.8, 0.9])
    x0 = np.where(I_A > 0, 0.25 / 3, 0.75 / (n - 3))
    ref = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.asarray(u))
    port = DistKL.create(n, H=torch.from_numpy(H), u=torch.from_numpy(u),
                         device="cpu")
    s_ref = ref.solve_jittable(jnp.asarray(x0), method="fused")
    s = port.solve_jittable(torch.from_numpy(x0), method="fused")
    assert torch.equal(s.x, port.solve_jittable(torch.from_numpy(x0),
                                                method="BR_fast").x)
    assert np.max(np.abs(s.x.numpy() - np.asarray(s_ref.x))) <= 1e-8
    assert float(s.duality_gap) < 1e-7
    assert abs(float(s.x.sum()) - 1.0) < 1e-8
    assert bool(s.stalled) == bool(s_ref.stalled) is False
    # the fused route itself against BR_fast on one row (test_kl.py:208)
    one = DistKL.create(16, H=torch.from_numpy(-I_A[None, :16]),
                        u=torch.tensor([-0.4], dtype=torch.float64),
                        device="cpu")
    x1 = torch.from_numpy(np.where(np.arange(16) < 3, 0.5 / 3, 0.5 / 13))
    fused = one.solve(method="fused", feasible_point=x1)
    assert float((fused.x - one.solve_jittable(x1, method="BR_fast").x)
                 .abs().max()) < 1e-4
    assert float(fused.eq_gap) < 1e-6


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
