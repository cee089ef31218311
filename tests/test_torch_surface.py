"""The port's public surface against the reference's, and the Ruiz
variants of ``ops.equilibrate``.

* Every name that ``cvx_tpu/__init__.py`` imports, every name in the
  ``__all__`` of the reference's ``models``, ``ops``, ``solvers``,
  ``problem`` and ``parallel``, and every public top-level function and
  class of every module of ``cvx_tpu`` (found by AST, so JAX is not
  imported for it) exists at the same path in ``cvx_tpu_torch``, except
  for the omissions and renames listed below with their reasons.
* ``import cvx_tpu_torch`` in a fresh process builds no kernel, starts no
  process (nvcc or rank), starts no process group, leaves CUDA
  uninitialised and imports no JAX.
* ``TestRuizVariants`` mirrors ``tests/test_round3.py::TestRuizVariants``
  (:528): ``ruiz_equilibrate0`` and ``apply_equilibration`` match the
  reference within 1e-12 (f64, relative to the largest entry) on
  numpy-seeded SPD matrices of condition 1e6, 1e10 and 1e14, and the
  study's ratio property holds for the port's two variants.
"""

import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.ops import equilibrate as ref_eq
from cvx_tpu_torch.ops import (apply_equilibration, condition_number,
                               ruiz_equilibrate, ruiz_equilibrate0)

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "cvx_tpu"

# reference module -> port module where the port's file has another name:
# the TPU kernels' modules are named for Pallas, the port's for the kernel
RENAMED_MODULES = {
    "cvx_tpu.ops.pallas_chol": "cvx_tpu_torch.ops.chol",
    "cvx_tpu.ops.pallas_kl": "cvx_tpu_torch.ops.kl_barrier",
    "cvx_tpu.ops.pallas_kl_dual": "cvx_tpu_torch.ops.kl_dual",
}
# (module, name) -> the port's name for it
RENAMED = {
    ("cvx_tpu.ops.pallas_chol", "cholesky_batched_pallas"):
        "cholesky_batched_cuda",      # the kernel is CUDA, not Pallas
    ("cvx_tpu.ops", "cholesky_batched_pallas"): "cholesky_batched_cuda",
    ("cvx_tpu.tree", "mxu_exact"): "exact_f32",   # the f32-exact guard
}
# reference modules and names with no counterpart, on purpose
OMITTED_MODULES = {
    # double-single f32 arithmetic for K2's epilogue on a TPU without f64:
    # the H100's K2 runs its polish and certificate in native f64
    "cvx_tpu.ops.ds",
    # a blocked Cholesky in XLA, not Pallas, recorded in its own docstring
    # as a negative result, with no production caller: the counterpart is
    # torch.linalg.cholesky (and K4 for batched small factors)
    "cvx_tpu.ops.blocked_chol",
    # the TPU kernels' lane padding; the CUDA launchers need none
    "cvx_tpu.ops._pad",
}
OMITTED = {
    # JAX pytree registration of a dataclass; the port's dataclasses are
    # plain and ``cvx_tpu_torch.tree`` flattens them by their fields
    ("cvx_tpu.tree", "pytree_dataclass"),
}


def _ref_modules():
    for path in sorted(REF.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _public_defs(path):
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _init_names(path):
    """Names an ``__init__.py`` imports and its ``__all__``."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif (isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", None) == "__all__"):
            names += [e.value for e in node.value.elts]
    return sorted(set(names))


def _port_name(module):
    return RENAMED_MODULES.get(module, "cvx_tpu_torch" + module[7:])


def _missing(module, names):
    port = importlib.import_module(_port_name(module))
    return [n for n in names if (module, n) not in OMITTED
            and not hasattr(port, RENAMED.get((module, n), n))]


MODULES = [m for m, _ in _ref_modules() if m not in OMITTED_MODULES]


def test_omission_lists_name_real_reference_code():
    refs = dict(_ref_modules())
    assert OMITTED_MODULES <= set(refs)
    assert set(RENAMED_MODULES) <= set(refs)
    for module, name in list(RENAMED) + list(OMITTED):
        assert name in _public_defs(refs[module]) + _init_names(
            refs[module]), (module, name)


def test_top_level_names():
    names = _init_names(REF / "__init__.py")
    assert {"checkpoint", "diagnostics", "models", "ops", "parallel",
            "problem", "solvers", "testing", "minimize", "load_pytree",
            "resume_barrier", "save_pytree", "solve_dual"} <= set(names)
    assert _missing("cvx_tpu", names) == []
    import cvx_tpu_torch
    for sub in ("checkpoint", "diagnostics", "models", "ops", "parallel",
                "problem", "solvers", "testing"):
        assert getattr(cvx_tpu_torch, sub).__name__ == "cvx_tpu_torch." + sub


@pytest.mark.parametrize("package", ["models", "ops", "solvers", "problem",
                                     "parallel"])
def test_package_all(package):
    module = "cvx_tpu." + package
    names = _init_names(REF / package / "__init__.py")
    assert names
    assert _missing(module, names) == []


@pytest.mark.parametrize("module", MODULES)
def test_module_public_defs(module):
    path = dict(_ref_modules())[module]
    assert _missing(module, _public_defs(path)) == []


_FRESH = r"""
import json, subprocess, sys
started = []
real = subprocess.Popen.__init__
def spy(self, *a, **k):
    started.append(str(a[0] if a else k.get("args")))
    real(self, *a, **k)
subprocess.Popen.__init__ = spy
import torch
before = set(sys.modules)
import cvx_tpu_torch
from cvx_tpu_torch.ops import _build
print(json.dumps(dict(
    started=started, libs=sorted(_build._libs),
    cuda=torch.cuda.is_initialized(),
    group=torch.distributed.is_available()
    and torch.distributed.is_initialized(),
    jax=sorted(m for m in set(sys.modules) - before
               if m.split(".")[0] in ("jax", "jaxlib", "cvx_tpu")))))
"""


def test_import_starts_nothing():
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == dict(started=[], libs=[], cuda=False, group=False,
                       jax=[]), got


def _spd(n, cond, seed):
    """A numpy SPD matrix with eigenvalues log-spaced from 1 to ``cond``
    in a random orthogonal basis."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = (Q * np.logspace(0.0, np.log10(cond), n)) @ Q.T
    return 0.5 * (H + H.T)


class TestRuizVariants:
    """tests/test_round3.py::TestRuizVariants (:528), on numpy inputs
    given to both packages."""

    @pytest.mark.parametrize("cond", [1e6, 1e10, 1e14])
    def test_matches_reference(self, cond):
        Hs = np.stack([_spd(64, cond, seed) for seed in range(8)])
        b = np.random.default_rng(1).standard_normal((8, 64))
        d, Q = ruiz_equilibrate0(torch.tensor(Hs))
        db = apply_equilibration(d, torch.tensor(b))
        for i in range(len(Hs)):
            rd, rQ = ref_eq.ruiz_equilibrate0(jnp.asarray(Hs[i]))
            rdb = ref_eq.apply_equilibration(rd, jnp.asarray(b[i]))
            for got, ref in ((d[i], rd), (Q[i], rQ), (db[i], rdb)):
                ref = np.asarray(ref)
                err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
                assert err <= 1e-12, (i, err)

    @pytest.mark.parametrize("cond", [1e6, 1e10, 1e14])
    def test_l2_loop_subsumes_linf_variant(self, cond):
        Hs = torch.tensor(np.stack([_spd(64, cond, 100 + seed)
                                    for seed in range(8)]))
        c0 = condition_number(Hs)
        c2 = condition_number(ruiz_equilibrate(Hs)[1])
        cinf = condition_number(ruiz_equilibrate0(Hs)[1])
        assert bool((c2 < 1.1 * c0).all() and (cinf < 1.1 * c0).all())
        assert float((c2 / cinf).max()) < 1.05, c2 / cinf

    def test_zero_rows_keep_scale_one(self):
        H = torch.tensor(_spd(6, 1e3, 3))
        H[2] = 0.0
        H[:, 2] = 0.0
        d, Q = ruiz_equilibrate0(H[None].expand(3, 6, 6), l2_rounds=2)
        rd, _ = ref_eq.ruiz_equilibrate0(jnp.asarray(H.numpy()),
                                         l2_rounds=2)
        assert d.shape == (3, 6) and bool((d[:, 2] == 1.0).all())
        np.testing.assert_allclose(d[1].numpy(), np.asarray(rd),
                                   rtol=1e-12, atol=0)

    def test_variants_agree_on_solve(self):
        H = torch.tensor(_spd(32, 1e8, 7))
        b = torch.tensor(np.random.default_rng(8).standard_normal(32))
        for eq in (ruiz_equilibrate, ruiz_equilibrate0):
            d, Q = eq(H)
            x = d * torch.linalg.solve(Q, apply_equilibration(d, b))
            assert float(torch.linalg.norm(H @ x - b)) < 1e-6 * float(
                torch.linalg.norm(b))
