"""Port parity for K4: ``cvx_tpu_torch.ops.chol`` (the plain PyTorch
version of the blocked Cholesky kernel, which the wrapper runs for CPU
tensors, and the dispatcher) against ``cvx_tpu.ops.pallas_chol`` (the
Pallas kernel in interpret mode and the XLA route), on the same SPD
matrices made with numpy from fixed seeds.

Tolerances: in f64 the factors agree to max |dL| <= 1e-10 at condition
1e6 (tests/test_parallel.py::TestPallasCholesky holds the reference to
the same against XLA); in f32 to 1e-4 relative to max |L| at condition
1e3; L L^T reproduces X to 1e-12 (f64) and 1e-5 (f32) relative to |X|.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.ops.pallas_chol import cholesky_batched as ref_cholesky
from cvx_tpu.ops.pallas_chol import cholesky_batched_pallas
from cvx_tpu_torch.ops import chol
from cvx_tpu_torch.ops.chol import (cholesky_batched, cholesky_batched_cuda,
                                    cholesky_batched_plain, held_max_n,
                                    max_n)


def _spd(B, n, cond, seed=0):
    """B random SPD matrices with eigenvalues spread over [1/cond, 1]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((B, n, n)))
    lam = np.logspace(-np.log10(cond), 0.0, n)
    X = (Q * lam[None, None, :]) @ Q.transpose(0, 2, 1)
    return 0.5 * (X + X.transpose(0, 2, 1))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n", [20, 50, 64])
def test_plain_matches_reference_kernel(n):
    # tests/test_parallel.py::TestPallasCholesky::test_matches_xla, with an
    # odd batch (the reference pads it to its tile, the port does not)
    X = _spd(5, n, 1e6, seed=n)
    L_ref = np.asarray(cholesky_batched_pallas(jnp.asarray(X), bk=16, bt=2,
                                               interpret=True))
    L = cholesky_batched_plain(torch.from_numpy(X)).numpy()
    assert L.shape == (5, n, n)
    assert np.max(np.abs(L - L_ref)) < 1e-10
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))
    recon = L @ L.transpose(0, 2, 1)
    assert np.max(np.abs(recon - X)) <= 1e-12 * np.max(np.abs(X))


@pytest.mark.timeout(60)
@pytest.mark.parametrize("n", [10, 33, 77])
def test_plain_f32_and_ragged_blocks(n):
    # n = 33 and 77: a ragged last column block; f32 against the f64
    # factor of the same matrices
    X = _spd(3, n, 1e3, seed=n)
    L64 = np.linalg.cholesky(X)
    L = cholesky_batched_plain(torch.from_numpy(X.astype(np.float32)))
    assert L.dtype == torch.float32
    assert np.max(np.abs(L.numpy() - L64)) <= 1e-4 * np.max(np.abs(L64))
    Lr = L.double().numpy()
    assert np.max(np.abs(Lr @ Lr.transpose(0, 2, 1) - X)) <= \
        1e-5 * np.max(np.abs(X))


@pytest.mark.timeout(60)
def test_dispatcher_methods_agree_with_reference():
    X = _spd(7, 24, 1e4, seed=1)
    L_xla = np.asarray(ref_cholesky(jnp.asarray(X), method="xla"))
    Xt = torch.from_numpy(X)
    for method in ("torch", "cuda"):
        L = cholesky_batched(Xt, method=method).numpy()
        assert np.max(np.abs(L - L_xla)) < 1e-12, method
    assert torch.equal(cholesky_batched(Xt),
                       cholesky_batched(Xt, method="torch"))
    with pytest.raises(ValueError, match="unknown cholesky method"):
        ref_cholesky(jnp.asarray(X), method="nope")
    with pytest.raises(ValueError, match="unknown cholesky method"):
        cholesky_batched(Xt, method="nope")


@pytest.mark.timeout(60)
def test_non_spd_lane_is_nan_and_the_others_are_not():
    X = _spd(4, 40, 1e2, seed=2)
    X[2, 5, 5] = -1.0                   # lane 2 fails at pivot 5
    L_xla = np.asarray(ref_cholesky(jnp.asarray(X), method="xla"))
    L_pal = np.asarray(cholesky_batched_pallas(jnp.asarray(X), bk=16, bt=2,
                                               interpret=True))
    Xt = torch.from_numpy(X)
    L_torch = cholesky_batched(Xt, method="torch").numpy()
    L_cuda = cholesky_batched(Xt, method="cuda").numpy()
    ok = np.array([0, 1, 3])
    for L, L_r in ((L_torch, L_xla), (L_cuda, L_pal)):
        assert np.all(np.isfinite(L[ok]))
        assert np.max(np.abs(L[ok] - L_r[ok])) < 1e-10
        # NaN exactly where the reference's route has it
        assert np.array_equal(np.isnan(L[2]), np.isnan(L_r[2]))
        assert np.isnan(L[2]).any()


# The NaN contract the CUDA kernel is held to on the card (chip_smoke.py
# phase 3 compares its NaN pattern with the plain version's): a pivot that
# is not positive makes exactly the lower triangle from its column on NaN.
# n = 40 has a ragged last column block (32 + 8) in the port's bk = 32.
@pytest.mark.timeout(120)
@pytest.mark.parametrize("where", ["failed pivot in column 0",
                                   "zero pivot in column 20",
                                   "failed pivot in the last block"])
def test_failed_pivot_nans_the_lower_triangle_from_its_column_on(where):
    n = 40
    X = _spd(3, n, 1e2, seed=4)
    if where.startswith("zero"):
        k = 20                  # row and column 20 zero: the pivot is 0
        X[1, k, :] = 0.0
        X[1, :, k] = 0.0
    else:
        k = 0 if "column 0" in where else 37
        X[1, k, k] = -1.0
    L_pal = np.asarray(cholesky_batched_pallas(jnp.asarray(X), bk=16, bt=2,
                                               interpret=True))
    L = cholesky_batched_plain(torch.from_numpy(X)).numpy()
    rows, cols = np.indices((n, n))
    expected = (rows >= cols) & (cols >= k)
    assert np.array_equal(np.isnan(L[1]), expected)
    assert np.array_equal(np.isnan(L_pal[1]), expected)
    ok = np.array([0, 2])
    assert np.all(np.isfinite(L[ok]))
    assert np.max(np.abs(L[ok] - L_pal[ok])) < 1e-10
    # the columns before k are those of the leading k x k factor
    L_lead = np.linalg.cholesky(X[1, :k, :k]) if k else np.zeros((0, 0))
    assert np.max(np.abs(L[1, :k, :k] - L_lead), initial=0.0) < 1e-10
    assert np.array_equal(np.triu(L[1], 1), np.zeros((n, n)))


@pytest.mark.timeout(30)
def test_wrapper_checks_and_counts():
    before = cholesky_batched_cuda.launches
    X = torch.from_numpy(_spd(2, 8, 10.0))
    assert torch.equal(cholesky_batched_cuda(X), cholesky_batched_plain(X))
    assert cholesky_batched_cuda.launches == before  # CPU: no kernel
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        cholesky_batched_cuda(X[:, :, :7])
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        cholesky_batched_plain(X[0])


@pytest.mark.timeout(30)
def test_wrapper_limits_mirror_the_kernel_source():
    # the wrapper refuses what the C launcher refuses, and the plain
    # version blocks as the kernel does: the constants of csrc/chol.cu
    src = (Path(chol.__file__).parent / "csrc" / "chol.cu").read_text()
    const = {m[1]: int(m[2]) for m in
             re.finditer(r"constexpr int (k\w+) = (\d+);", src)}
    assert chol._BK == const["kBk"]
    assert held_max_n(torch.float32) == const["kHeldMaxN"]
    assert held_max_n(torch.float64) == const["kHeldMaxNF64"]
    assert max_n(torch.float32) == const["kMaxN"] == 1760
    assert max_n(torch.float64) == const["kMaxNF64"] == 880
    assert held_max_n(torch.float32) < max_n(torch.float32)
    assert held_max_n(torch.float64) < max_n(torch.float64)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n", [257, 300])
def test_plain_on_the_panel_range_matches_reference(n):
    # n > held_max_n: the CUDA kernel's panel path; 257 ends in a ragged
    # column block of 1 column, 300 in one of 12.  f64 at condition 1e6
    # against the reference's XLA route and LAPACK's factor (other
    # orders), to 1e-10 relative as the module's docstring states
    X = _spd(2, n, 1e6, seed=n)
    L = cholesky_batched_plain(torch.from_numpy(X)).numpy()
    L_xla = np.asarray(ref_cholesky(jnp.asarray(X), method="xla"))
    L_np = np.linalg.cholesky(X)
    for L_ref in (L_xla, L_np):
        assert np.max(np.abs(L - L_ref)) <= 1e-10 * np.max(np.abs(L_ref))
    assert np.array_equal(np.triu(L, 1), np.zeros_like(L))
    recon = L @ L.transpose(0, 2, 1)
    assert np.max(np.abs(recon - X)) <= 1e-12 * np.max(np.abs(X))
