"""The CUDA kernels K1 ``kl_dual_fused`` and K2 ``kl_dual_fused_cert`` on
the card: each against its plain PyTorch version on the same CUDA inputs,
the wrappers' refusals, and the launch counters.

Every test here needs a CUDA device (the kernels have no CPU mode), carries
the ``cuda`` marker and skips without one.  The file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 K1 max |dx| <= 1e-5 on converged lanes (the f32 gap
floor), f64 K1 <= 1e-9 (summation order only), and K1's z within 1e-4
(f32) / 1e-8 (f64) of the plain z, relative to 1 + |z|.  K2 on certified
lanes (both ends polished to f64 rounding): max |dx| <= 1e-11, |dgap| <=
1e-10, z within 1e-9 relative to 1 + |z|, ineq_res and eq_res within
1e-12.
"""

import numpy as np
import pytest
import torch

from cvx_tpu_torch.ops.kl_dual import (kl_dual_fused, kl_dual_fused_cert,
                                       kl_dual_fused_cert_plain,
                                       kl_dual_fused_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _family(k, m_eq, n, B, seed=0):
    """tests/test_round5.py::_family with B scaled copies of the bounds."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
    x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = rng.uniform(0.0, 1.0, (m_eq, n))
    U = np.stack([u * s for s in np.linspace(1.0, 1.1, B)])
    return H, U, A, np.broadcast_to(A @ x0, (B, m_eq))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("k,m_eq,dtype", [(2, 0, torch.float32),
                                          (5, 2, torch.float32),
                                          (13, 2, torch.float64)])
def test_kernels_match_plain(dev, k, m_eq, dtype):
    B = 64
    H, U, A, R = _family(k, m_eq, 24, B)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    Hs = t(H)[None].expand(B, -1, -1)           # stride-0 batch, read in place
    As = t(A)[None].expand(B, -1, -1) if m_eq else None
    Rs = t(R) if m_eq else None
    x, g, z = kl_dual_fused(Hs, t(U), As, Rs)
    xp, gp, zp = kl_dual_fused_plain(Hs, t(U), As, Rs)
    tol, ztol = (1e-5, 1e-4) if dtype == torch.float32 else (1e-9, 1e-8)
    conv = gp.abs() <= tol
    assert bool(conv.any())
    assert float((x - xp)[conv].abs().max()) <= tol
    assert float(((z - zp) / (1.0 + zp.abs()))[conv].abs().max()) <= ztol
    if dtype == torch.float32:
        xc, zc, gc, ic, ec = kl_dual_fused_cert(Hs, t(U), As, Rs)
        xq, zq, gq, iq, eq = kl_dual_fused_cert_plain(Hs, t(U), As, Rs)
        ok = gq.abs() <= 1e-8
        assert bool(ok.any())
        assert float((xc - xq)[ok].abs().max()) <= 1e-11
        assert float((gc - gq)[ok].abs().max()) <= 1e-10
        assert float(((zc - zq) / (1.0 + zq.abs()))[ok].abs().max()) <= 1e-9
        assert float((ic - iq)[ok].abs().max()) <= 1e-12
        assert float((ec - eq)[ok].abs().max()) <= 1e-12


@pytest.mark.timeout(600)
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    H = torch.zeros((2, 1, 8), device=dev)
    U = torch.zeros((2, 1), device=dev)
    with pytest.raises(ValueError, match="f32/f64 CUDA"):
        kl_dual_fused(H.half(), U.half())
    with pytest.raises(ValueError, match="contiguous"):
        kl_dual_fused(torch.zeros((2, 1, 16), device=dev)[:, :, ::2], U)
    with pytest.raises(ValueError, match="must be on"):
        kl_dual_fused(H, U, log_prior=torch.zeros(8))
    with pytest.raises(ValueError, match="takes torch.float32"):
        kl_dual_fused_cert(H.double(), U.double())
    with pytest.raises(ValueError, match="float64 log_prior"):
        kl_dual_fused_cert(H, U, log_prior=torch.zeros(8, device=dev))


@pytest.mark.timeout(600)
def test_launch_counters_count_kernel_launches_only(dev):
    H = torch.tensor([[[-1.0, -1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 1.0]]],
                     device=dev)
    U = torch.tensor([[-0.6, 0.3]], device=dev)
    k1, k2 = kl_dual_fused.launches, kl_dual_fused_cert.launches
    kl_dual_fused(H, U)
    kl_dual_fused_cert(H, U)
    kl_dual_fused_plain(H, U)
    kl_dual_fused_cert_plain(H, U)
    assert (kl_dual_fused.launches, kl_dual_fused_cert.launches) == (k1 + 1,
                                                                    k2 + 1)
    x, gap, z = kl_dual_fused(H[:0], U[:0])      # empty batch: no launch
    assert x.shape == (0, 4) and z.shape == (0, 3)
    assert kl_dual_fused.launches == k1 + 1
    torch.cuda.synchronize()
