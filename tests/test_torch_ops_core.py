"""Port parity for the dense numerics core: ``cvx_tpu_torch.ops``
(equilibrate, cholesky, eigsolve, nullspace, kkt) against ``cvx_tpu.ops``,
mirroring ``tests/test_ops_core.py`` (MatrixUtilsTests.scala,
KktTest.scala): systems with known solutions, ill-conditioning up to
cond 1e14 with adversarial right-hand sides, singular and zero Hessians,
and a batch against the reference vmapped over the same numpy inputs.

Tolerances: both packages run the same algorithm in f64, so a
well-conditioned solve agrees to 1e-12 relative; an ill-conditioned one
to cond * 1e-13 relative (rounding amplified by the condition number),
and each must meet the reference test's own backward-error bound.  A
non-finite or non-positive-definite input gives NaN in the port, as XLA
does, and never raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu import ops as rops
from cvx_tpu_torch import ops

RNG = np.random.default_rng


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / (1.0 + np.linalg.norm(b)))


def _orth(rng, n):
    Q, R = np.linalg.qr(rng.standard_normal((n, n)))
    return Q * np.sign(np.diag(R))


def _spd(rng, n, cond, kernel=0):
    """U diag(d) U^T with a log-spaced spectrum of condition ``cond`` and
    ``kernel`` zero eigenvalues."""
    U = _orth(rng, n)
    d = np.logspace(0, -np.log10(cond), n)
    if kernel:
        d[-kernel:] = 0.0
    H = (U * d) @ U.T
    return 0.5 * (H + H.T), U, d


def _nasty(rng, d, U):
    """A right-hand side loaded on the small singular directions
    (the reference's testmat.nasty_rhs idea)."""
    w = np.where(d > 0, 1.0 / np.sqrt(np.maximum(d, 1e-300)), 0.0)
    return U @ (w * rng.standard_normal(len(d)) / np.max(w))


class TestRuiz:
    def test_identity_and_zero_row(self):
        for H in (np.eye(5), np.diag([1.0, 0.0, 3.0])):
            d, Q = ops.ruiz_equilibrate(_t(H))
            dr, Qr = rops.ruiz_equilibrate(jnp.asarray(H))
            assert torch.isfinite(d).all() and torch.isfinite(Q).all()
            assert np.max(np.abs(_np(d) - _np(dr))) <= 1e-14
            assert np.max(np.abs(_np(Q) - _np(Qr))) <= 1e-14

    def test_reduces_condition_number_batched(self):
        # test_ops_core.py::TestRuiz::test_reduces_condition_number, on a
        # batch of three: the convergent loop stops per matrix
        rng = RNG(0)
        Hs = []
        for k in range(3):
            H, _, _ = _spd(rng, 40, 1e10)
            s = 10.0 ** np.linspace(-4 + k, 4 - k, 40)
            Hs.append((s[:, None] * H) * s[None, :])
        Hs = np.stack(Hs)
        d, Q = ops.ruiz_equilibrate(_t(Hs))
        dr, Qr = jax.vmap(rops.ruiz_equilibrate)(jnp.asarray(Hs))
        assert np.max(np.abs(_np(d) - _np(dr)) / np.abs(_np(dr))) <= 1e-12
        for i in range(3):
            assert np.linalg.cond(_np(Q)[i]) < np.linalg.cond(Hs[i]) / 100
        rn = np.linalg.norm(_np(Q), axis=2)
        assert np.max(np.abs(rn - 1.0)) < 1e-3
        d4, _ = ops.ruiz_equilibrate(_t(Hs), sweeps=4)
        d4r, _ = jax.vmap(lambda h: rops.ruiz_equilibrate(h, sweeps=4))(
            jnp.asarray(Hs))
        assert np.max(np.abs(_np(d4) - _np(d4r)) / np.abs(_np(d4r))) <= 1e-13


class TestTriangular:
    def test_forward_back_roundtrip(self):
        rng = RNG(1)
        n = 30
        L = np.tril(rng.standard_normal((n, n))) + 3.0 * np.eye(n)
        x0 = rng.standard_normal(n)
        x = ops.forward_solve(_t(L), _t(L @ x0))
        assert _rel(x, x0) < 1e-10
        assert _rel(x, rops.forward_solve(jnp.asarray(L),
                                          jnp.asarray(L @ x0))) < 1e-14
        x = ops.back_solve(_t(L.T), _t(L.T @ x0))
        assert _rel(x, x0) < 1e-10
        X0 = rng.standard_normal((n, 3))
        X = ops.tri_solve(_t(L), _t(L.T @ X0), trans=True)
        assert _rel(X, X0) < 1e-10


class TestCholeskySolve:
    @pytest.mark.parametrize("cond", [1e2, 1e8, 1e12])
    def test_known_solution(self, cond):
        rng = RNG(2)
        n = 50
        H, _, _ = _spd(rng, n, cond)
        x0 = rng.standard_normal(n)
        x, relres = ops.cholesky_solve(_t(H), _t(H @ x0))
        xr, rr = rops.cholesky_solve(jnp.asarray(H), jnp.asarray(H @ x0))
        assert float(relres) < 1e-8
        assert _rel(x, x0) < min(0.2, max(1e-8, cond * 1e-16 * 1e4))
        assert _rel(x, xr) <= max(1e-12, cond * 1e-13)

    def test_nasty_rhs_cond_1e8(self):
        rng = RNG(3)
        H, U, d = _spd(rng, 60, 1e8)
        b = _nasty(rng, d, U)
        x, relres = ops.cholesky_solve(_t(H), _t(b))
        assert float(relres) < 1e-8

    def test_nasty_rhs_cond_1e14_ladder(self):
        rng = RNG(4)
        H, U, d = _spd(rng, 60, 1e14)
        b = _nasty(rng, d, U)
        x, relres = ops.sym_solve(_t(H), _t(b), method="ladder", tol=1e-10)
        _, rr = rops.sym_solve(jnp.asarray(H), jnp.asarray(b),
                               method="ladder", tol=1e-10)
        assert float(relres) < 3e-2
        # the same stage decides: both residuals on the same side of tol
        assert (float(relres) <= 1e-10) == (float(rr) <= 1e-10)

    def test_singular_escalates_to_eig(self):
        rng = RNG(5)
        H, U, d = _spd(rng, 40, 1e6, kernel=5)
        b = _nasty(rng, np.where(d > 1e-10 * d[0], d, 0.0), U)
        x, relres = ops.sym_solve(_t(H), _t(b), method="ladder", tol=1e-8)
        xr, rr = rops.sym_solve(jnp.asarray(H), jnp.asarray(b),
                                method="ladder", tol=1e-8)
        assert float(relres) < 1e-7 and float(rr) < 1e-7
        # H is singular, so x is not unique: hold the same stage decision
        assert (float(relres) <= 1e-8) == (float(rr) <= 1e-8)

    def test_failed_factorization_is_nan_not_an_error(self):
        # lax.linalg.cholesky returns NaN where torch.linalg.cholesky
        # raises; the solvers' finiteness guards rely on the NaN
        H = np.stack([np.eye(4), -np.eye(4), np.full((4, 4), np.nan)])
        L, shift = ops.regularized_cholesky(_t(H))
        ok = torch.isfinite(L).all(dim=(1, 2))
        assert ok.tolist() == [True, False, False]
        x, rel = ops.cholesky_solve(_t(H), _t(np.ones((3, 4))))
        assert torch.isfinite(x).all(dim=1).tolist() == [True, False, False]
        for solve in (ops.sym_solve_eig, ops.svd_solve):
            x, _ = solve(_t(H), _t(np.ones((3, 4))))
            assert torch.isfinite(x).all(dim=1).tolist() == [True, True,
                                                             False]
        ss = ops.solution_space(_t([[np.nan, 1.0, 0.0]]), _t([1.0]))
        assert torch.isnan(ss.z0).all() and torch.isnan(ss.F).all()


class TestEigSolve:
    def test_spd_exact(self):
        rng = RNG(6)
        H, _, _ = _spd(rng, 30, 1e4)
        x0 = rng.standard_normal(30)
        x, relres = ops.sym_solve_eig(_t(H), _t(H @ x0))
        assert _rel(x, x0) < 1e-8 and float(relres) < 1e-10
        xr, _ = rops.sym_solve_eig(jnp.asarray(H), jnp.asarray(H @ x0))
        assert _rel(x, xr) < 1e-11

    def test_indefinite_and_svd(self):
        rng = RNG(7)
        U = _orth(rng, 30)
        d = np.linspace(-2.0, 3.0, 30)
        d = np.where(np.abs(d) < 0.1, 0.5, d)
        H = (U * d) @ U.T
        x0 = rng.standard_normal(30)
        x, _ = ops.sym_solve_eig(_t(H), _t(H @ x0))
        assert _rel(x, x0) < 1e-8
        A = rng.standard_normal((30, 30))
        x, relres = ops.svd_solve(_t(A), _t(A @ x0))
        xr, rr = rops.svd_solve(jnp.asarray(A), jnp.asarray(A @ x0))
        assert _rel(x, x0) < 1e-8 and _rel(x, xr) < 1e-10
        x, _ = ops.lin_solve(_t(A), _t(A @ x0))
        assert _rel(x, x0) < 1e-8


class TestKKT:
    def _roundtrip(self, seed, n, p, cond, method, hess_kernel=0):
        rng = RNG(seed)
        H, _, _ = _spd(rng, n, cond, kernel=hess_kernel)
        A = rng.standard_normal((p, n))
        x0 = rng.standard_normal(n)
        w0 = rng.standard_normal(p)
        q = -(H @ x0 + A.T @ w0)
        b = A @ x0
        x, w, relres = ops.kkt_solve(_t(H), _t(A), _t(q), _t(b),
                                     method=method)
        xr, wr, rr = rops.kkt_solve(*(jnp.asarray(v) for v in (H, A, q, b)),
                                    method=method)
        return x, w, relres, x0, w0, xr, wr, rr

    @pytest.mark.parametrize("method", ["chol", "aug", "ladder"])
    def test_pd_roundtrip(self, method):
        x, w, relres, x0, w0, xr, wr, _ = self._roundtrip(8, 40, 8, 1e6,
                                                          method)
        assert float(relres) < 1e-8
        assert _rel(x, x0) < 1e-6 and _rel(w, w0) < 1e-6
        assert _rel(x, xr) < 1e-9 and _rel(w, wr) < 1e-9

    @pytest.mark.parametrize("method", ["aug", "ladder"])
    def test_singular_h(self, method):
        x, w, relres, *_ = self._roundtrip(9, 40, 8, 1e4, method,
                                           hess_kernel=6)
        assert float(relres) < 1e-7

    def test_zero_hessian_lp(self):
        rng = RNG(10)
        n, p = 10, 4
        A = rng.standard_normal((p, n))
        x0, w0 = rng.standard_normal(n), rng.standard_normal(p)
        x, w, relres = ops.kkt_solve(_t(np.zeros((n, n))), _t(A),
                                     _t(-(A.T @ w0)), _t(A @ x0),
                                     method="aug")
        assert float(relres) < 1e-7

    def test_ill_conditioned_1e12(self):
        _, _, relres, *_ = self._roundtrip(11, 60, 12, 1e12, "aug")
        assert float(relres) < 1e-6

    def test_no_equalities_is_a_symmetric_solve(self):
        rng = RNG(12)
        H, _, _ = _spd(rng, 10, 1e3)
        q = rng.standard_normal(10)
        x, w, relres = ops.kkt_solve(_t(H), _t(np.zeros((0, 10))), _t(q),
                                     _t(np.zeros(0)))
        assert w.shape == (0,) and _rel(x, np.linalg.solve(H, -q)) < 1e-10

    @pytest.mark.parametrize("shared_a", [False, True])
    def test_batched_vmap(self, shared_a):
        # test_ops_core.py::TestKKT::test_batched_vmap: 16 instances in
        # one call, against the reference vmapped; A shared or per instance
        rng = RNG(13)
        B, n, p = 16, 20, 4
        H = np.stack([_spd(rng, n, 1e5)[0] for _ in range(B)])
        A = rng.standard_normal((p, n) if shared_a else (B, p, n))
        x0, w0 = rng.standard_normal((B, n)), rng.standard_normal((B, p))
        AT = np.swapaxes(A, -1, -2)
        q = -(np.einsum("bij,bj->bi", H, x0) + (w0 @ A if shared_a else
                                                np.einsum("bij,bj->bi", AT,
                                                          w0)))
        b = x0 @ A.T if shared_a else np.einsum("bij,bj->bi", A, x0)
        x, w, relres = ops.kkt_solve(_t(H), _t(A), _t(q), _t(b))
        Ab = np.broadcast_to(A, (B, p, n))
        xr, wr, rr = jax.vmap(rops.kkt_solve)(*(jnp.asarray(v) for v in
                                                (H, Ab, q, b)))
        assert float(relres.max()) < 1e-7
        assert np.max(np.abs(_np(x) - x0)) < 1e-5
        assert np.max(np.abs(_np(x) - _np(xr))) < 1e-9
        assert np.max(np.abs(_np(w) - _np(wr))) < 1e-9


class TestNullspace:
    def test_solution_space(self):
        rng = RNG(14)
        p, n = 4, 12
        A = rng.standard_normal((p, n))
        b = rng.standard_normal(p)
        ss = ops.solution_space(_t(A), _t(b))
        ref = rops.solution_space(jnp.asarray(A), jnp.asarray(b))
        z0, F = _np(ss.z0), _np(ss.F)
        assert np.linalg.norm(A @ z0 - b) < 1e-10
        assert np.linalg.norm(A @ F) < 1e-10
        assert np.allclose(F.T @ F, np.eye(n - p), atol=1e-10)
        # the minimum-norm point is unique; the basis spans the same space
        assert np.max(np.abs(z0 - _np(ref.z0))) < 1e-12
        assert np.max(np.abs(F @ F.T - _np(ref.F) @ _np(ref.F).T)) < 1e-12
        # parameter() round-trips points of the affine space, batched
        u = rng.standard_normal((3, n - p))
        assert np.max(np.abs(_np(ss.parameter(ss.point(_t(u)))) - u)) < 1e-10


class TestMiscHelpers:
    def test_hs_norm_symmetry_condition(self):
        rng = RNG(15)
        A = rng.standard_normal((5, 5))
        assert abs(float(ops.hs_norm(_t(A))) - np.linalg.norm(A)) < 1e-12
        assert bool(ops.check_symmetric(_t(A + A.T)))
        assert not bool(ops.check_symmetric(_t(A)))
        H, _, _ = _spd(rng, 20, 1e6)
        c = float(ops.condition_number(_t(H)))
        assert 1e5 < c < 1e7
        assert abs(c / float(rops.condition_number(jnp.asarray(H))) - 1) \
            < 1e-8
