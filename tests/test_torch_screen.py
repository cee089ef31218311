"""Port parity for the fleet screen: ``DistKL.feasibility_screen_batch``
and ``kl_feasibility_screen`` of ``cvx_tpu_torch`` against ``cvx_tpu``'s
on the same numpy data.  Mirrors all seven tests of ``tests/
test_round5.py::TestFeasibilityScreen`` (:361-545); ``:443``
(test_agrees_with_generic_phase1) holds the port's screen to the port's
own ``feasibility_batch``.

The screen's schedule is fixed (no data-dependent control flow), so the
port and the reference run the same arithmetic in another order.
Tolerances: the flags exactly; s_lower, s_upper, x and w to 1e-10 in f64
and 1e-5 in f32; and every check of the reference test on the port's
result.

Two families hold the bounds to less, by the screen's design: where a
row and its negative meet in a dual of dim > 3 (the eq-fold's +/- A
pair, the k = 11 "pair" family), the Gauss-Newton matrix is singular
along the pair, the damped solve scales that direction by 1/(64 eps),
and summation-order rounding there is amplified until the logit cap of
10 and the line search take over.  The first step after a stage's
temperature change already moves w by 5e-10 (f64, eq-fold; the
reference and the port agree to 0 before it), and the final bounds
differ by 4.4e-10 (f64, eq-fold) and 2.4e-5 (f32, k = 11).  Both runs
are valid certificates, so for those two (``sound=True``) the flags are
held exactly and each bound to the other run's certified interval:
s_lower of one <= s_upper of the other, in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.models import FeasibilityScreen, kl_feasibility_screen

# Tier-1 runs six test processes on the CPU's cores, and every process
# imports every test file: one torch thread a process keeps torch's
# intra-op pools from oversubscribing the cores (the port's test files on
# 8 cores: 726 s with torch's default threads, 104 s with one)
torch.set_num_threads(1)

TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
FLAGS = ("strictly_feasible", "infeasible", "undecided")


def _mixed_batch(n=32, B=20, seed=0):
    """TestFeasibilityScreen._mixed_batch: -P(A) <= -pA, P(A) <= qA,
    every 4th instance infeasible."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    H = np.stack([-I_A, I_A])
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool); bad[::4] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return H, np.stack([-pA, qA], axis=1), bad


def _both(n, H, u, dtype=torch.float64, A=None, r=None, sound=False):
    """(reference screen, port screen) of the same data, held to each
    other: flags exactly, bounds, x and w to TOL[dtype]; with ``sound``
    the bounds to the other run's certified interval instead."""
    jdt = JDT[dtype]
    extra = {} if A is None else dict(A=A, r=r)
    ref = RefDistKL.create(
        n, H=jnp.asarray(H, jdt), u=jnp.zeros((H.shape[0],), jdt),
        **{k: jnp.asarray(v, jdt) for k, v in extra.items()})
    rs = jax.jit(ref.feasibility_screen_batch)(jnp.asarray(u, jdt))
    prob = DistKL.create(
        n, H=torch.tensor(H, dtype=dtype),
        u=torch.zeros(H.shape[0], dtype=dtype), device="cpu",
        **{k: torch.tensor(v, dtype=dtype) for k, v in extra.items()})
    ps = prob.feasibility_screen_batch(torch.tensor(u, dtype=dtype))
    assert isinstance(ps, FeasibilityScreen)
    for f in FLAGS:
        assert np.array_equal(getattr(ps, f).numpy(),
                              np.asarray(getattr(rs, f))), f
    for f in ("s_lower", "s_upper", "x", "w"):
        got, want = getattr(ps, f).numpy(), np.asarray(getattr(rs, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        assert sound or err <= TOL[dtype], (f, err)
    if sound:
        assert np.all(ps.s_lower.numpy() <= np.asarray(rs.s_upper))
        assert np.all(np.asarray(rs.s_lower) <= ps.s_upper.numpy())
    return rs, ps, prob


class TestFeasibilityScreen:

    def test_anti_parallel_family_flags_exact_and_tight(self):
        n, B = 32, 20
        H, u, bad = _mixed_batch(n=n, B=B)
        _, scr, _ = _both(n, H, u)
        assert np.array_equal(scr.infeasible.numpy(), bad)
        assert np.array_equal(scr.strictly_feasible.numpy(), ~bad)
        assert int(scr.undecided.sum()) == 0
        s_true = (-u[:, 0] - u[:, 1]) / 2.0         # (pA - qA) / 2
        slb, sub = scr.s_lower.numpy(), scr.s_upper.numpy()
        assert float(np.max(sub - slb)) < 1e-6
        assert np.all(slb <= s_true + 1e-9) and np.all(sub >= s_true - 1e-9)

    def test_bounds_bracket_linprog(self):
        from scipy.optimize import linprog

        n, B, k = 40, 6, 7
        rng = np.random.default_rng(3)
        H = rng.uniform(0.0, 1.0, (k, n)); H[H < 0.6] = 0.0
        x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
        u = (H @ x0)[None, :] + rng.uniform(0.05, 0.15, (B, k))
        _, scr, _ = _both(n, H, u)
        slb, sub = scr.s_lower.numpy(), scr.s_upper.numpy()
        assert int(scr.undecided.sum()) == 0
        for b in range(B):
            c = np.zeros(n + 1); c[-1] = 1.0
            res = linprog(
                c, A_ub=np.hstack([H, -np.ones((k, 1))]), b_ub=u[b],
                A_eq=np.hstack([np.ones((1, n)), np.zeros((1, 1))]),
                b_eq=[1.0], bounds=[(0, None)] * n + [(None, None)])
            assert res.status == 0
            assert slb[b] <= res.fun + 1e-9, (b, slb[b], res.fun)
            assert sub[b] >= res.fun - 1e-9, (b, sub[b], res.fun)
            assert sub[b] - res.fun < 5e-3

    def test_f32_returns_strictly_positive_feasible_point(self):
        n, B = 32, 40
        H, u, bad = _mixed_batch(n=n, B=B, seed=1)
        _, scr, _ = _both(n, H, u, dtype=torch.float32)
        assert np.array_equal(scr.infeasible.numpy(), bad)
        x = scr.x.numpy()
        assert (x > 0.0).all()
        assert float(np.max(np.abs(x.sum(1) - 1.0))) < 1e-5
        feas = scr.strictly_feasible.numpy()
        viol = x[feas].astype(np.float64) @ H.T - u[feas]
        assert (viol < 0.0).all()

    def test_agrees_with_generic_phase1(self):
        n, B = 32, 20
        H, u, bad = _mixed_batch(n=n, B=B, seed=2)
        _, scr, prob = _both(n, H, u)
        _, strict = prob.feasibility_batch(
            torch.tensor(u), SolverParams(tol=1e-6, max_iter=60))
        assert np.array_equal(scr.strictly_feasible.numpy(), strict.numpy())
        assert np.array_equal(strict.numpy(), ~bad)

    def test_equality_rows_fold_as_pair(self):
        rng = np.random.default_rng(2)
        n, B = 64, 32
        I_A = np.zeros(n); I_A[:3] = 1.0
        H = np.stack([-I_A, I_A])
        pA = rng.uniform(0.2, 0.4, B)
        qA = pA + rng.uniform(0.05, 0.2, B)
        bad = np.zeros(B, bool); bad[::8] = True
        qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
        u = np.stack([-pA, qA], axis=1)
        W = rng.uniform(0.5, 1.5, n)
        m1 = (pA[1] + qA[1]) / 2.0
        xf = m1 * I_A / 3 + (1 - m1) * (1 - I_A) / (n - 3)
        r = np.array([W @ xf])
        _, scr, _ = _both(n, H, u, A=W[None, :], r=r, sound=True)
        inf = scr.infeasible.numpy()
        assert bool(inf[bad].all())
        assert int(inf[~bad].sum()) == 0
        feas = scr.strictly_feasible.numpy()
        assert feas.any()
        x = scr.x.numpy()[feas]
        assert float(np.abs(x @ W - r[0]).max()) < 1e-4
        assert bool(((x @ H.T) - u[feas] < 0).all())

    def test_near_saturated_softmax_stays_finite(self):
        """The round-5 sweep's instance 6049 of the (k = 11, pair)
        family, replayed through the sweep's rng stream."""
        rng = np.random.default_rng(0)
        B = 10000
        configs = [
            (2, 100, 0.05, 0.10, "negu"), (3, 100, 0.02, 0.10, "pair"),
            (5, 100, 0.10, 0.50, "negu"), (7, 100, 0.05, 0.10, "pair"),
            (9, 300, 0.02, 0.10, "negu"), (11, 100, 0.15, 0.25, "pair"),
        ]
        for (k, n, margin, frac, mode) in configs:
            Hw = rng.uniform(0.0, 1.0, (k, n)); Hw[Hw < 0.6] = 0.0
            if mode == "pair":
                h = rng.uniform(0.0, 1.0, n); Hw[k - 2] = h; Hw[k - 1] = -h
            x0 = rng.uniform(0.5, 1.5, n); x0 /= x0.sum()
            uw = (Hw @ x0)[None, :] + rng.uniform(margin, 2 * margin,
                                                  (B, k))
            bad = np.zeros(B, bool)
            bad[rng.permutation(B)[:int(B * frac)]] = True
            if mode == "negu":
                uw[bad, 0] = -rng.uniform(margin, 2 * margin, bad.sum())
            else:
                a = h @ x0
                uw[bad, k - 2] = a - rng.uniform(margin, 2 * margin,
                                                 bad.sum())
                uw[bad, k - 1] = -a
        assert abs(float(Hw.sum()) - 282.53496039970514) < 1e-6
        _, scr, _ = _both(100, Hw, uw[6049:6050], dtype=torch.float32,
                          sound=True)
        assert bool(torch.isfinite(scr.s_lower).all())
        assert bool(torch.isfinite(scr.s_upper).all())
        assert not bool(scr.undecided[0])
        assert bool(scr.strictly_feasible[0])

    def test_returned_w_reproduces_s_lower(self):
        n, B = 32, 200
        H, u, bad = _mixed_batch(n=n, B=B, seed=0)
        _, scr, _ = _both(n, H, u)
        w = scr.w.numpy()
        assert (w >= 0).all()
        assert float(np.max(np.abs(w.sum(1) - 1.0))) < 1e-12
        recomputed = np.min(w @ H, axis=1) - np.sum(w * u, axis=1)
        assert float(np.max(np.abs(recomputed - scr.s_lower.numpy()))) < 1e-9
        inf = scr.infeasible.numpy()
        assert (recomputed[inf] > 0).all()


class TestScreenCore:
    """The jittable core ``kl_feasibility_screen`` on (H, u) directly, as
    the entry point calls it, and the card default of its model."""

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_core_matches_entry_point(self, dtype):
        H, u, _ = _mixed_batch(n=16, B=8, seed=4)
        prob = DistKL.create(16, H=torch.tensor(H, dtype=dtype),
                             u=torch.zeros(2, dtype=dtype), device="cpu")
        a = prob.feasibility_screen_batch(torch.tensor(u, dtype=dtype))
        b = kl_feasibility_screen(torch.tensor(H, dtype=dtype),
                                  torch.tensor(u, dtype=dtype))
        for f in ("s_lower", "s_upper", "x", "w", *FLAGS):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
