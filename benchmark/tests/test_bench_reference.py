"""The plain reference against the closed-form KL projection at a tiny n,
its rounding to TF32, and the frozen f64 certificate at its optimum."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import kl_projection
from benchmark.reference.certificate import kl_gap_certificate


def closed_form(n, m, p):
    """The projection of the uniform prior onto P(first m) >= p, active:
    p spread over the m, 1 - p over the rest."""
    x = np.full(n, (1 - p) / (n - m))
    x[:m] = p / m
    lam = math.log((p / m) / ((1 - p) / (n - m)))
    f = p * math.log(p * n / m) + (1 - p) * math.log((1 - p) * n / (n - m))
    return x, lam, f


@pytest.mark.parametrize("precision,tol", [("f64", 1e-13), ("f32", 1e-6)])
def test_one_active_row_matches_the_closed_form(precision, tol):
    n, m = 8, 3
    H = torch.zeros((2, n), dtype=torch.float64)
    H[0, :m] = -1.0           # P(A) >= p
    H[1, n // 2:] = 1.0       # P(B) <= 0.9, inactive
    ps = (0.5, 0.7)
    u = torch.tensor([[-p, 0.9] for p in ps], dtype=torch.float64)
    s = kl_projection.solve(H, u, precision)
    for i, p in enumerate(ps):
        x, lam, f = closed_form(n, m, p)
        assert np.abs(s["x"][i].double().numpy() - x).max() < tol
        assert abs(float(s["lam"][i, 0]) - lam) < 10 * tol * (1 + lam)
        assert float(s["lam"][i, 1]) == 0.0
        assert abs(float(s["f"][i]) - f) < 10 * tol
        # nu makes p exp(-H'lam - nu - 1) sum to one
        nu = float(s["nu"][i, 0])
        z = (np.exp(-(H[0].numpy() * lam) - nu - 1) / n).sum()
        assert abs(z - 1) < 10 * tol


def test_both_rows_active():
    n = 10
    H = torch.zeros((2, n), dtype=torch.float64)
    H[0, :2] = -1.0           # P(first 2) >= 0.5
    H[1, 5:] = 1.0            # P(last 5) <= 0.2
    u = torch.tensor([[-0.5, 0.2]], dtype=torch.float64)
    s = kl_projection.solve(H, u)
    want = np.array([0.25, 0.25] + [0.3 / 3] * 3 + [0.04] * 5)
    assert np.abs(s["x"][0].numpy() - want).max() < 1e-14
    assert (s["lam"][0] > 0).all()
    m = kl_projection.measure(H, u, s["x"], s["lam"], s["nu"])
    assert abs(float(m["gap"][0])) < 1e-14


def test_the_certificate_holds_the_reference_optimum():
    rng = np.random.default_rng(0)
    n, B = 50, 40
    H = np.zeros((2, n)); H[0, :3] = -1.0; H[1, n // 2:] = 1.0
    U = np.column_stack([-rng.uniform(0.2, 0.5, B),
                         rng.uniform(0.55, 0.8, B)])
    s = kl_projection.solve(torch.tensor(H), torch.tensor(U))
    cert = kl_gap_certificate(s["x"].numpy(), H, U)
    assert np.abs(cert).max() < 1e-12
    # and the f64 numbers of the reference against itself read rounding
    out = dict(x=s["x"], lam=s["lam"], nu=s["nu"], stalled=torch.zeros(
        B, dtype=torch.bool), **{k: v for k, v in kl_projection.measure(
            torch.tensor(H), torch.tensor(U), s["x"], s["lam"],
            s["nu"]).items() if k in ("gap", "ineq", "eq")})
    nums = kl_projection.compare(torch.tensor(H), torch.tensor(U), out, s,
                                 dict(gap_tol=1e-8, feas_tol=1e-7,
                                      eq_in_rule=True))
    assert nums["x_err"] == 0.0 and nums["stall_diff"] == 0
    assert nums["gap_err"] == 0.0 and nums["res_err"] == 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10,
                      -3.0, 1 + 2**-12], dtype=torch.float32)
    r = kl_projection.round_tf32(x)
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 2^-11 -> 1 + 2^-9
    assert r.tolist() == [1.0, 1.0, 1 + 2**-9, 1 + 2**-10, -3.0, 1.0]
