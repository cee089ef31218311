"""The measured certificate ``kl_dual_gap`` and its kernel wrapper
``ops.kl_gap.kl_gap_fused``.

On the CPU (no JAX here; ``tests/test_torch_dual_newton.py`` holds
``kl_dual_gap`` to the reference):

* the wrapper's CPU path and ``kl_dual_gap`` return the same tensors, bit
  for bit, as the algebra ``kl_dual_gap`` ran before the kernel (the fit,
  ``duality._polish_dual``, the gap; written out below), over the
  reference tests' instances: dual dims 2, 3, 5 and 8, with a prior and
  with equality rows, in f32 and f64, at a far start and a converged one;
* the argument checks raise on what the kernel does not take;
* the routing rule (``route_of``): CUDA f32 / f64 at dual dims 1-8 take
  the wrapper (its kernel), dim 9 and up or another dtype the torch
  chain, counted in ``kl_dual_gap.chain_calls``; tensors on any other
  device the wrapper (its plain version);
* ``diagnostics.counters()`` lists both counters.

On the card (marked ``cuda``, skipped without one; ``python -m pytest
--noconftest -m cuda tests/test_torch_kl_gap.py``): the kernel against
the plain version on the same CUDA tensors, f32 and f64, dual dims 1, 2,
3, 5 and 8, n in {3, 100, 1,000, 10,000}, with a prior and equality rows
(where dim > n, rank-deficient, the kernel's gap against its own z and
no worse than the plain version's); an
empty batch and dead lanes; the primal route's stall flags on bench.py's
family at n = 100 and 10,000; the launch and chain counters.  Tolerances
(``_bench.KGAP_*``): f32 gap within 3e-6 and z within 6e-5, each relative
to 1 + its magnitude (a tenth of the primal cell's gap_err and dual_err
limits at its converged lanes, |gap| << 1), f64 both 1e-11.
"""

import math

import numpy as np
import pytest
import torch

from cvx_tpu_torch import DistKL, SolverParams, diagnostics
from cvx_tpu_torch._bench import (KGAP_DGAP, KGAP_DZ, KGAP_F64_TOL,
                                  PRODUCTION, bench_family, feasible_points)
from cvx_tpu_torch.duality import _polish_dual, _small_solve
from cvx_tpu_torch.models import dist_kl
from cvx_tpu_torch.models.dist_kl import kl_dual_gap
from cvx_tpu_torch.ops import kl_gap
from cvx_tpu_torch.ops.kl_dual import _stalled
from cvx_tpu_torch.ops.kl_gap import (_NegDualObjective, _prior_terms,
                                      kl_gap_fused, kl_gap_fused_plain,
                                      route_of)

# one torch thread a test process (see test_torch_api_utilities.py)
torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


def _before_the_kernel(H, u, A, b, x, polish_steps=8, value_band_eps=None,
                       prior=None):
    """``kl_dual_gap`` as it was before the kernel, written out."""
    dtype = x.dtype
    n = x.shape[-1]
    x = torch.clamp_min(x, 1e-30)
    k = H.shape[0]
    Bm = torch.cat([H, A], dim=0).to(dtype)
    w = torch.cat([u, b], dim=1).to(dtype)
    logp, R = _prior_terms(prior, n, dtype, x.device)
    dim = Bm.shape[0]
    c = -(1.0 + torch.log(x) - logp)
    BBt = Bm @ Bm.T
    ridge = (10 * torch.finfo(dtype).eps
             * torch.abs(torch.diagonal(BBt)).mean())
    BBt = BBt + ridge * torch.eye(dim, dtype=dtype, device=x.device)
    z = _small_solve(BBt.expand(x.shape[0], dim, dim), c @ Bm.T)
    mask = torch.arange(dim, device=x.device) < k
    z = torch.where(mask, torch.clamp_min(z, 0.0), z)
    neg_dual = _NegDualObjective(B=Bm, w=w, R=R)
    z = _polish_dual(neg_dual, z, num_ineq=k, steps=polish_steps,
                     value_band_eps=value_band_eps)
    dual_val = -neg_dual.value(z)
    primal_val = (x * (torch.log(x) - logp)).sum(dim=-1)
    return primal_val - dual_val, z


def _family(k, p, n, B, seed, dtype=F64, device="cpu", prior=False):
    """``(H, u, A, b, x, prior)``: k random rows (tests/test_round5.py's
    family, each row with a nonzero), the sum-to-one row and p - 1 random
    equality rows through a point x0, B bounds scaled 1 to 1.1, and x the
    points x0 perturbed by 5 % and renormalised (a far start)."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(0.0, 1.0, (k, n))
    H[H < 0.6] = 0.0
    H[np.arange(k), np.arange(k) % n] = 1.0
    x0 = rng.uniform(0.5, 1.5, n)
    x0 /= x0.sum()
    u = H @ x0 + rng.uniform(0.05, 0.15, k)
    A = np.vstack([np.ones((min(p, 1), n)),
                   rng.uniform(0.0, 1.0, (max(p - 1, 0), n))])
    U = np.stack([u * s for s in np.linspace(1.0, 1.1, B)])
    bb = np.broadcast_to(A @ x0, (B, p))
    X = np.abs(x0 * (1.0 + 0.05 * rng.standard_normal((B, n))))
    X /= X.sum(axis=1, keepdims=True)
    pr = rng.uniform(0.5, 1.5, n) if prior else None

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    return (t(H), t(U), t(A), t(bb), t(X),
            None if pr is None else t(pr / pr.sum()))


def _bench_converged(n, B, dtype=F64, device="cpu"):
    """bench.py's family (dual dim 3) and the primal route's x there."""
    Hn, Un = bench_family(B, n, seed=0)
    X0 = feasible_points(Un, n)
    opts = dict(dtype=dtype, device=device)
    H, U = torch.tensor(Hn, **opts), torch.tensor(Un, **opts)
    model = DistKL.create(n, H=H, u=U[0], device=device)
    x = model.solve_jittable_batch(
        U, torch.tensor(X0, **opts), method="fused",
        pars=SolverParams(**PRODUCTION)).x
    ones = torch.ones((1, n), **opts)
    return H, U, ones, torch.ones((B, 1), **opts), x


# (label, k, p, prior): dual dims 2, 3, 5 and 8, a prior, equality rows
CPU_CASES = [("dim2", 1, 1, False), ("dim3 prior", 2, 1, True),
             ("dim5 eq", 3, 2, False), ("dim8 eq prior", 5, 3, True)]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("label,k,p,prior", CPU_CASES)
def test_cpu_path_is_the_algebra_before_the_kernel(label, k, p, prior,
                                                   dtype):
    H, U, A, b, X, pr = _family(k, p, 40, 6, seed=k + 3 * p, dtype=dtype,
                                prior=prior)
    want = _before_the_kernel(H, U, A, b, X, prior=pr)
    for got in (kl_gap_fused(H, U, A, b, X, prior=pr),
                kl_gap_fused_plain(H, U, A, b, X, prior=pr),
                kl_dual_gap(H, U, A, b, X, prior=pr)):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    # the options reach the polish: fewer steps and a wider noise band
    want = _before_the_kernel(H, U, A, b, X, polish_steps=3,
                              value_band_eps=1e-4, prior=pr)
    got = kl_dual_gap(H, U, A, b, X, polish_steps=3, value_band_eps=1e-4,
                      prior=pr)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_cpu_path_at_a_converged_point_and_on_dead_lanes(dtype):
    H, U, A, b, x = _bench_converged(30, 5, dtype=dtype)
    x = x.clone()
    x[1, 4] = 0.0                      # an underflowed coordinate
    x[2, 7] = math.nan                 # dead lanes
    x[3, 9] = math.inf
    want = _before_the_kernel(H, U, A, b, x)
    got = kl_dual_gap(H, U, A, b, x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isfinite(got[0][[0, 1, 4]]).all())


def _valid(device="cpu", dtype=F32):
    H, U, A, b, X, pr = _family(2, 2, 12, 3, seed=1, dtype=dtype,
                                device=device, prior=True)
    return [H, U, A, b, X, pr]


@pytest.mark.timeout(60)
@pytest.mark.parametrize("fault,match", [
    ("H 3-D", "must be 2-D"),
    ("u rows", "do not agree"),
    ("A lanes", "do not agree"),
    ("dim 9", "1 <= k \\+ p <= 8"),
    ("dim 0", "1 <= k \\+ p <= 8"),
    ("steps", "polish_steps >= 0"),
    ("prior shape", "prior must be"),
    ("mixed dtype", "every tensor must be"),
    ("H lanes strided", "lane axis"),
    ("f16", "every tensor must be|f32 or f64 CUDA"),
    ("cpu", "f32 or f64 CUDA"),
])
def test_argument_checks_raise_on_what_the_kernel_does_not_take(fault,
                                                                match):
    H, U, A, b, X, pr = _valid()
    steps = 8
    if fault == "H 3-D":
        H = H[None]
    elif fault == "u rows":
        U = U[:, :1]
    elif fault == "A lanes":
        A = A[:, :-1]
    elif fault == "dim 9":
        H, U, A, b, X, pr = _family(7, 2, 12, 3, seed=1, dtype=F32,
                                    prior=True)
    elif fault == "dim 0":
        H, U, A, b = H[:0], U[:, :0], A[:0], b[:, :0]
    elif fault == "steps":
        steps = -1
    elif fault == "prior shape":
        pr = pr[:-1]
    elif fault == "mixed dtype":
        U = U.double()
    elif fault == "H lanes strided":
        H = torch.cat([H, H], dim=1)[:, ::2]
    elif fault == "f16":
        H, U, A, b, X, pr = (t.half() for t in (H, U, A, b, X, pr))
    with pytest.raises(ValueError, match=match):
        kl_gap._check_args(H, U, A, b, X, pr, steps)


@pytest.mark.timeout(60)
def test_routing_rule():
    for dim in range(1, 9):
        for dtype in (F32, F64):
            assert route_of("cuda", dtype, dim) == "wrapper"
            assert route_of(torch.device("cuda", 0), dtype, dim) == "wrapper"
            assert route_of("cpu", dtype, dim) == "wrapper"
    for dim in (0, 9, 12, 16):
        assert route_of("cuda", F32, dim) == "chain"
        for device in ("cpu", "meta"):
            assert route_of(device, F32, dim) == "wrapper"
    for dtype in (torch.float16, torch.bfloat16):
        assert route_of("cuda", dtype, 3) == "chain"
        assert route_of("meta", dtype, 3) == "wrapper"


@pytest.mark.timeout(120)
def test_kl_dual_gap_dispatch_and_its_chain_counter(monkeypatch):
    """Each route of ``kl_dual_gap``, with the rule forced on CPU
    tensors: "chain" runs the plain version and counts one chain call,
    "wrapper" casts the rows to x's dtype and calls the wrapper (here its
    plain version); both return the same bits."""
    H, U, A, b, X, pr = _family(2, 1, 20, 4, seed=2, dtype=F64, prior=True)
    want = _before_the_kernel(H, U, A, b, X, prior=pr)
    calls = []

    def spy(*args, **kw):
        calls.append(tuple(a.dtype for a in args))
        return kl_gap_fused(*args, **kw)

    monkeypatch.setattr(dist_kl, "kl_gap_fused", spy)
    for route, wrapper, chain, h in (("chain", 0, 1, H), ("wrapper", 1, 0, H),
                                     ("wrapper", 1, 0, H.float())):
        monkeypatch.setattr(dist_kl, "route_of", lambda *a, r=route: r)
        calls.clear()
        before = kl_dual_gap.chain_calls
        got = kl_dual_gap(h, U, A, b, X, prior=pr)
        assert len(calls) == wrapper and kl_dual_gap.chain_calls == \
            before + chain, route
        if wrapper:
            assert calls[0] == (F64,) * 5        # H cast to x's dtype
        if h is H:
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.timeout(60)
def test_counters_list_the_wrapper_and_the_chain():
    got = diagnostics.counters()
    assert "kl_gap_fused" in got and "kl_dual_gap_chain_calls" in got
    # the certified route's counters and K3's schedule counter sit beside
    # them; kl_dual_gap moves none of them (checked with the rest below)
    assert "cert_leaves_fused" in got and "cert_leaves_torch" in got
    assert "kl_barrier_schedule_torch" in got
    H, U, A, b, X, _ = _family(8, 2, 20, 3, seed=4)      # dual dim 10
    before = diagnostics.counters()
    kl_dual_gap(H, U, A, b, X)
    kl_dual_gap(H[:2], U[:, :2], A, b, X)
    assert diagnostics.counters() == before    # the CPU counts nothing


# ------------------------------------------------------------- the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _agree(got, ref, dtype, what):
    """The kernel's (gap, z) against the plain version's: the same
    non-finite lanes, and the tolerances above on the finite ones."""
    (g, z), (gp, zp) = got, ref
    assert torch.equal(torch.isfinite(g), torch.isfinite(gp)), what
    fin = torch.isfinite(gp) & torch.isfinite(zp).all(dim=1)
    dg = (float(((g - gp).abs() / (1.0 + gp.abs()))[fin].max())
          if fin.any() else 0.0)
    dz = (float(((z - zp).abs() / (1.0 + zp.abs()))[fin].max())
          if fin.any() else 0.0)
    tg, tz = ((KGAP_DGAP, KGAP_DZ) if dtype == F32
              else (KGAP_F64_TOL, KGAP_F64_TOL))
    assert dg <= tg and dz <= tz, f"{what}: |dgap| {dg:.3e}, dz {dz:.3e}"


# dual dim -> (k, p, prior): equality rows at dims 5 and 8, a prior at 2
# and 8, dim 1 without inequality rows
CARD_DIMS = {1: (0, 1, False), 2: (1, 1, True), 3: (2, 1, False),
             5: (3, 2, False), 8: (5, 3, True)}


def _gap_at(H, U, A, b, X, z, prior):
    """f(x) - g(z) measured in f64 at the given z (the certificate's
    value, with x clamped at 1e-30 as the fit does)."""
    H, U, A, b, X, z = (t.double() for t in (H, U, A, b, X, z))
    logp, R = _prior_terms(None if prior is None else prior.double(),
                           X.shape[1], F64, X.device)
    X = X.clamp_min(1e-30)
    Bm = torch.cat([H, A])
    return ((X * (X.log() - logp)).sum(1) + (torch.cat([U, b], 1) * z).sum(1)
            + (R * torch.exp(-(z @ Bm))).sum(1))


@pytest.mark.cuda
@pytest.mark.timeout(600)
@pytest.mark.parametrize("n", [3, 100, 1000, 10000])
@pytest.mark.parametrize("dim", list(CARD_DIMS))
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_matches_plain(dev, dtype, dim, n):
    """Dual dims above n (5 and 8 at n = 3) have more rows than
    coordinates: B is rank-deficient, the dual's minimisers form a line or
    more, and the polish's ridge-bound steps along it amplify rounding, so
    the kernel and the plain version may end at different z (|dgap| near
    1e-2 in f64).  The fit already differs there (the ridge amplifies
    rounding along B's null space), and a lane whose polish reaches a
    point where a step cannot lower -g stops there, in either version.
    So the kernel is held to its own certificate: the same non-finite
    lanes as the plain version, lam >= 0, the reported gap equal to
    f(x) - g(z) measured in f64 at its z; and on every finite lane its gap
    no worse than the plain version's (within the tolerance, relative to
    1 + |gap|), or else its z a point where the plain polish stops too:
    one plain step from it lowers -g by no more than the polish's noise
    band (32 eps, relative to 1 + |-g|).  A kernel that skipped the polish
    or took worse candidates ends where a plain step still descends."""
    k, p, prior = CARD_DIMS[dim]
    B = 37 if n == 10000 else 301
    H, U, A, b, X, pr = _family(k, p, n, B, seed=dim + n, dtype=dtype,
                                device=dev, prior=prior)
    got = kl_gap_fused(H, U, A, b, X, prior=pr)
    ref = kl_gap_fused_plain(H, U, A, b, X, prior=pr)
    torch.cuda.synchronize()
    if dim <= n:
        _agree(got, ref, dtype, f"dim {dim} n {n}")
        return
    gap, z = got
    assert torch.equal(torch.isfinite(gap), torch.isfinite(ref[0]))
    assert bool((z[:, :k] >= 0).all())
    tol = KGAP_DGAP if dtype == F32 else KGAP_F64_TOL
    own = float((gap.double() - _gap_at(H, U, A, b, X, z, pr)).abs().max())
    assert own <= tol, f"dim {dim} n {n}: reported - measured gap {own:.3e}"
    fin = torch.isfinite(ref[0])
    worse = fin & ((gap - ref[0]) / (1.0 + ref[0].abs()) > tol)
    if worse.any():
        logp, R = _prior_terms(pr, n, dtype, dev)
        obj = _NegDualObjective(B=torch.cat([H, A]), w=torch.cat([U, b], 1),
                                R=R).take(worse)
        zw = z[worse]
        f = obj.value(zw)
        drop = (f - obj.value(_polish_dual(obj, zw, num_ineq=k, steps=1))
                ) / (1.0 + f.abs())
        band = 32.0 * torch.finfo(dtype).eps
        assert float(drop.max()) <= band, (
            f"dim {dim} n {n}: {int(worse.sum())} lanes above the plain's "
            f"gap, where a plain step lowers -g by {float(drop.max()):.3e}")


@pytest.mark.cuda
@pytest.mark.timeout(600)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_empty_batch_and_dead_lanes(dev, dtype):
    H, U, A, b, X, _ = _family(2, 1, 100, 8, seed=5, dtype=dtype,
                               device=dev)
    launches = kl_gap_fused.launches
    gap, z = kl_gap_fused(H, U[:0], A, b[:0], X[:0])
    assert gap.shape == (0,) and z.shape == (0, 3)
    assert kl_gap_fused.launches == launches
    X = X.clone()
    X[1, 4] = 0.0
    X[2] = 0.0
    X[3, 7] = math.nan
    X[4, 9] = math.inf
    X[5, 11] = -1.0
    got = kl_gap_fused(H, U, A, b, X)
    ref = kl_gap_fused_plain(H, U, A, b, X)
    torch.cuda.synchronize()
    assert kl_gap_fused.launches == launches + 1
    _agree(got, ref, dtype, "dead lanes")
    assert not bool(torch.isfinite(got[0][3]))


@pytest.mark.cuda
@pytest.mark.timeout(600)
@pytest.mark.parametrize("n,B", [(100, 10000), (10000, 100)])
def test_primal_route_stall_flags_match_the_plain_gap(dev, n, B):
    H, U, A, b, x = _bench_converged(n, B, dtype=F32, device=dev)
    model = DistKL.create(n, H=H, u=U[0], device=dev)
    pars = SolverParams(**PRODUCTION)
    sol = model._fused_solution(U, x, model._fused_schedule(pars))
    gap_p, z_p = kl_gap_fused_plain(H, U, A, b, x)
    eps = torch.finfo(F32).eps
    stalled_p = _stalled(x, gap_p, model._ineq_res(x, U), math.sqrt(eps),
                         math.sqrt(eps))
    torch.cuda.synchronize()
    assert torch.equal(sol.stalled, stalled_p)
    _agree((sol.duality_gap, torch.cat([sol.lam[:, :2], sol.nu], dim=1)),
           (gap_p, z_p), F32, f"primal route n {n}")


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_kl_dual_gap_launches_once_or_counts_a_chain_call(dev):
    H, U, A, b, X, pr = _family(2, 1, 100, 64, seed=6, dtype=F32,
                                device=dev, prior=True)
    before = diagnostics.counters()
    gap, z = kl_dual_gap(H.double(), U, A, b, X, prior=pr.double())
    got = diagnostics.counters()
    assert got["kl_gap_fused"] == before["kl_gap_fused"] + 1
    assert got["kl_dual_gap_chain_calls"] == before["kl_dual_gap_chain_calls"]
    _agree((gap, z), kl_gap_fused_plain(H, U, A, b, X, prior=pr), F32,
           "rows cast to x's dtype")
    H9, U9, A9, b9, X9, _ = _family(7, 2, 100, 16, seed=7, dtype=F32,
                                    device=dev)
    ref = kl_gap_fused_plain(H9, U9, A9, b9, X9)
    gap9, z9 = kl_dual_gap(H9, U9, A9, b9, X9)
    after = diagnostics.counters()
    assert after["kl_gap_fused"] == got["kl_gap_fused"]
    assert after["kl_dual_gap_chain_calls"] == \
        got["kl_dual_gap_chain_calls"] + 1
    torch.testing.assert_close(gap9, ref[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="f32 or f64 CUDA"):
        kl_gap_fused(*(t.half() for t in (H, U, A, b, X)))
