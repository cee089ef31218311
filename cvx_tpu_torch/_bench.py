"""What the port's scripts on the card share: ``chip_smoke.py``,
``bench_scaling_torch.py`` and ``probe_structured.py`` (and the tests of
the ladder) read their data recipes, tolerances, bounds and the kernels'
agreement with their plain versions from here, so that each is defined in
one place.

* Data recipes (numpy, from fixed seeds): bench.py's KL family and its
  feasible points, K3's argument layout, the QP fleet, north-star config 5
  and phase 4c's DiagQP family.
* Tolerances: K1 / K2 against their plain versions, the certified
  contract, K4 against ``torch.linalg.cholesky_ex``, the primal slice's
  host certificate, the QP family's residuals.
* ``bound``: the least time the card could take for a function, from the
  bytes it must move and the operations it does (NVIDIA's H100 SXM data
  sheet), with the operation counts of K1-K4 read off the plain versions.
* ``k1_agreement`` / ``k2_agreement``: a kernel's outputs held against its
  plain version's on the same inputs.

Nothing here builds or launches a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

K1_TOL = 1e-5      # f32 solve: max |dx| and |gap| on converged lanes
# the f32 gap is a difference of sums over n coordinates, and its rounding
# floor grows with n: past n = 1,000 the kernel's own gap is held to
# K1_TOL n / 1000 (2.7e-5 measured at n = 10,000)
K1_GAP_N = 1000
K1_F64_TOL = 1e-9  # the same solve in f64
# K1's z on converged lanes, as max |dz| / (1 + |z|): f32, f64
K1_DZ, K1_F64_DZ = 1e-4, 1e-8
K2_DX, K2_DGAP = 1e-11, 1e-10   # f64 polish + certificate
K2_DZ = 1e-9       # K2's polished z, as max |dz| / (1 + |z|)
K2_DRES = 1e-12    # K2's ineq_res and eq_res, absolute
CERT_GAP = 1e-8    # the reference's certified contract (tolSolver)
# K4 against its plain version, max |dL| relative to max |L|: the trailing
# sums run in another order (f32 ~1e-6 at condition ~1e3), f64 rounding
K4_TOL, K4_F64_TOL = 2e-5, 1e-12
PRIMAL_CERT = 1e-4   # host f64 certificate of the primal slice's f32 x
# the gap kernel (kl_gap_fused) against its plain version: the gap and z,
# each as max |d| / (1 + |value|), in f32 a tenth of the primal cell's
# gap_err and dual_err limits at its converged lanes (|gap| << 1; the
# kernel's sums pair terms in another order, the final two in f64); f64
# both to 1e-11
KGAP_DGAP, KGAP_DZ, KGAP_F64_TOL = 3e-6, 6e-5, 1e-11
PRODUCTION = dict(max_iter=3, mu=55.0, tol=1e-8)   # bench.py's schedule
TOL_FEAS = 1e-7    # the QP family's residual contract (tol_feas)

# the card's peak rates (NVIDIA's H100 SXM data sheet): f32 and f64
# outside the tensor cores, and f64 on them (mma.sync ... .f64), which a
# function shaped like a matrix product (a Cholesky's updates) can use
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
F64_TC_OPS_PER_S = 67e12


# ------------------------------------------------------------------ data
def bench_family(B, n, seed):
    """bench.py's family: P(A) >= pA (|A| = 3, active), P(B) <= pB."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n); I_A[:3] = 1.0
    I_B = np.zeros(n); I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B])
    U = np.column_stack([-rng.uniform(0.2, 0.5, B), rng.uniform(0.55, 0.8, B)])
    return H, U


def feasible_points(U, n):
    """bench.py:164-168: weight pA + 0.05 on A, the rest spread evenly."""
    w = -U[:, 0] + 0.05
    I_A = np.zeros(n); I_A[:3] = 1.0
    return (w / 3)[:, None] * I_A + ((1 - w) / (n - 3))[:, None] * (1 - I_A)


def primal_args(H, U, X0, dev, dtype=torch.float32):
    """K3's (Hs, u, A, b, x0) on ``dev``: the shared rows, the sum-to-one
    row and its right-hand side as stride-0 expands."""
    B, n = X0.shape

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    ones = torch.ones((1, 1, n), dtype=dtype, device=dev)
    return (t(H)[None].expand(B, -1, -1), t(U), ones.expand(B, -1, -1),
            ones[0, :, :1].expand(B, 1), t(X0))


def qp_fleet_data(n, m, p, B, seed):
    """bench_scaling.py:871-881 from a numpy seed: P = M M' + I with M ~
    N(0, 1/n); G, A ~ N(0, 1/n); b = 0; a_b ~ N(0, 1); ub_b ~ U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    return dict(P=M @ M.T + np.eye(n), a=rng.standard_normal((B, n)),
                G=rng.standard_normal((m, n)) / np.sqrt(n),
                h=rng.uniform(0.5, 1.5, (B, m)),
                A=rng.standard_normal((p, n)) / np.sqrt(n), b=np.zeros(p))


def separable_data(K=64, nb=156, mb=32, p=8, seed=5):
    """North-star config 5 (``bench_scaling.py:427-443``) from a numpy
    seed, in the recipe's distributions: P = M M' + I, a and C normal, G
    the first mb rows of [I; -I], u = 10, c = 0.1 normal."""
    rng = np.random.default_rng(seed)
    eye = np.eye(nb)
    M = rng.standard_normal((K, nb, nb)) / np.sqrt(nb)
    P = np.einsum("kij,klj->kil", M, M) + eye[None]
    a = rng.standard_normal((K, nb))
    G = np.tile(np.concatenate([eye, -eye])[None], (K, 1, 1))[:, :mb]
    u = np.full((K, mb), 10.0)
    C = rng.standard_normal((K, p, nb)) / np.sqrt(nb)
    c = 0.1 * rng.standard_normal(p)
    return P, a, G, u, C, c


def diagqp_data(B, n=100, k=4, rng=None):
    """``chip_smoke.py`` phase 4c's DiagQP family (``default_rng(11)``
    unless ``rng`` is given, which then goes on to the phase's LP batch):
    c ~ U(0.5, 1.5), k random rows U ~ U(0, 1), bounds U x0 + U(0.1, 0.3)
    at x0 = 1/n, a ~ N(0, 1); with one sum-to-one row.  Returns (c, a (B,
    n), U (k, n), ub (B, k), x0 (n,))."""
    rng = np.random.default_rng(11) if rng is None else rng
    c = rng.uniform(0.5, 1.5, n)
    U = rng.uniform(0.0, 1.0, (k, n))
    x0 = np.full(n, 1.0 / n)
    ub = (U @ x0)[None, :] + rng.uniform(0.1, 0.3, (B, k))
    a = rng.standard_normal((B, n))
    return c, a, U, ub, x0


# ---------------------------------------------------------------- bounds
def bound(nbytes, ops32=0.0, ops64=0.0, ops64_tc=0.0):
    """(least ms, what sets it): the bytes moved at the HBM rate against
    the operations at the card's peak for their type; ``ops64_tc`` are
    f64 operations of a matrix-product shape, at the tensor cores' f64
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ops32 / F32_OPS_PER_S + ops64 / F64_OPS_PER_S
             + ops64_tc / F64_TC_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bytes_in(*ts):
    """Bytes of the inputs, each storage read once (a stride-0 expand
    counts its one row)."""
    seen, total = set(), 0
    for t in ts:
        if t is None:
            continue
        s = t.untyped_storage()
        if s.data_ptr() not in seen:
            seen.add(s.data_ptr())
            total += s.nbytes()
    return total


def bytes_out(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# Operation counts, per coordinate of one instance, read off the plain
# versions (the kernels do the same arithmetic).  An exp or log counts as
# one operation at the float peak: a libm expf/logf is some ten float
# instructions and one special-function op, so this errs toward a lower
# bound.  Warp reductions count one add per term.
def k1_ops_per_coord(dim, n_steps, n_ls=5):
    step = dim * dim + 7 * dim + 8 + 3 * n_ls
    if dim > 8:                      # the projected full-step candidate
        step += 2 * dim + 4
    return n_steps * step + 2 * dim + 9   # + the epilogue (x, gap)


def k2_ops64_per_coord(dim, k, m_eq, polish_steps=2):
    polish = dim * dim + 3 * dim + 2
    cert = 2 * dim + 8 + 2 * k + 2 * m_eq
    return polish_steps * polish + cert


def k4_bytes(B, n, itemsize):
    """Bytes K4's function must move: the lower triangle of each input
    (all a Cholesky reads of a symmetric matrix) and the whole factor,
    upper zeros included."""
    return B * (n * (n + 1) // 2 + n * n) * itemsize


def k3_ops(k, n, B, n_steps, n_cand):
    """K3's operations for B instances of n coordinates over n_steps
    steps that needed ``n_cand`` line-search candidates in all (the plain
    version's ``count_candidates``).  Per coordinate and step: margins and
    f0 (2k + 6, one log), gradient / 1/h / Woodbury sums (9 + 7k +
    k(k + 1)), H^-1 g, H^-1 a and Schur sums (6 + 5k), dx, q, rows . dx and
    the step bound (8 + 2k), the update (2); per candidate 7 and a log."""
    per_step = 31 + 16 * k + k * (k + 1) + 1
    return n * (B * n_steps * per_step + 8 * n_cand)


def kgap_ops(dim, n, B, steps):
    """The gap kernel's operations for B instances of n coordinates at
    dual dim ``dim`` (``kl_gap_fused_plain``'s arithmetic).  Per
    coordinate: the fit (a log, the stationarity term, its dim products
    and the dim(dim + 1)/2 of BB', the primal term: 2 dim + dim(dim + 1)
    + 6); per polish step the point's pass (B'z, an exp, the value, the
    gradient and the Hessian: 4 dim + dim(dim + 1) + 3) and 9 candidates'
    (B'z, an exp, the value and the gradient: 4 dim + 3 each); the final
    value (2 dim + 3)."""
    tri = dim * (dim + 1)
    per = (2 * dim + tri + 6 + steps * (4 * dim + tri + 3
                                        + 9 * (4 * dim + 3))
           + 2 * dim + 3)
    return B * n * per


# ------------------------------------------------ kernel against plain
def max_abs(d, lanes):
    """max |d| over the selected lanes (rows of a 2-D d), 0 for none."""
    return float(d[lanes].abs().max()) if lanes.any() else 0.0


def k1_agreement(got, ref, tol, ztol):
    """K1's ``(x, gap, z)`` against its plain version's on the same
    inputs.  ``dead_same``: the same dead lanes (gap +inf).  ``close``: on
    the lanes where the plain version converged (|gap| <= tol), max |dx|
    <= tol, max |dz| / (1 + |z|) <= ztol and the kernel's |gap| <= ``gtol``
    (tol, growing with n past K1_GAP_N).  Returns a dict of the figures."""
    (xk, gk, zk), (xp, gp, zp) = got, ref
    dead_k, dead_p = torch.isinf(gk) & (gk > 0), torch.isinf(gp) & (gp > 0)
    conv = torch.isfinite(gp) & (gp.abs() <= tol)
    a = dict(dead=int(dead_p.sum()), dead_same=bool(torch.equal(dead_k,
                                                                dead_p)),
             converged=int(conv.sum()), lanes=len(gp),
             dx=max_abs(xk - xp, conv),
             dz=max_abs((zk - zp) / (1.0 + zp.abs()), conv),
             gap=max_abs(gk, conv), dx_all=max_abs(xk - xp, ~dead_p),
             gtol=tol * max(1.0, xk.shape[1] / K1_GAP_N))
    a["close"] = a["dx"] <= tol and a["gap"] <= a["gtol"] and a["dz"] <= ztol
    return a


def k2_agreement(got, ref):
    """K2's ``(x, z, gap, ineq, eq)`` (its first five outputs) against its
    plain version's.
    ``dead_same``: the same dead lanes.  ``close``: on the lanes the plain
    version certifies (|gap| <= CERT_GAP), x, gap, z and the residuals
    within K2_DX, K2_DGAP, K2_DZ and K2_DRES."""
    xk, zk, gk, ik, ek = got[:5]
    xp, zp, gp, ip, ep = ref[:5]
    cert = torch.isfinite(gp) & (gp.abs() <= CERT_GAP)
    a = dict(dead_same=bool(torch.equal(torch.isinf(gk), torch.isinf(gp))),
             certified=int(cert.sum()), lanes=len(gp),
             dx=max_abs(xk - xp, cert), dgap=max_abs(gk - gp, cert),
             dz=max_abs((zk - zp) / (1.0 + zp.abs()), cert),
             dres=max(max_abs(ik - ip, cert), max_abs(ek - ep, cert)))
    a["close"] = (a["dx"] <= K2_DX and a["dgap"] <= K2_DGAP
                  and a["dz"] <= K2_DZ and a["dres"] <= K2_DRES)
    return a
