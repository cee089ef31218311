"""The batched KL dual solve: plain PyTorch versions and CUDA kernels.

Counterpart of ``cvx_tpu/ops/pallas_kl_dual.py``.  Two kernels, both in
``csrc/kl_dual.cu`` and bound through ``_build.py``:

* ``kl_dual_fused`` (K1) replaces the Pallas kernel ``_kl_dual_kernel``
  (``pallas_call`` at pallas_kl_dual.py:953): the whole fixed-schedule
  active-set projected-Newton solve of the KL dual, per instance, then
  x = y / sum(y) and the measured gap f(x) - g(z).
* ``kl_dual_fused_cert`` (K2) replaces ``_kl_dual_cert_kernel``
  (``pallas_call`` at :836): the K1 solve in f32, then ``polish_steps``
  warm Newton steps and the certificate (gap, inequality and equality
  residuals) in native f64.  The TPU kernel carried double-single pairs
  (ops/ds.py) because the TPU has no f64 unit; the H100 does, so the
  outputs are plain f64 tensors instead of the reference's hi/lo 8-tuple,
  followed by the certified Solution's per-instance leaves (the stall
  flag, a NaN leaf, iters, maxed_out), which the kernel's epilogue writes
  so that the certified route launches nothing else.

Per step (B = [H; 1'; A], w = (u, 1, r), z = (lam, nu), p the prior):

    y      = p exp(-B'z - 1)                       (B, n)
    grad   = w - B y,   hess = B diag(y) B'        dim, dim x dim
    dz     = -Hf^-1 gf       (bound-active coordinates frozen)
    line search over n_ls halvings of the fraction-to-boundary step,
    value acceptance, a gradient-criterion fallback candidate and, for
    dim > 8, a projected full-step candidate.

Each ``*_plain`` function is the same algebra written as batched tensor
code (every per-instance scalar is a (B,) tensor, every row a (B, n) one).
It runs on any device; the CPU tests hold it against the JAX reference and
``chip_smoke.py`` holds the kernels against it on the card.  The wrappers
``kl_dual_fused`` / ``kl_dual_fused_cert`` take the plain version only for
CPU tensors: a CUDA tensor runs the kernel or raises.

Layout: ``Hs`` (B, k, n), ``u`` (B, k), ``A`` (B, mE, n), ``r`` (B, mE),
``log_prior`` (n,) shared; dual dim = k + 1 + mE <= 16 and k + mE >= 1.
The kernels take any batch and row stride for ``Hs``/``A`` (a stride-0
``expand`` of one shared matrix is read in place) and any strides for
``u``/``r``; the lane axis n must be contiguous.  The C launchers pick the
kernel's path by shape (``path_of`` mirrors the rule): f32 rows with dual
dim <= 8, mE = 0 and n <= 128 are held in registers by one warp per
instance; every other shape takes the group path, one instance per G
warps (G grows with n while the card has room), its sums reduced once a
pass and its small system solved once by one warp, except K1 in f64 at
dual dims <= 4 where G would be 1, which keeps one warp an instance.  An
f32 lane that adds more than 8 terms a sum compensates (Kahan) the sums
of the value and the gradient: uncompensated, a lane's rounding over
hundreds of terms gave the dual value a false minimum at n = 10,000.
"""

from __future__ import annotations

import math

import torch

from .._spans import span
from . import _build

# widest dual dimension k + 1 + mE the kernels unroll in registers
_FUSED_MAX_DIM = 16
# most line-search halvings the kernels hold accumulators for
_MAX_LS = 8
# the C launchers' dispatch (csrc/kl_dual.cu's constants of the same
# names): the held path's coordinates a lane holds and widest dual dim; the
# group path's coordinates a thread takes before G doubles, the warps that
# fill the card, G's cap at dual dims <= _GROUP_WIDE_DIM and above, and the
# warps a block fills with one-warp groups
_HELD_NC = 4                  # kHeldNC
_HELD_MAX_DIM = 8             # kHeldMaxDim
_GROUP_NC = 4                 # kGroupNC
_GROUP_FILL_WARPS = 1024      # kGroupFillWarps
_GROUP_MAX_WARPS = 16         # kGroupMaxWarps
_GROUP_WIDE_DIM = 4           # kGroupWideDim
_GROUP_WIDE_MAX_WARPS = 8     # kGroupWideMaxWarps
_GROUP_BLOCK_WARPS = 4        # kGroupBlockWarps
_WARP_LOOP_MAX_DIM_F64 = 4    # kWarpLoopMaxDimF64


def path_of(dim, k, m_eq, n, B, dtype):
    """The path ``csrc/kl_dual.cu``'s launchers take for B instances of K1
    in ``dtype`` (K2: ``torch.float32``) at dual dim ``dim`` = k + 1 + m_eq
    and n coordinates: ``"held"`` (f32, dim <= 8, no extra equality rows,
    n <= 128; one warp an instance, the rows in registers), ``("group",
    G)``, one instance per G warps (G doubles from 1 while a thread would
    take more than ``_GROUP_NC`` coordinates and B G warps do not fill the
    card, up to its cap), or ``"warp loop"``: K1 in f64 at dual dims <= 4
    where G would be 1 keeps one warp an instance with the rows re-read
    each pass."""
    if (dtype == torch.float32 and dim <= _HELD_MAX_DIM and m_eq == 0
            and k == dim - 1 and n <= 32 * _HELD_NC):
        return "held"
    cap = (_GROUP_MAX_WARPS if dim <= _GROUP_WIDE_DIM
           else _GROUP_WIDE_MAX_WARPS)
    G = 1
    while G < cap and 32 * G * _GROUP_NC < n and B * G < _GROUP_FILL_WARPS:
        G *= 2
    if dtype == torch.float64 and dim <= _WARP_LOOP_MAX_DIM_F64 and G == 1:
        return "warp loop"
    return ("group", G)


# --------------------------------------------------------------- plain K1
def _solve_small(m, gf, dim):
    """dz = -M^-1 gf for the small Newton system, plus a per-instance
    ``sick`` flag for a (near-)singular free subspace (the reference's
    _solve_small, pallas_kl_dual.py:81-163).

    ``m`` maps (i, j), i <= j, to the (B,) entries of the symmetric matrix
    (frozen coordinates carry a unit diagonal).  dim <= 3: closed-form
    adjugate; dim 4-16: Cholesky.  ``sick``: det <= 10 eps * the diagonal
    product (dim <= 3), or a pivot <= 10 eps * its diagonal (dim >= 4) —
    e.g. exactly anti-parallel rows whose lams are both free.
    """
    dtype = gf[0].dtype
    eps10 = 10.0 * torch.finfo(dtype).eps
    if dim == 1:
        return [-gf[0] / m[(0, 0)]], torch.zeros_like(gf[0], dtype=torch.bool)
    if dim == 2:
        det = m[(0, 0)] * m[(1, 1)] - m[(0, 1)] * m[(0, 1)]
        sick = det <= eps10 * (m[(0, 0)] * m[(1, 1)])
        return [
            -(m[(1, 1)] * gf[0] - m[(0, 1)] * gf[1]) / det,
            -(m[(0, 0)] * gf[1] - m[(0, 1)] * gf[0]) / det,
        ], sick
    if dim > _FUSED_MAX_DIM:
        raise ValueError(f"_solve_small: dim {dim} > {_FUSED_MAX_DIM}")
    if dim == 3:
        c00 = m[(1, 1)] * m[(2, 2)] - m[(1, 2)] * m[(1, 2)]
        c01 = m[(1, 2)] * m[(0, 2)] - m[(0, 1)] * m[(2, 2)]
        c02 = m[(0, 1)] * m[(1, 2)] - m[(1, 1)] * m[(0, 2)]
        det = m[(0, 0)] * c00 + m[(0, 1)] * c01 + m[(0, 2)] * c02
        sick = det <= eps10 * (m[(0, 0)] * m[(1, 1)] * m[(2, 2)])
        return [
            -(c00 * gf[0] + c01 * gf[1] + c02 * gf[2]) / det,
            -(c01 * gf[0] + (m[(0, 0)] * m[(2, 2)]
                             - m[(0, 2)] * m[(0, 2)]) * gf[1]
              + (m[(0, 1)] * m[(0, 2)]
                 - m[(0, 0)] * m[(1, 2)]) * gf[2]) / det,
            -(c02 * gf[0] + (m[(0, 1)] * m[(0, 2)]
                             - m[(0, 0)] * m[(1, 2)]) * gf[1]
              + (m[(0, 0)] * m[(1, 1)]
                 - m[(0, 1)] * m[(0, 1)]) * gf[2]) / det,
        ], sick
    # max(.., tiny) keeps all-zero systems finite; their garbage steps
    # reject on value
    tiny = gf[0].new_tensor(torch.finfo(dtype).tiny)
    L = {}
    sick = None
    for j in range(dim):
        d = m[(j, j)]
        for p in range(j):
            d = d - L[(j, p)] * L[(j, p)]
        bad_j = d <= eps10 * m[(j, j)]
        sick = bad_j if sick is None else sick | bad_j
        L[(j, j)] = torch.sqrt(torch.maximum(d, tiny))
        for i in range(j + 1, dim):
            off = m[(j, i)]
            for p in range(j):
                off = off - L[(i, p)] * L[(j, p)]
            L[(i, j)] = off / L[(j, j)]
    yv = []
    for i in range(dim):
        s = -gf[i]
        for p in range(i):
            s = s - L[(i, p)] * yv[p]
        yv.append(s / L[(i, i)])
    dz = [None] * dim
    for i in range(dim - 1, -1, -1):
        s = yv[i]
        for p in range(i + 1, dim):
            s = s - L[(p, i)] * dz[p]
        dz[i] = s / L[(i, i)]
    return dz, sick


class _Ctx:
    """Row accessors and the dual's value/gradient forms over one batch
    (the reference's _make_ctx, pallas_kl_dual.py:166-242).  Per-instance
    scalars are (B,) tensors; rows are (B, n) tensors."""

    def __init__(self, Hs, u, A, r, logp):
        self.dtype = Hs.dtype
        self.k = Hs.shape[1]
        self.m_eq = A.shape[1]
        self.dim = self.k + 1 + self.m_eq
        self.Hs, self.A, self.logp = Hs, A, logp
        B = Hs.shape[0]
        one = torch.ones(B, dtype=self.dtype, device=Hs.device)
        # w = (u, 1, r)
        self.ws = ([u[:, j] for j in range(self.k)] + [one]
                   + [r[:, j] for j in range(self.m_eq)])

    def hrow(self, j):
        # B = [H; 1'; A]; the ones-row (j == k) is handled by callers
        if j < self.k:
            return self.Hs[:, j, :]
        return self.A[:, j - self.k - 1, :]

    @staticmethod
    def rsum(a):
        return a.sum(dim=1)

    def btz_of(self, z):
        # B'z: the ones-row contributes a broadcast scalar
        out = z[self.k][:, None]
        for j in range(self.dim):
            if j != self.k:
                out = out + z[j][:, None] * self.hrow(j)
        return out

    def y_of(self, z):
        return torch.exp(-(self.btz_of(z)) - 1.0 + self.logp)

    def val_of(self, z, y):
        v = self.rsum(y)
        for i in range(self.dim):
            v = v + self.ws[i] * z[i]
        return v

    def grad_of(self, z, y):
        return [self.ws[j] - (self.rsum(y) if j == self.k
                              else self.rsum(self.hrow(j) * y))
                for j in range(self.dim)]

    def pgnorm(self, z, g):
        # projected-gradient norm^2: lam at 0 wanting to decrease is
        # optimal, drop it
        s = torch.zeros_like(g[0])
        for j in range(self.dim):
            gj = g[j]
            if j < self.k:
                gj = torch.where((z[j] <= 0.0) & (g[j] > 0.0), 0.0, g[j])
            s = s + gj * gj
        return s

    def project(self, z):
        return [torch.clamp_min(z[j], 0.0) if j < self.k else z[j]
                for j in range(self.dim)]


def _newton_z(ctx, *, n_steps, z0, n_ls):
    """The fixed-schedule active-set projected-Newton loop (the reference's
    _newton_z, pallas_kl_dual.py:245-486).  Returns z as a list of dim
    (B,) tensors."""
    dtype, dim, k = ctx.dtype, ctx.dim, ctx.k
    hrow, ws, rsum = ctx.hrow, ctx.ws, ctx.rsum
    fi = torch.finfo(dtype)
    eps, tiny = fi.eps, fi.tiny
    B = ctx.Hs.shape[0]
    dev = ctx.Hs.device
    max_e = 0.9 * torch.log(torch.tensor(fi.max, dtype=dtype, device=dev))
    scale_deep = 1.0 / float(2 ** (n_ls - 1))
    inf = torch.full((B,), math.inf, dtype=dtype, device=dev)

    def step(z):
        y = ctx.y_of(z)
        yh, ryh = {}, {}
        for j in range(dim):
            if j != k:
                yh[j] = y * hrow(j)
                ryh[j] = rsum(yh[j])
        ry = rsum(y)
        f0 = ry
        for i in range(dim):
            f0 = f0 + ws[i] * z[i]
        g = [ws[j] - (ry if j == k else ryh[j]) for j in range(dim)]

        # active set: frozen coordinates get a unit row/col
        frees, gf = [], []
        for j in range(dim):
            if j < k:
                fr = torch.where((z[j] <= 0.0) & (g[j] > 0.0), 0.0, 1.0
                                 ).to(dtype)
            else:
                fr = torch.ones_like(g[j])
            frees.append(fr)
            gf.append(g[j] * fr)
        m = {}
        for i in range(dim):
            for j in range(i, dim):
                if i == k and j == k:
                    mij = ry
                elif i == k:
                    mij = ryh[j]
                elif j == k:
                    mij = ryh[i]
                else:
                    mij = rsum(yh[i] * hrow(j))
                mij = mij * frees[i] * frees[j]
                if i == j:
                    mij = mij + (1.0 - frees[i])
                    mij = mij * (1.0 + 10.0 * eps)
                m[(i, j)] = mij

        dz, sick = _solve_small(m, gf, dim)
        # sick: substitute a Jacobi-preconditioned gradient direction
        for j in range(dim):
            dz[j] = torch.where(sick, -gf[j] / m[(j, j)], dz[j])
        # a lam already at its bound cannot move down
        for j in range(k):
            dz[j] = torch.where((z[j] <= 0.0) & (dz[j] < 0.0), 0.0, dz[j])
        # fraction-to-boundary cap
        t_bd = inf
        for j in range(k):
            neg = dz[j] < 0
            tj = torch.where(neg, -z[j] / torch.where(neg, dz[j], -1.0),
                             math.inf)
            t_bd = torch.minimum(t_bd, tj)
        # far-field trust cap: at most L_TRUST = 8 per coordinate
        dz_inf = torch.zeros_like(ry)
        for j in range(dim):
            dz_inf = torch.maximum(dz_inf, torch.abs(dz[j]))
        t_trust = 8.0 / torch.clamp_min(dz_inf, 8.0)
        t_full = torch.minimum(torch.clamp(t_bd, 0.0, 1.0), t_trust)

        # line search, deepest candidate first: one exp, then a squaring
        # per level (exp(e/2^i)^2 = exp(e/2^(i-1)))
        wdir = dz[k][:, None]
        for j in range(dim):
            if j != k:
                wdir = wdir + dz[j][:, None] * hrow(j)
        e_deep = -(t_full * scale_deep)[:, None] * wdir
        # a lane whose deepest exponent already clips scores every
        # candidate on a distorted factor: disqualify the whole chain
        chain_bad = torch.amax(e_deep, dim=1) > max_e
        efac = torch.exp(torch.clamp(e_deep, -max_e, max_e))
        best_f = f0
        tf = torch.zeros_like(f0)
        t = t_full * scale_deep
        for lev in range(n_ls):
            ft = rsum(y * efac)
            for i in range(dim):
                ft = ft + ws[i] * (z[i] + t * dz[i])
            ft = torch.where(~torch.isfinite(ft) | chain_bad, math.inf, ft)
            # strict improvement over f0; on ties the larger t wins
            bf = (ft < f0) & (ft <= best_f)
            best_f = torch.where(bf, ft, best_f)
            tf = torch.where(bf, t, tf)
            if lev < n_ls - 1:
                efac = efac * efac
                t = 2.0 * t

        finite = torch.ones_like(f0, dtype=torch.bool)
        for j in range(dim):
            finite = finite & torch.isfinite(dz[j])
        f_ok = (best_f < f0) & finite
        # below the value's resolution no candidate beats f0: one fallback
        # candidate at t* = clip(-g.dz / dz'M dz, 0, t_full), accepted if
        # it shrinks the projected-gradient norm within the f0 noise band
        q = g[0] * dz[0]
        for j in range(1, dim):
            q = q + g[j] * dz[j]
        curv = torch.zeros_like(f0)
        for i in range(dim):
            for j in range(dim):
                mij = m[(i, j)] if i <= j else m[(j, i)]
                curv = curv + mij * dz[i] * dz[j]
        t_star = torch.minimum(
            torch.clamp_min(-q / torch.clamp_min(curv, tiny), 0.0), t_full)
        zs_ = [z[j] + t_star * dz[j] for j in range(dim)]
        ys_ = y * torch.exp(torch.clamp(-t_star[:, None] * wdir,
                                        -max_e, max_e))
        fs_ = ctx.val_of(zs_, ys_)
        gs_ = ctx.grad_of(zs_, ys_)
        noise = 32.0 * eps * (1.0 + torch.abs(f0))
        gn0 = ctx.pgnorm(z, g)
        g_ok = ((ctx.pgnorm(zs_, gs_) < 0.81 * gn0) & (fs_ <= f0 + noise)
                & finite)
        t_take = torch.where(f_ok, tf, t_star)
        take = f_ok | g_ok
        z_new = ctx.project([torch.where(take, z[j] + t_take * dz[j], z[j])
                             for j in range(dim)])
        if dim > 8:
            # projected full-step candidate (wide dims only): crosses all
            # descending boundaries at once; accepted on strict value
            # improvement over both f0 and the ray winner
            t_pr = torch.clamp_max(t_trust, 1.0)
            z_pr = ctx.project([z[j] + t_pr * dz[j] for j in range(dim)])
            f_pr = ctx.val_of(z_pr, ctx.y_of(z_pr))
            pr_ok = torch.isfinite(f_pr) & (f_pr < best_f) & finite
            z_new = [torch.where(pr_ok, z_pr[j], z_new[j])
                     for j in range(dim)]
        # snap boundary landings to 0, and purge a lam below ~32 eps scale
        # whose gradient says "decrease" (KKT-identified inactive) — the
        # boundary-jam fix; zinf is the OLD iterate's
        zinf = torch.zeros_like(f0)
        for j in range(dim):
            zinf = torch.maximum(zinf, torch.abs(z[j]))
        purge_th = 32.0 * eps * (1.0 + zinf)
        for j in range(k):
            z_new[j] = torch.where(
                (z_new[j] <= 8.0 * eps * torch.abs(z[j]))
                | ((g[j] > 0.0) & (z_new[j] <= purge_th)),
                0.0, z_new[j])
        return z_new

    z = [torch.full((B,), z0, dtype=dtype, device=dev) for _ in range(dim)]
    for _ in range(n_steps):
        z = step(z)
    return z


def _check_shapes(name, Hs, u, A, r, log_prior, *, n_steps, n_ls,
                  polish_steps=0):
    """Shape and schedule checks shared by the plain versions and the
    wrappers, with A and r both None or both given; returns m_eq."""
    if Hs.dim() != 3 or u.dim() != 2:
        raise ValueError(f"{name}: Hs must be (B, k, n) and u (B, k), got "
                         f"{tuple(Hs.shape)} and {tuple(u.shape)}")
    B, k, n = Hs.shape
    if (A is None) != (r is None):
        raise ValueError(f"{name}: A and r must be given together "
                         "(extra equality rows A x = r)")
    m_eq = 0 if A is None else A.shape[1]
    dim = k + 1 + m_eq
    if not (k + m_eq >= 1 and dim <= _FUSED_MAX_DIM):
        raise ValueError(
            f"{name} supports 1 <= k + m_eq and k + 1 + m_eq <= "
            f"{_FUSED_MAX_DIM}, got k={k}, m_eq={m_eq}")
    if tuple(u.shape) != (B, k) or (A is not None and (
            A.dim() != 3 or tuple(A.shape) != (B, m_eq, n)
            or tuple(r.shape) != (B, m_eq))):
        raise ValueError(f"{name}: shapes Hs {tuple(Hs.shape)}, u "
                         f"{tuple(u.shape)}, A "
                         f"{None if A is None else tuple(A.shape)}, r "
                         f"{None if r is None else tuple(r.shape)} do not "
                         "agree")
    if log_prior is not None and tuple(log_prior.shape) != (n,):
        raise ValueError(f"{name}: log_prior must be ({n},), got "
                         f"{tuple(log_prior.shape)}")
    if n < 1 or n_steps < 0 or polish_steps < 0 or not 1 <= n_ls <= _MAX_LS:
        raise ValueError(f"{name}: need n >= 1, n_steps >= 0, polish_steps "
                         f">= 0 and 1 <= n_ls <= {_MAX_LS}")
    return m_eq


def _check_args(name, Hs, u, A, r, log_prior, *, n_steps, n_ls,
                polish_steps=0):
    """``_check_shapes``; returns (A, r) with empty (B, 0, n) / (B, 0)
    stand-ins for absent ones."""
    _check_shapes(name, Hs, u, A, r, log_prior, n_steps=n_steps, n_ls=n_ls,
                  polish_steps=polish_steps)
    if A is None:
        B, _, n = Hs.shape
        A = Hs.new_zeros((B, 0, n))
        r = u.new_zeros((B, 0))
    return A, r


def _uniform_log_prior(n, dtype, device):
    return torch.full((n,), -math.log(n), dtype=dtype, device=device)


def kl_dual_fused_plain(Hs, u, A=None, r=None, log_prior=None, *,
                        n_steps=16, z0=1e-3, n_ls=5):
    """Plain PyTorch version of K1 (any device, f32 or f64).

    Returns ``(x, gap, z)``: the recovered primal distributions (B, n),
    the measured per-instance gap f(x) - g(z) (+inf on a dead lane whose
    sum(y) underflowed to 0), and the dual iterate z (B, k + 1 + mE) in
    the layout [lam, nu_sum1, nu_A].
    """
    A, r = _check_args("kl_dual_fused", Hs, u, A, r, log_prior,
                       n_steps=n_steps, n_ls=n_ls)
    n = Hs.shape[2]
    logp = (_uniform_log_prior(n, Hs.dtype, Hs.device) if log_prior is None
            else log_prior.to(Hs.dtype))
    ctx = _Ctx(Hs, u, A, r, logp)
    z = _newton_z(ctx, n_steps=n_steps, z0=z0, n_ls=n_ls)
    y = ctx.y_of(z)
    sy = ctx.rsum(y)
    # sum(y) can underflow to exactly 0 (the unbounded dual of an
    # infeasible instance): gap +inf instead of NaN
    dead = sy <= 0.0
    x = y / torch.where(dead, 1.0, sy)[:, None]
    logx = torch.log(torch.where(x > 0, x, 1.0))
    f_primal = ctx.rsum(x * (logx - logp))
    gap = torch.where(dead, math.inf, f_primal + ctx.val_of(z, y))
    return x, gap, torch.stack(z, dim=1)


# --------------------------------------------------------------- plain K2
def _polish_f64(ctx, z, steps, *, guard_sick, solve=_solve_small):
    """Warm projected-Newton polish in f64 (the algebra of the reference's
    models/dist_kl.py::_kl_warm_polish): no line search, a full step
    capped at the first lam boundary, a snap at 8 eps |z|, and no step for
    a non-finite or oversized (|dz| > 1e3) direction.  ``guard_sick``
    also refuses the step of a sick (near-singular) system, as the TPU
    certified kernel's _ds_polish does (pallas_kl_dual.py:608-615); the
    reference's XLA f64 finish has no such guard.  ``solve(m, gf, dim)``
    returns (dz, sick) for the upper-triangle dict ``m``; the default is
    the kernels' unrolled solve."""
    dim, k, ws = ctx.dim, ctx.k, ctx.ws
    eps = torch.finfo(torch.float64).eps
    max_e = 0.9 * math.log(torch.finfo(torch.float64).max)
    for _ in range(steps):
        y = torch.exp(torch.clamp(-(ctx.btz_of(z)) - 1.0 + ctx.logp,
                                  -max_e, max_e))
        ry = ctx.rsum(y)
        yh = {j: y * ctx.hrow(j) for j in range(dim) if j != k}
        s = {j: (ry if j == k else ctx.rsum(yh[j])) for j in range(dim)}
        g = [ws[j] - s[j] for j in range(dim)]
        frees = [torch.where((z[j] <= 0.0) & (g[j] > 0.0), 0.0, 1.0
                             ).to(torch.float64) if j < k
                 else torch.ones_like(ry) for j in range(dim)]
        gf = [g[j] * frees[j] for j in range(dim)]
        m = {}
        for i in range(dim):
            for j in range(i, dim):
                if i == k:
                    mij = s[j]
                elif j == k:
                    mij = s[i]
                else:
                    mij = ctx.rsum(yh[i] * ctx.hrow(j))
                mij = mij * frees[i] * frees[j]
                if i == j:
                    mij = mij + (1.0 - frees[i])
                    # ridge at 1e-13 of the diagonal
                    mij = mij + 1e-13 * mij
                m[(i, j)] = mij
        dz, sick = solve(m, gf, dim)
        for j in range(k):
            dz[j] = torch.where((z[j] <= 0.0) & (dz[j] < 0.0), 0.0, dz[j])
        t_bd = torch.full_like(ry, math.inf)
        for j in range(k):
            neg = dz[j] < 0.0
            t_bd = torch.minimum(t_bd, torch.where(
                neg, -z[j] / torch.where(neg, dz[j], -1.0), math.inf))
        t = torch.clamp_max(t_bd, 1.0)
        ok = ~sick if guard_sick else torch.ones_like(sick)
        dz_inf = torch.zeros_like(ry)
        z_new = []
        for j in range(dim):
            nj = z[j] + t * dz[j]
            if j < k:
                nj = torch.clamp_min(nj, 0.0)
                nj = torch.where(nj <= 8.0 * eps * torch.abs(z[j]), 0.0, nj)
            ok = ok & torch.isfinite(nj)
            dz_inf = torch.maximum(dz_inf, torch.abs(dz[j]))
            z_new.append(nj)
        ok = ok & (dz_inf <= 1e3)
        z = [torch.where(ok, z_new[j], z[j]) for j in range(dim)]
    return z


def _residuals(ctx, x):
    """Measured residuals of iterates x (B, n): ineq = max(-x, Hx - u)_+
    and eq = max |B_j x - w_j| over the full equality system (the
    sum-to-one row first)."""
    k, dim, ws = ctx.k, ctx.dim, ctx.ws
    viol = torch.clamp_min(torch.amax(-x, dim=1), 0.0)
    for i in range(k):
        ri = ctx.rsum(x * ctx.hrow(i)) - ws[i]
        viol = torch.maximum(viol, torch.clamp_min(ri, 0.0))
    eq = torch.abs(ctx.rsum(x) - 1.0)
    for j in range(k + 1, dim):
        eq = torch.maximum(eq, torch.abs(ctx.rsum(x * ctx.hrow(j)) - ws[j]))
    return viol, eq


def _certify_f64(ctx, z):
    """One exp pass serves the refined primal, both gap terms and the
    residuals (kl_certify(z0=..., compare_input=False) of
    models/dist_kl.py, and the epilogue of the TPU certified kernel):
    x = y / sum(y), gap = f(x) - g(z) with log x - log p collapsed to
    -B'z - 1 - log sum(y), the residuals of ``_residuals``, gap = +inf on
    a dead lane.  Returns (x, gap, ineq, eq, g(z))."""
    dim, ws = ctx.dim, ctx.ws
    btz = ctx.btz_of(z)
    y = torch.exp(-btz - 1.0 + ctx.logp)
    sy = ctx.rsum(y)
    dead = sy <= 0.0
    x = y / torch.where(dead, 1.0, sy)[:, None]
    wz = ws[0] * z[0]
    for j in range(1, dim):
        wz = wz + ws[j] * z[j]
    dval = wz + sy
    f_ref = -ctx.rsum(x * btz) - 1.0 - torch.log(sy)
    gap = torch.where(dead, math.inf, f_ref + dval)
    viol, eq = _residuals(ctx, x)
    return x, gap, viol, eq, dval


def _stalled(x, gap, ineq, tol, tol_feas, eq=None):
    """stalled = not(|gap| <= tol and ineq <= tol_feas [and eq <=
    tol_feas]), or a non-finite x.  |gap|: an infeasible instance's dual
    drives the gap to -inf; the measured residuals join because a small
    gap alone cannot certify feasibility; the not-<= form flags NaN."""
    ok = (torch.abs(gap) <= tol) & (ineq <= tol_feas)
    if eq is not None:
        ok = ok & (eq <= tol_feas)
    return ~torch.all(torch.isfinite(x), dim=-1) | ~ok


def _cert_leaves(x, gap, ineq, tol, tol_feas, steps, eq=None):
    """A KL route's per-instance Solution leaves by the torch rule, as K2's
    epilogue writes them: ``(stalled, nan, iters, maxed_out)``, stalled by
    ``_stalled`` (``eq`` joins it where given), the NaN leaf in x's dtype
    (f64 on the certified routes) and iters int64."""
    dev = x.device
    return (_stalled(x, gap, ineq, tol, tol_feas, eq=eq),
            torch.full(gap.shape, math.nan, dtype=x.dtype, device=dev),
            torch.full(gap.shape, steps, device=dev),
            torch.zeros(gap.shape, dtype=torch.bool, device=dev))


def kl_dual_fused_cert_plain(Hs, u, A=None, r=None, log_prior=None, *,
                             n_steps=16, polish_steps=2, z0=1e-3, n_ls=5,
                             tol=1e-8, tol_feas=1e-7):
    """Plain PyTorch version of K2 (any device).

    ``Hs``/``u``/``A``/``r`` are f32 problem data; ``log_prior`` (n,)
    should carry full f64 precision (None = uniform).  Runs the K1 f32
    schedule, then ``polish_steps`` warm Newton steps and the certificate
    in f64.  Returns f64 ``(x, z, gap, ineq_res, eq_res)``, then the
    Solution's per-instance leaves (``_cert_leaves``): ``stalled``
    (``_stalled`` at ``tol`` and ``tol_feas``, equality residual
    included), an f64 NaN leaf, ``iters`` (int64, n_steps + polish_steps)
    and ``maxed_out`` (False).
    """
    A, r = _check_args("kl_dual_fused_cert", Hs, u, A, r, log_prior,
                       n_steps=n_steps, n_ls=n_ls, polish_steps=polish_steps)
    n = Hs.shape[2]
    f32, f64 = torch.float32, torch.float64
    lp64 = (_uniform_log_prior(n, f64, Hs.device) if log_prior is None
            else log_prior.to(f64))
    ctx32 = _Ctx(Hs.to(f32), u.to(f32), A.to(f32), r.to(f32), lp64.to(f32))
    z32 = _newton_z(ctx32, n_steps=n_steps, z0=z0, n_ls=n_ls)
    # f32 data lift to f64 exactly
    ctx = _Ctx(Hs.to(f64), u.to(f64), A.to(f64), r.to(f64), lp64)
    z = _polish_f64(ctx, [zj.to(f64) for zj in z32], polish_steps,
                    guard_sick=True)
    x, gap, ineq, eq, _ = _certify_f64(ctx, z)
    return (x, torch.stack(z, dim=1), gap, ineq, eq,
            *_cert_leaves(x, gap, ineq, tol, tol_feas, n_steps + polish_steps,
                          eq=eq))


# --------------------------------------------------------------- wrappers
def _kernel_args(name, dtype, tensors, log_prior, lp_dtype):
    """Checks the kernel's dtype, device and stride contract and returns
    the element strides; raises on anything the kernel does not take."""
    Hs, u, A, r = tensors
    dev = Hs.device
    given = [t for t in tensors if t is not None]
    for t in (*given, log_prior):
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"one on {t.device}")
    for t in given:
        if t.dtype != dtype:
            raise ValueError(f"{name}: the CUDA kernel takes {dtype} "
                             f"Hs/u/A/r, got {t.dtype}")
    if log_prior.dtype != lp_dtype:
        raise ValueError(f"{name}: the CUDA kernel takes a {lp_dtype} "
                         f"log_prior, got {log_prior.dtype}")
    n = Hs.shape[2]
    for t in (Hs, A):
        if n > 1 and t is not None and t.shape[1] > 0 and t.stride(2) != 1:
            raise ValueError(f"{name}: the lane axis of Hs and A must be "
                             "contiguous (stride 1); call .contiguous()")
    if n > 1 and log_prior.stride(0) != 1:
        raise ValueError(f"{name}: log_prior must be contiguous")
    # absent A and r (no extra equality rows): null pointers, which the
    # kernel never reads, at stride 0
    rows = (A.stride(0), A.stride(1), r.stride(0), r.stride(1)) \
        if A is not None else (0, 0, 0, 0)
    return (Hs.stride(0), Hs.stride(1), u.stride(0), u.stride(1)) + rows


@span("cvx.kernel.kl_dual_fused")
def kl_dual_fused(Hs, u, A=None, r=None, log_prior=None, *, n_steps=16,
                  z0=1e-3, n_ls=5):
    """K1: solve a batch of KL duals; returns ``(x, gap, z)`` as
    ``kl_dual_fused_plain`` does.

    CPU tensors run the plain version.  CUDA tensors (f32 or f64, all of
    one dtype) run the CUDA kernel on the current stream (``path_of`` says
    which path); anything it does not take raises.  ``kl_dual_fused.launches``
    counts kernel launches.
    """
    A, r = _check_args("kl_dual_fused", Hs, u, A, r, log_prior,
                       n_steps=n_steps, n_ls=n_ls)
    B, k, n = Hs.shape
    if log_prior is None:
        log_prior = _uniform_log_prior(n, Hs.dtype, Hs.device)
    if Hs.device.type == "cpu":
        return kl_dual_fused_plain(Hs, u, A, r, log_prior, n_steps=n_steps,
                                   z0=z0, n_ls=n_ls)
    if Hs.device.type != "cuda" or Hs.dtype not in (torch.float32,
                                                    torch.float64):
        raise ValueError("kl_dual_fused: takes CPU tensors or f32/f64 CUDA "
                         f"tensors, got {Hs.dtype} on {Hs.device}")
    strides = _kernel_args("kl_dual_fused", Hs.dtype, (Hs, u, A, r),
                           log_prior, Hs.dtype)
    dim = k + 1 + A.shape[1]
    x = torch.empty((B, n), dtype=Hs.dtype, device=Hs.device)
    gap = torch.empty((B,), dtype=Hs.dtype, device=Hs.device)
    z = torch.empty((B, dim), dtype=Hs.dtype, device=Hs.device)
    if B == 0:
        return x, gap, z
    unit, fn = (("kl_dual_f32", "kl_dual_fused_f32")
                if Hs.dtype == torch.float32
                else ("kl_dual_f64", "kl_dual_fused_f64"))
    ptr = _build.ptr
    _build.launch(_build.load(unit), fn, "kl_dual_fused", Hs.device,
                  ptr(Hs), ptr(u), ptr(A), ptr(r), ptr(log_prior), *strides,
                  ptr(x), ptr(gap), ptr(z), B, n, k, A.shape[1], n_steps,
                  float(z0), n_ls)
    kl_dual_fused.launches += 1
    return x, gap, z


kl_dual_fused.launches = 0


@span("cvx.kernel.kl_dual_fused_cert")
def kl_dual_fused_cert(Hs, u, A=None, r=None, log_prior=None, *,
                       n_steps=16, polish_steps=2, z0=1e-3, n_ls=5,
                       tol=1e-8, tol_feas=1e-7):
    """K2: certified batch solve; returns f64 ``(x, z, gap, ineq_res,
    eq_res)`` and the leaves ``(stalled, nan, iters, maxed_out)`` as
    ``kl_dual_fused_cert_plain`` does.

    CPU tensors run the plain version.  CUDA tensors need f32
    Hs/u/A/r and an f64 log_prior (None = uniform) and run the CUDA
    kernel, which writes every output; anything it does not take raises.
    ``kl_dual_fused_cert.launches`` counts kernel launches.
    """
    kw = dict(n_steps=n_steps, polish_steps=polish_steps, n_ls=n_ls)
    if Hs.device.type == "cpu":
        return kl_dual_fused_cert_plain(Hs, u, A, r, log_prior, z0=z0,
                                        tol=tol, tol_feas=tol_feas, **kw)
    m_eq = _check_shapes("kl_dual_fused_cert", Hs, u, A, r, log_prior, **kw)
    B, k, n = Hs.shape
    dev = Hs.device
    if log_prior is None:
        log_prior = _uniform_log_prior(n, torch.float64, dev)
    if dev.type != "cuda":
        raise ValueError("kl_dual_fused_cert: takes CPU or CUDA tensors, "
                         f"got {dev}")
    strides = _kernel_args("kl_dual_fused_cert", torch.float32,
                           (Hs, u, A, r), log_prior, torch.float64)
    dim = k + 1 + m_eq
    # one buffer a dtype: x, z, then gap, ineq, eq and the NaN leaf; iters;
    # stalled and maxed_out.  as_strided makes each view in one op (split
    # and unbind cost more host time than separate allocations)
    f64 = torch.empty(B * (n + dim + 4), dtype=torch.float64, device=dev)
    iters = torch.empty(B, dtype=torch.int64, device=dev)
    flags = torch.empty(2 * B, dtype=torch.bool, device=dev)
    at, o = f64.as_strided, B * (n + dim)
    x, z = at((B, n), (n, 1), 0), at((B, dim), (dim, 1), B * n)
    gap, ineq, eq, nan = (at((B,), (1,), o + j * B) for j in range(4))
    stalled, maxed = (flags.as_strided((B,), (1,), j * B) for j in range(2))
    out = (x, z, gap, ineq, eq, stalled, nan, iters, maxed)
    if B == 0:
        return out
    ptr = _build.ptr
    _build.launch(_build.load("kl_dual_cert"), "kl_dual_fused_cert_f32",
                  "kl_dual_fused_cert", dev,
                  ptr(Hs), ptr(u), None if A is None else ptr(A),
                  None if r is None else ptr(r), ptr(log_prior), *strides,
                  *(ptr(t) for t in out), B, n, k, m_eq, n_steps, float(z0),
                  n_ls, polish_steps, float(tol), float(tol_feas))
    kl_dual_fused_cert.launches += 1
    return out


kl_dual_fused_cert.launches = 0
