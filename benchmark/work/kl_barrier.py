"""The work of K3 (``kl_barrier_fused``): its operations and bytes for one
launch.

Frozen copies, from commit 61015afd76d76d8ead80eef8352088353340c2cc, of
``k3_ops`` in ``cvx_tpu_torch/_bench.py`` and of the candidate count of
``kl_barrier_fused_plain`` / ``_candidates_needed`` / ``_schedule`` /
``fused_n_outer`` in ``cvx_tpu_torch/ops/kl_barrier.py`` (with
``cvx_tpu_torch/ops/cholesky.py``'s f32 ``default_delta``).  The line
search stops at its first accepted candidate, so the work depends on the
data: ``candidates`` replays the algorithm on the same inputs and counts
the candidates they need, as the kernel evaluates them.  An exp or log
counts as one operation at the float peak, so the count errs low.
"""

import math

import torch

from .peaks import least_seconds

F32 = 4
T0, ALPHA, BETA, N_LS = 1.0, 0.04, 0.8, 12   # kl_barrier_fused defaults
DELTA_F32 = 3e-6                               # default_delta(float32)


def n_outer(m_total, mu, tol, t0=T0):
    """Continuation stages so that m_total / (t0 mu^(n_outer - 1)) <=
    tol."""
    return max(2, math.ceil(math.log(m_total / (tol * t0)) / math.log(mu))
               + 1)


def schedule(k, n, pars):
    """(n_outer, n_inner) of the fused route for k rows and n coordinates
    under the solver parameters ``pars`` (max_iter, mu, tol)."""
    return (n_outer(k + n, pars["mu"], pars["tol"]),
            min(int(pars["max_iter"]), 8))


def k3_ops(k, n, B, n_steps, n_cand):
    """Operations for B instances of n coordinates over n_steps steps that
    needed n_cand line-search candidates in all.  Per coordinate and step:
    margins and f0 (2k + 6, one log), gradient / 1/h / Woodbury sums
    (9 + 7k + k(k + 1)), H^-1 g, H^-1 a and Schur sums (6 + 5k), dx, q,
    rows . dx and the step bound (8 + 2k), the update (2); per candidate 7
    and a log."""
    per_step = 31 + 16 * k + k * (k + 1) + 1
    return n * (B * n_steps * per_step + 8 * n_cand)


def k3_bytes(B, n, k):
    """The shared rows, the ones row and its right-hand side, the bounds
    and x0 read once; x written once (f32)."""
    return (k * n + n + 1 + B * k + 2 * B * n) * F32


def candidates(H, u, x0, pars):
    """Line-search candidates (summed over instances and steps) that K3
    evaluates on bounds u (B, k) from x0 (B, n) with the shared rows H
    (k, n), f32, by replaying the plain algorithm: 0 for a step whose
    search is gated, else the index of the first accepted candidate plus
    1, or all N_LS when none is accepted."""
    dtype, dev = torch.float32, x0.device
    B, n = x0.shape
    k = H.shape[0]
    outer, inner = schedule(k, n, pars)
    stage = torch.arange(outer, device=dev).to(dtype)
    c = torch.full((), float(pars["mu"]), dtype=dtype, device=dev)
    ts = T0 * torch.exp(stage * torch.log(c))
    kk = torch.arange(N_LS, device=dev)
    expo = torch.where(kk < 32, kk, 32 + 3 * (kk - 32)).to(dtype)
    ls_ts = torch.pow(torch.full((), BETA, dtype=dtype, device=dev), expo)
    lognv = torch.log(torch.full((), float(n), dtype=dtype, device=dev))
    descending = bool((ls_ts[1:] <= ls_ts[:-1]).all())
    has_neg = bool((ls_ts < 0).any())
    eps_mach = torch.finfo(dtype).eps
    rows = [H[j].to(dtype)[None].expand(B, n) for j in range(k)]
    ubs = [u[:, j:j + 1].to(dtype) for j in range(k)]
    a0 = torch.ones((B, n), dtype=dtype, device=dev)
    bb = torch.ones((B, 1), dtype=dtype, device=dev)
    count = torch.zeros(B, dtype=torch.int64, device=dev)
    idx = torch.arange(N_LS, device=dev)

    def rdot(a, b):
        return (a * b).sum(dim=1, keepdim=True)

    x = x0.to(dtype).clone()
    for i in range(outer * inner):
        t = ts[i // inner]
        ds = [ubs[j] - rdot(rows[j], x) for j in range(k)]
        inv_ds = [1.0 / dj for dj in ds]
        logx = torch.log(x)
        g = t * (1.0 + lognv + logx) - 1.0 / x
        for j in range(k):
            g = g + rows[j] * inv_ds[j]
        h = t / x + 1.0 / (x * x)
        inv_h = 1.0 / h
        uds = [rows[j] * inv_h for j in range(k)]
        if k == 2:
            m00 = rdot(uds[0], rows[0]) + ds[0] * ds[0]
            m11 = rdot(uds[1], rows[1]) + ds[1] * ds[1]
            m01 = rdot(uds[0], rows[1])
            sc = 0.5 * (torch.abs(m00) + torch.abs(m11))
            m00 = m00 + DELTA_F32 * sc
            m11 = m11 + DELTA_F32 * sc
            det = m00 * m11 - m01 * m01
            i00, i01, i11 = m11 / det, -m01 / det, m00 / det

            def solve_h(r):
                s0 = rdot(uds[0], r)
                s1 = rdot(uds[1], r)
                y0 = i00 * s0 + i01 * s1
                y1 = i01 * s0 + i11 * s1
                return r * inv_h - uds[0] * y0 - uds[1] * y1
        else:
            m00 = (rdot(uds[0], rows[0]) + ds[0] * ds[0]) * (1.0 + DELTA_F32)
            i00 = 1.0 / m00

            def solve_h(r):
                return r * inv_h - uds[0] * (i00 * rdot(uds[0], r))

        hig = solve_h(g)
        hia = solve_h(a0)
        S = rdot(a0, hia)
        wv = -((bb - rdot(a0, x)) + rdot(a0, hig)) / S
        dx = -(hig + hia * wv)
        q = rdot(dx, g)
        udxs = [rdot(rows[j], dx) for j in range(k)]
        sx = torch.where(dx < 0, -x / dx, math.inf).amin(dim=1, keepdim=True)
        s_max = torch.clamp(sx, max=1.0 / 0.99)
        for j in range(k):
            s_max = torch.minimum(s_max, torch.where(udxs[j] > 0,
                                                     ds[j] / udxs[j],
                                                     math.inf))
        s_max = 0.99 * s_max
        f0 = t * rdot(x, lognv + logx) - logx.sum(dim=1, keepdim=True)
        for j in range(k):
            f0 = f0 - torch.log(ds[j])
        ss = s_max * ls_ts[None, :]
        xs = x[:, None, :] + ss[:, :, None] * dx[:, None, :]
        ok = torch.all(xs > 0, dim=2)
        log_xs = torch.log(torch.where(xs > 0, xs, 1.0))
        fs = t * (xs * (lognv + log_xs)).sum(dim=2) - log_xs.sum(dim=2)
        for j in range(k):
            dsj = ds[j] - ss * udxs[j]
            ok = ok & (dsj > 0)
            fs = fs - torch.log(torch.where(dsj > 0, dsj, 1.0))
        accepted = ok & (fs <= f0 + ALPHA * ss * q)
        s_best = torch.where(accepted, ss, 0.0).amax(dim=1, keepdim=True)
        q_ok = q < -eps_mach
        s_best = torch.where(q_ok, s_best, 0.0)
        # the candidates the kernel evaluates in this step
        first = torch.where(accepted & (ss > 0), idx, N_LS - 1).amin(dim=1) + 1
        s_pos = (s_max > 0)[:, 0]
        needed = (torch.where(s_pos, first, N_LS) if descending
                  else torch.full_like(first, N_LS))
        searched = q_ok[:, 0] & (s_pos | has_neg)
        count += torch.where(searched, needed, 0)
        x = torch.where(s_best > 0, x + s_best * dx, x)
    return int(count.sum())


def k3_least_seconds(H, u, x0, pars):
    """(least seconds, what sets it) of one K3 launch on these inputs."""
    k, n = H.shape
    B = x0.shape[0]
    outer, inner = schedule(k, n, pars)
    ops = k3_ops(k, n, B, outer * inner, candidates(H, u, x0, pars))
    return least_seconds(k3_bytes(B, n, k), ops32=ops)
