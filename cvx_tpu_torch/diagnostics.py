"""Observability: profiling, the program's spans and counters, solve
counters, per-stage barrier history and the host-side KL certificate.

Counterpart of ``cvx_tpu/diagnostics.py`` (the reference's Logger and
debugLevel dumps, SURVEY.md sections 5.1/5.5):

  * ``trace(log_dir)``: a ``torch.profiler`` context around a solve that
    writes a Chrome trace (view in Perfetto or chrome://tracing), with
    the program's spans among the host events;
  * ``span(name)``: a host range, as a context manager or a decorator,
    recorded by ``torch.profiler`` while one records (on the clock of the
    device's activity) and one flag check otherwise.  The program's spans:
    ``cvx.entry.solve_certified_batch`` / ``cvx.entry.solve_jittable_batch``
    (``DistKL``'s batched entries), ``cvx.route.cert_solution`` /
    ``cvx.route.fused_solution`` (the Solution a route assembles),
    ``cvx.cert.kl_dual_gap``, ``cvx.cert.polish_dual`` and
    ``cvx.cert.kl_certify`` (the certificates), ``cvx.kernel.<wrapper>``
    for ``kl_dual_fused``, ``kl_dual_fused_cert``, ``kl_barrier_fused``,
    ``kl_gap_fused`` and ``cholesky_batched_cuda`` (CPU path too; on the
    card ``cvx.cert.polish_dual`` is inside ``kl_dual_gap`` only where it
    takes the torch chain), ``cvx.kernel.launch`` (the
    launch of a built kernel) and ``cvx.build.load`` (a kernel library's
    first use: build or load);
  * ``counters()``: the program's counters in one dict;
  * ``solve_stats``: summary counters of a (batched) Solution;
  * ``barrier_history``: a host loop of one-stage barrier solves that
    records the state after every continuation stage;
  * ``kl_gap_certificate_np``: pure NumPy f64, copied because the
    reference's module imports jax.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Any

import numpy as np
import torch

from ._spans import span
from .ops import _build
from .ops.chol import cholesky_batched_cuda
from .ops.kl_barrier import kl_barrier_fused, kl_barrier_fused_plain
from .models.dist_kl import _cert_solution, kl_dual_gap
from .ops.kl_dual import kl_dual_fused, kl_dual_fused_cert
from .ops.kl_gap import kl_gap_fused
from .problem.constraint_set import ConstraintSet
from .solvers.barrier import barrier_solve
from .solvers.types import SolverParams


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile everything inside the context with ``torch.profiler`` (the
    CPU, and the card where there is one) and write the Chrome trace to
    ``log_dir/trace.json`` (default: a directory under the temporary
    directory).  Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "cvx_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def counters() -> dict:
    """The program's counters since the process started: each kernel
    wrapper's launches (its ``.launches``), ``kl_dual_gap_chain_calls``
    (CUDA calls of ``kl_dual_gap`` that ran the torch chain, not
    ``kl_gap_fused``'s kernel), ``kl_barrier_schedule_torch`` (K3 solves
    whose schedule ``_schedule`` built as tensors: the plain version, so
    CPU calls; on the card the kernel works it out and
    ``kl_barrier_fused`` counts the launch), ``cert_leaves_fused`` /
    ``cert_leaves_torch`` (certified Solutions whose per-instance leaves
    K2 wrote on the card / that the torch rule made: the f64 route,
    ``solve_certified``, the CPU), ``nvcc_runs`` (unit -> nvcc runs),
    ``kernel_loads`` and ``kernel_load_s`` (kernel libraries built or
    loaded at first use, and the host seconds that took)."""
    out = {f.__name__: f.launches for f in (
        kl_dual_fused, kl_dual_fused_cert, kl_barrier_fused, kl_gap_fused,
        cholesky_batched_cuda)}
    out.update(kl_dual_gap_chain_calls=kl_dual_gap.chain_calls,
               kl_barrier_schedule_torch=(
                   kl_barrier_fused_plain.schedule_torch),
               cert_leaves_fused=_cert_solution.leaves_fused,
               cert_leaves_torch=_cert_solution.leaves_torch,
               nvcc_runs=dict(_build.nvcc_runs),
               kernel_loads=_build.kernel_loads,
               kernel_load_s=_build.kernel_load_s)
    return out


def solve_stats(sol) -> dict:
    """Summary counters for a Solution (batched or single).

    ``stalled_frac``/``maxed_out_frac`` surface the per-instance failure
    flags (Solution.status), so a batch with poisoned instances reports
    them instead of silently returning non-converged iterates."""
    def host(v):
        return v.detach().cpu().numpy()

    iters = host(sol.iters)
    gap = host(sol.duality_gap)
    stalled = host(sol.stalled)
    return {
        "num_instances": int(iters.size),
        "newton_iters_total": int(iters.sum()),
        "newton_iters_mean": float(iters.mean()),
        "newton_iters_max": int(iters.max()),
        "gap_max": float(np.max(gap)),
        "gap_median": float(np.median(gap)),
        "maxed_out_frac": float(np.mean(host(sol.maxed_out))),
        "stalled_frac": float(np.mean(stalled)),
        "stalled_instances": np.flatnonzero(
            np.atleast_1d(stalled)).tolist()[:32],
    }


def barrier_history(obj: Any, cnts: ConstraintSet, x0,
                    pars: SolverParams | None = None, eqs=None,
                    max_stages: int = 20) -> list[dict]:
    """Run the barrier continuation of one instance stage by stage (a
    host loop over t), recording gap / objective / equality error /
    Newton iterations after each stage.  ``x0`` (n,) or (1, n).  A
    debugging tool: the production solver is ``barrier_solve``."""
    pars = pars or SolverParams()
    history = []
    x = x0 if x0.dim() == 2 else x0[None]
    t = 1.0
    one_stage = dataclasses.replace(pars, outer_max_iter=1)
    for stage in range(max_stages):
        sol = barrier_solve(obj, cnts, x, one_stage, eqs=eqs, t0=t)
        x = sol.x
        rec = {
            "stage": stage,
            "t": t,
            "gap": float(sol.duality_gap[0]),
            "obj": float(obj.value(x)[0]),
            "eq_gap": float(sol.eq_gap[0]),
            "newton_iters": int(sol.iters[0]),
        }
        history.append(rec)
        if rec["gap"] < float(pars.tol):
            break
        t *= float(pars.mu)
    return history


def kl_gap_certificate_np(X, H, u, steps: int = 10, prior=None):
    """Batched HOST-side (numpy f64) duality-gap certificate for KL
    instances — the honesty check, outside any timed region.

    ``X`` (batch, n) returned iterates; ``H`` (k, n) shared scenario rows;
    ``u`` (batch, k) per-instance bounds.  The sum-to-one equality row is
    implied.  Least-squares dual fit + active-set projected-Newton polish
    on the closed-form dual -g(z) (each accepted step improves a valid
    bound), then gap_i = f(x_i) - g(z_i) <= f(x_i) - p*_i.  Returns (batch,)
    gaps.
    """
    X = np.asarray(X, np.float64)
    # coordinates that underflowed to exactly 0 would give log(0) = -inf
    # and NaN-poison the whole instance; x log(n x) -> 0 as x -> 0+, so
    # clamping to a tiny positive value changes f(x) by < 1e-28
    X = np.maximum(X, 1e-30)
    Hf = np.asarray(H, np.float64)
    batch, n = X.shape
    # general prior (None = the reference's uniform): R = p/e and
    # log(n x) becomes log x - log p throughout
    if prior is None:
        logp = np.full(n, -np.log(n))
        R = np.full(n, 1.0 / n) / np.e
    else:
        p = np.asarray(prior, np.float64)
        logp = np.log(p)
        R = p / np.e
    k = Hf.shape[0]
    dim = k + 1
    B = np.vstack([Hf, np.ones((1, n))])           # (k+1, n)
    W = np.column_stack([np.asarray(u, np.float64),
                         np.ones(batch)])          # (batch, k+1)
    C = -(1.0 + np.log(X) - logp[None, :])
    Z = C @ np.linalg.pinv(B.T).T                  # lstsq fit
    Z[:, :k] = np.clip(Z[:, :k], 0.0, None)

    def neg_g(Z_):
        return (np.sum(W * Z_, axis=1)
                + np.sum(np.exp(-(Z_ @ B)) * R[None, :], axis=1))

    def project(Z_):
        out = Z_.copy()
        out[:, :k] = np.clip(out[:, :k], 0.0, None)
        return out

    f0 = neg_g(Z)
    eye = np.eye(dim)
    eps = np.finfo(np.float64).eps
    for _ in range(steps):
        # pre-snap positive-but-below-rounding lam to exactly 0 so the
        # active-set freeze can see it
        tiny = 64.0 * eps * (1.0 + np.max(np.abs(Z), axis=1, keepdims=True))
        Z[:, :k] = np.where(Z[:, :k] <= tiny, 0.0, Z[:, :k])
        Y = np.exp(-(Z @ B)) * R[None, :]
        grad = W - Y @ B.T
        at_bound = np.zeros((batch, dim), bool)
        at_bound[:, :k] = (Z[:, :k] <= 0.0) & (grad[:, :k] > 0.0)
        freef = (~at_bound).astype(np.float64)
        gf = np.where(at_bound, 0.0, grad)
        Hd = np.einsum("bn,in,jn->bij", Y, B, B)
        Hd = (Hd * freef[:, :, None] * freef[:, None, :]
              + np.einsum("bi,ij->bij", 1.0 - freef, eye))
        Hd += (1e-12 * np.trace(Hd, axis1=1, axis2=2)[:, None, None] / dim
               + 1e-300) * eye
        dZ = -np.linalg.solve(Hd, gf[..., None])[..., 0]
        neg = np.zeros((batch, dim), bool)
        neg[:, :k] = dZ[:, :k] < 0.0
        with np.errstate(divide="ignore", invalid="ignore"):
            t_bd = np.min(np.where(neg, -Z / np.where(neg, dZ, -1.0),
                                   np.inf), axis=1)
        t_bd = np.clip(np.nan_to_num(t_bd, nan=1.0, posinf=1.0), 0.0, 1.0)
        took = np.zeros(batch, bool)
        for tc in [None, 1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125]:
            t_arr = t_bd[:, None] if tc is None else tc
            Zt = project(Z + t_arr * dZ)
            ft = neg_g(Zt)
            acc = ~took & np.isfinite(ft) & (ft < f0)
            Z[acc] = Zt[acc]
            f0[acc] = ft[acc]
            took |= acc
    primal = np.sum(X * (np.log(X) - logp[None, :]), axis=1)
    return primal - (-f0)
