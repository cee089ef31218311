"""Dry run of the parallel layer on spawned ranks.

Counterpart of ``dryrun_multichip`` in the reference's entry module
(``__graft_entry__.py``): it runs the six shardings once on tiny shapes,
each held against its local run on the same rank:

  * dp: the instance batch of the KL barrier solve ("BR") split over
    the ranks (``shard_solve``);
  * blocks: a block-separable QP whose Newton-KKT systems couple through
    the all-reduced Schur complement (``make_sharded_schur_solver``);
  * m: the constraint rows of the barrier method split over the ranks
    (``barrier_solve_msharded``);
  * m, primal-dual: the same for the primal-dual method on a generic
    ``ConstraintSet`` (``primal_dual_solve_msharded``);
  * tp: the row-sharded KKT factorization of one instance
    (``make_tp_kkt_solver``);
  * dp, the flagship route: the certified batch solve
    (``DistKL.solve_certified_batch``, kernel K2 on the card) split over
    the ranks, equal in bits to the local call.

    python -m cvx_tpu_torch.parallel.dryrun [N_RANKS] [DEVICE]

(defaults: 4 ranks on the card; ``cpu`` for CPU ranks).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .mesh import free_port, spawn_ranks


def _kl_problem_data(n, batch):
    nA, nB = 3, n // 2
    I_A = np.zeros(n)
    I_A[:nA] = 1.0
    I_B = np.zeros(n)
    I_B[nB:] = 1.0
    H = np.stack([-I_A, I_B])
    pA = np.linspace(0.5 * nA / n, 0.9 * nA / n, batch)
    U = np.stack([-pA, np.full(batch, 0.7)], axis=1)
    return H, U


def _close(name, a, b, tol, out):
    err = float((a - b).abs().max())
    out[name] = err
    if not err <= tol:
        raise AssertionError(f"{name}: sharded != local, max|d| {err:.3e} "
                             f"> {tol:g}")


def _dryrun_rank(rank: int, size: int, device: str) -> dict:
    from ..models import DistKL
    from ..problem.constraint_set import ConstraintSet
    from ..problem.constraints import LinearBlock
    from ..problem.objective import QuadraticObjective
    from ..solvers import SolverParams, barrier_solve, primal_dual_solve
    from . import (barrier_solve_msharded, block_mesh, instance_mesh,
                   make_tp_kkt_solver, primal_dual_solve_msharded,
                   shard_solve)
    from .schur import (SeparableProblem, make_sharded_schur_solver,
                        separable_barrier_solve)

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    errs: dict = {}
    rng = np.random.default_rng(0)

    # ---- dp: instance-batch sharded KL barrier solve ----
    n, batch = 16, 2 * size
    H, U = _kl_problem_data(n, batch)
    pars = SolverParams(max_iter=20, tol=1e-6, kkt_method="chol",
                        kkt_refine=1)
    mesh = instance_mesh(axis="dp", device=dev)
    prob = DistKL.create(n, H=H, u=np.zeros(2), device=dev)
    Ut = torch.tensor(U, **f64)
    X0 = torch.full((batch, n), 1.0 / n, **f64)

    def br(u, x0):
        return prob.solve_jittable_batch(u, x0, method="BR", pars=pars).x

    xs = shard_solve(br, mesh)(Ut, X0)
    assert xs.shape == (batch, n) and bool(torch.isfinite(xs).all())
    _close("dp BR", xs, br(Ut, X0), 1e-8, errs)

    # ---- blocks: Schur-consensus block-separable solve ----
    K, nb, mb, p = 2 * size, 8, 4, 3
    eye = np.eye(nb)
    sp = SeparableProblem(
        P=torch.tensor(np.tile((eye + 0.1)[None], (K, 1, 1)), **f64),
        a=torch.tensor(rng.standard_normal((K, nb)), **f64),
        G=torch.tensor(np.tile(np.concatenate([eye, -eye])[None],
                               (K, 1, 1))[:, :mb], **f64),
        u=torch.full((K, mb), 10.0, **f64),
        C=torch.tensor(rng.standard_normal((K, p, nb)) / np.sqrt(nb), **f64),
        c=torch.tensor(0.1 * rng.standard_normal(p), **f64))
    solver = make_sharded_schur_solver(block_mesh(axis="blocks", device=dev))
    x0 = torch.zeros((K, nb), **f64)
    xb = separable_barrier_solve(sp, x0, pars, kkt_solver=solver).x
    assert xb.shape == (K, nb) and bool(torch.isfinite(xb).all())
    _close("blocks Schur", xb, separable_barrier_solve(sp, x0, pars).x,
           1e-6, errs)

    # ---- m (constraint axis): sharded barrier Hessian reduction ----
    mm, nn = 8 * size, 12
    Gm = torch.tensor(rng.standard_normal((mm, nn)) / np.sqrt(nn), **f64)
    ubm = torch.ones(mm, **f64)
    z = torch.full((nn,), 0.5, **f64)
    objq = QuadraticObjective(P=torch.eye(nn, **f64), a=-z, r=0.5 * (z @ z))
    mmesh = instance_mesh(axis="m", device=dev)
    zero_m, zero_n = torch.zeros(mm, **f64), torch.zeros(nn, **f64)
    cnts = ConstraintSet(blocks=(LinearBlock(G=Gm, c=zero_m, ub=ubm),))
    solm = barrier_solve_msharded(objq, Gm, zero_m, ubm, zero_n, pars,
                                  mesh=mmesh)
    assert solm.x.shape == (nn,) and bool(torch.isfinite(solm.x).all())
    _close("m barrier", solm.x,
           barrier_solve(objq, cnts, zero_n[None], pars).x[0], 1e-6, errs)

    # ---- m (constraint axis), primal-dual on a generic ConstraintSet ----
    solpd = primal_dual_solve_msharded(objq, cnts, zero_n, pars, mesh=mmesh)
    assert solpd.x.shape == (nn,) and bool(torch.isfinite(solpd.x).all())
    _close("m primal-dual", solpd.x,
           primal_dual_solve(objq, cnts, zero_n[None], pars).x[0], 1e-6,
           errs)

    # ---- tp: row-sharded KKT factorization for one instance ----
    ntp, ptp, bs = 16 * size, 2, 8
    M = rng.standard_normal((ntp, ntp)) / np.sqrt(ntp)
    Htp = torch.tensor(M @ M.T + 2.0 * np.eye(ntp), **f64)
    Atp = torch.tensor(rng.standard_normal((ptp, ntp)) / np.sqrt(ntp), **f64)
    qtp, btp = torch.ones(ntp, **f64), torch.zeros(ptp, **f64)
    kkt = make_tp_kkt_solver(instance_mesh(axis="tp", device=dev), ntp, ptp,
                             block=bs)
    xtp, wtp = kkt(Htp, Atp, qtp, btp)
    assert xtp.shape == (ntp,) and wtp.shape == (ptp,)
    Kd = torch.cat([torch.cat([Htp, Atp.T], 1),
                    torch.cat([Atp, torch.zeros(ptp, ptp, **f64)], 1)])
    ref = torch.linalg.solve(Kd, torch.cat([-qtp, btp]))
    _close("tp KKT", torch.cat([xtp, wtp]), ref, 1e-9, errs)

    # ---- dp, the flagship route: sharded certified fused-dual solve ----
    f32 = dict(dtype=torch.float32, device=dev)
    cert_prob = DistKL.create(n, H=torch.tensor(H, **f32),
                              u=torch.zeros(2, **f32), device=dev)
    U32 = torch.tensor(U, **f32)

    def cert(u):
        s = cert_prob.solve_certified_batch(u, pars=pars)
        return s.x, s.duality_gap, s.ineq_res

    cx, cgap, _ = shard_solve(cert, mesh)(U32)
    assert cx.shape == (batch, n) and bool(torch.isfinite(cx).all())
    assert bool((cgap.abs() <= 1e-8).all()), "certified contract"
    _close("dp certified", cx, cert(U32)[0], 0.0, errs)
    return errs


def dryrun_multichip(n_ranks: int, device: str = "cuda", *,
                     backend: str | None = None,
                     timeout: float = 600.0) -> dict:
    """Spawn ``n_ranks`` ranks on ``device`` (rank r on card r mod the
    card count; ``"cpu"`` for CPU ranks) and run the six shardings on tiny
    shapes, each against its local run; returns rank 0's max |d| per
    sharding.  A failed check, a failed rank or a world that outlives
    ``timeout`` seconds raises.  ``backend`` defaults to NCCL on the cards
    and gloo on the CPU, and to gloo where ranks share a card (NCCL
    refuses two ranks on one GPU)."""
    if (backend is None and torch.device(device).type == "cuda"
            and n_ranks > torch.cuda.device_count()):
        backend = "gloo"
    return spawn_ranks(_dryrun_rank, n_ranks, device,
                       init_method=f"tcp://localhost:{free_port()}",
                       backend=backend, device=device, timeout=timeout)[0]


if __name__ == "__main__":
    nr = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dv = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    print(f"dryrun_multichip({nr}, {dv!r}):", dryrun_multichip(nr, dv))
