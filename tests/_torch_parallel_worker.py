"""Ranks of the parallel port's CPU tests (``tests/test_torch_parallel.py``,
``test_torch_constraint_shard.py``, ``test_torch_tp_chol.py``,
``test_torch_multihost.py``).

Each ``*_world(rank, size, out)`` runs on one of the gloo ranks that
``cvx_tpu_torch.parallel.mesh.spawn_ranks`` starts, computes every sharded
case of its test file on the CPU, and rank 0 writes the results to the
``.npz`` at ``out``; the test process holds them against ``cvx_tpu`` (and
the port's local runs) on the same numpy inputs, which the ``*_data``
functions here make from fixed seeds.  This module imports no JAX.
"""

from __future__ import annotations

import time

import numpy as np
import torch

F64 = dict(dtype=torch.float64, device="cpu")


def _t(v, dtype=torch.float64):
    return torch.tensor(np.asarray(v), dtype=dtype)


def _save(rank, out, **arrays):
    if rank == 0:
        np.savez(out, **{k: (v.detach().cpu().numpy()
                             if isinstance(v, torch.Tensor) else np.asarray(v))
                         for k, v in arrays.items()})


# --------------------------------------------------------------- the data


def kl_batch_data(n=16, B=8):
    """test_parallel.py::_kl_batch: P(A) >= pA (|A| = 3) and P(B) <= 0.2
    (B the upper half), pA from 0.08 to 0.14; x0 uniform."""
    I_A = np.zeros(n)
    I_A[:3] = 1.0
    I_B = np.zeros(n)
    I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B])
    U = np.stack([-np.linspace(0.08, 0.14, B), np.full(B, 0.2)], axis=1)
    return H, U, np.full((B, n), 1.0 / n)


def screen_data(n=16, B=32):
    """test_parallel.py::test_sharded_feasibility_screen_matches_local:
    every 4th instance infeasible (P(A) <= qA < pA)."""
    rng = np.random.default_rng(0)
    I_A = np.zeros(n)
    I_A[:3] = 1.0
    H = np.stack([-I_A, I_A])
    pA = rng.uniform(0.3, 0.5, B)
    qA = pA + rng.uniform(0.05, 0.2, B)
    bad = np.zeros(B, bool)
    bad[::4] = True
    qA[bad] = pA[bad] - rng.uniform(0.05, 0.1, bad.sum())
    return H, np.stack([-pA, qA], axis=1), bad


def cert_data(n=16, B=8, seed=0):
    """bench.py's family in f32: P(A) >= pA (|A| = 3), P(B) <= pB."""
    rng = np.random.default_rng(seed)
    I_A = np.zeros(n)
    I_A[:3] = 1.0
    I_B = np.zeros(n)
    I_B[n // 2:] = 1.0
    U = np.column_stack([-rng.uniform(0.2, 0.5, B),
                         rng.uniform(0.55, 0.8, B)])
    return (np.stack([-I_A, I_B]).astype(np.float32),
            U.astype(np.float32))


def schur_data(K=8, nb=6, mb=4, p=3, seed=1):
    """test_parallel.py::TestSchur._random_problem from a numpy seed: SPD
    blocks of condition ~100, box rows |x| <= 10 (0 strictly feasible),
    coupling rows C / sqrt(nb), c ~ 0.1; plus q and rhs for the KKT
    solve."""
    rng = np.random.default_rng(seed)
    P = np.empty((K, nb, nb))
    for k in range(K):
        Q, _ = np.linalg.qr(rng.standard_normal((nb, nb)))
        P[k] = (Q * np.logspace(0, 2, nb)) @ Q.T
    a = rng.standard_normal((K, nb))
    eye = np.eye(nb)
    G = np.tile(np.concatenate([eye, -eye])[None], (K, 1, 1))[:, :mb]
    u = np.full((K, mb), 10.0)
    C = rng.standard_normal((K, p, nb)) / np.sqrt(nb)
    c = 0.1 * rng.standard_normal(p)
    q = rng.standard_normal((K, nb))
    rhs = 0.1 * rng.standard_normal(p)
    return (P, a, G, u, C, c), q, rhs


def certify_data(K=8, nb=12, mb=6, p=3, seed=5, ub=10.0):
    """test_round5.py::TestSeparableCertify._problem from a numpy seed
    (f32): P = M M' + I, a and C normal, the box |x| <= ub."""
    rng = np.random.default_rng(seed)
    eye = np.eye(nb)
    M = rng.standard_normal((K, nb, nb)) / np.sqrt(nb)
    P = np.einsum("kij,klj->kil", M, M) + eye[None]
    a = rng.standard_normal((K, nb))
    G = np.tile(np.concatenate([eye, -eye])[None], (K, 1, 1))[:, :mb]
    u = np.full((K, mb), ub)
    C = rng.standard_normal((K, p, nb)) / np.sqrt(nb)
    c = 0.1 * rng.standard_normal(p)
    return tuple(v.astype(np.float32) for v in (P, a, G, u, C, c))


def msharded_data(m, n, seed=0):
    """test_constraint_shard.py::_problem from a numpy seed: min 0.5 ||x -
    z||^2 s.t. G x <= ub, x0 = 0 strictly feasible, z pulled outside."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((m, n)) / np.sqrt(n)
    ub = rng.uniform(0.5, 1.5, m)
    z = 2.0 * rng.standard_normal(n) / np.sqrt(n) + 0.4
    return G, ub, z


def quad_data(m=128, n=16, seed=3):
    """test_constraint_shard.py::test_quad_block_barrier_sharded: m balls
    ||x - c_i||^2 / 2 <= ub_i, all containing 0."""
    rng = np.random.default_rng(seed)
    cen = rng.standard_normal((m, n)) / np.sqrt(n)
    ub = 0.5 * (cen * cen).sum(1) + rng.uniform(0.05, 0.3, m)
    z = 2.0 * rng.standard_normal(n) / np.sqrt(n)
    return cen, ub, z


def spd_data(n, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n)) / np.sqrt(n)
    return M @ M.T + 2.0 * np.eye(n)


def multihost_data():
    """test_multihost.py's two cases: the dp "BR" batch (n = 16, 8
    instances) and the Schur KKT solve (K = 8, nb = 6, p = 2)."""
    n, batch, nA = 16, 8, 3
    I_A = np.zeros(n)
    I_A[:nA] = 1.0
    I_B = np.zeros(n)
    I_B[n // 2:] = 1.0
    H = np.stack([-I_A, I_B])
    U = np.stack([-np.linspace(0.5 * nA / n, 0.9 * nA / n, batch),
                  np.full(batch, 0.7)], axis=1)
    rng = np.random.default_rng(0)
    K, nb, p = 8, 6, 2
    M = rng.standard_normal((K, nb, nb)) / np.sqrt(nb)
    Hb = np.einsum("kij,klj->kil", M, M) + 2.0 * np.eye(nb)[None]
    C = rng.standard_normal((K, p, nb)) / np.sqrt(nb)
    q = rng.standard_normal((K, nb))
    return H, U, (Hb, C, q)


# ---------------------------------------------------------------- the worlds


def parallel_world(rank, size, out):
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.parallel import (block_mesh, instance_mesh,
                                        make_sharded_schur_solver,
                                        separable_barrier_solve, shard_solve)
    from cvx_tpu_torch.parallel.schur import (SeparableProblem,
                                              make_sharded_separable_certify)

    mesh = instance_mesh(device="cpu")
    res = {}
    # dp: the "BR" batch
    H, U, X0 = kl_batch_data()
    prob = DistKL.create(16, H=H, u=np.zeros(2), device="cpu")

    def br(u, x0):
        return prob.solve_jittable_batch(u, x0, method="BR").x

    res["br_x"] = shard_solve(br, mesh)(_t(U), _t(X0))
    # dp: the fleet screen
    Hs, Us, _ = screen_data()
    sprob = DistKL.create(16, H=Hs, u=np.zeros(2), device="cpu")
    scr = shard_solve(sprob.feasibility_screen_batch, mesh)(_t(Us))
    scr_lo = sprob.feasibility_screen_batch(_t(Us))
    for name in ("infeasible", "x", "w", "s_lower", "s_upper"):
        res["scr_" + name] = getattr(scr, name)
        res["scr_local_" + name] = getattr(scr_lo, name)
    # dp: the certified route (K2's plain version on the CPU)
    Hc, Uc = cert_data()
    cprob = DistKL.create(16, H=_t(Hc, torch.float32),
                          u=torch.zeros(2, dtype=torch.float32),
                          device="cpu")
    cs = shard_solve(cprob.solve_certified_batch, mesh)(
        _t(Uc, torch.float32))
    cl = cprob.solve_certified_batch(_t(Uc, torch.float32))
    for name in ("x", "lam", "nu", "duality_gap", "ineq_res", "eq_gap"):
        res["k2_" + name] = getattr(cs, name)
        res["k2_local_" + name] = getattr(cl, name)
    # blocks: the sharded Schur KKT solve and barrier
    bmesh = block_mesh(device="cpu")
    solver = make_sharded_schur_solver(bmesh)
    data, q, rhs = schur_data()
    sp = SeparableProblem(*(_t(v) for v in data))
    H_ = sp.P + torch.eye(sp.nb, **F64)[None]
    res["schur_dx"], res["schur_w"] = solver(H_, sp.C, _t(q), _t(rhs))
    res["sep_x"] = separable_barrier_solve(
        sp, torch.zeros(sp.K, sp.nb, **F64), kkt_solver=solver).x
    # blocks: the sharded certificate, inactive and active boxes
    certify = make_sharded_separable_certify(bmesh)
    pars = SolverParams(tol=1e-7, mu=20.0, max_iter=12)
    for tag, ub in (("", 10.0), ("act_", 0.15)):
        sp32 = SeparableProblem(*(_t(v, torch.float32)
                                  for v in certify_data(ub=ub)))
        sol = separable_barrier_solve(
            sp32, torch.zeros(sp32.K, sp32.nb, dtype=torch.float32), pars,
            kkt_solver=solver)
        cert = certify(sp32, sol.x, sol.lam, sol.nu)
        res[tag + "bar_x"] = sol.x
        for name in ("x", "gap", "ineq_res", "eq_res", "lam", "nu"):
            res[tag + "cert_" + name] = getattr(cert, name)
    _save(rank, out, **res)


def constraint_shard_world(rank, size, out):
    from cvx_tpu_torch.parallel import (barrier_solve_msharded,
                                        barrier_solve_msharded_cnts,
                                        instance_mesh,
                                        primal_dual_solve_msharded)
    from cvx_tpu_torch.problem.constraint_set import ConstraintSet
    from cvx_tpu_torch.problem.constraints import LinearBlock, QuadBlock
    from cvx_tpu_torch.problem.equality import EqualityConstraint
    from cvx_tpu_torch.problem.objective import QuadraticObjective
    from cvx_tpu_torch.solvers import SolverParams

    mesh = instance_mesh(axis="m", device="cpu")
    res = {}

    def objective(z):
        z = _t(z)
        return QuadraticObjective(P=torch.eye(z.shape[0], **F64), a=-z,
                                  r=0.5 * (z @ z))

    for tag, (m, n) in (("", (512, 32)), ("eq_", (256, 32))):
        G, ub, z = msharded_data(m, n)
        eqs = dict(A=torch.full((1, n), 1.0 / n, **F64),
                   b=torch.zeros(1, **F64)) if tag else {}
        c0 = torch.zeros(m, **F64)
        sol = barrier_solve_msharded(
            objective(z), _t(G), c0, _t(ub), torch.zeros(n, **F64),
            SolverParams(tol=1e-9, mu=20.0), mesh=mesh, **eqs)
        cnts = ConstraintSet(blocks=(LinearBlock(G=_t(G), c=c0, ub=_t(ub)),))
        pd = primal_dual_solve_msharded(
            objective(z), cnts, torch.zeros(n, **F64),
            SolverParams(tol=1e-8), mesh=mesh,
            eqs=EqualityConstraint(**eqs) if tag else None)
        for name in ("x", "lam", "duality_gap", "eq_gap", "stalled",
                     "iters"):
            res[f"{tag}br_{name}"] = getattr(sol, name)
            res[f"{tag}pd_{name}"] = getattr(pd, name)
    cen, ubq, zq = quad_data()
    mq, nq = cen.shape
    quad = QuadBlock(P=torch.eye(nq, **F64).expand(mq, nq, nq).clone(),
                     a=-_t(cen), r=0.5 * (_t(cen) ** 2).sum(1), ub=_t(ubq))
    sol = barrier_solve_msharded_cnts(
        objective(zq), ConstraintSet(blocks=(quad,)), torch.zeros(nq, **F64),
        SolverParams(tol=1e-9, mu=20.0), mesh=mesh)
    res["quad_x"], res["quad_stalled"] = sol.x, sol.stalled
    res["quad_iters"] = sol.iters
    _save(rank, out, **res)


def tp_chol_world(rank, size, out):
    from cvx_tpu_torch.parallel import (instance_mesh,
                                        make_sharded_chol_solve,
                                        make_sharded_cholesky,
                                        make_tp_kkt_solver)

    mesh = instance_mesh(axis="tp", device="cpu")
    n, bs = 256, 32
    H = _t(spd_data(n, seed=0))
    L = make_sharded_cholesky(mesh, n, block=bs)(H)
    B = _t(np.random.default_rng(1).standard_normal((n, 3)))
    X = make_sharded_chol_solve(mesh, n, block=bs)(L, B)
    rng = np.random.default_rng(2)
    Hk = _t(spd_data(n, seed=3))
    A = _t(rng.standard_normal((4, n)) / np.sqrt(n))
    x_true, w_true = _t(rng.standard_normal(n)), _t(rng.standard_normal(4))
    x, w = make_tp_kkt_solver(mesh, n, 4, block=bs)(
        Hk, A, -(Hk @ x_true + A.T @ w_true), A @ x_true)
    _save(rank, out, L=L, X=X, kkt_x=x, kkt_w=w, x_true=x_true,
          w_true=w_true)


def multihost_world(rank, size, out):
    from cvx_tpu_torch import DistKL, SolverParams
    from cvx_tpu_torch.parallel import (block_mesh, instance_mesh,
                                        make_sharded_schur_solver,
                                        shard_solve)

    H, U, (Hb, C, q) = multihost_data()
    pars = SolverParams(max_iter=20, tol=1e-6, kkt_method="chol",
                        kkt_refine=1)
    prob = DistKL.create(16, H=H, u=np.zeros(2), device="cpu")

    def br(u, x0):
        return prob.solve_jittable_batch(u, x0, method="BR", pars=pars).x

    X0 = torch.full((U.shape[0], 16), 1.0 / 16, **F64)
    xs = shard_solve(br, instance_mesh(device="cpu"))(_t(U), X0)
    solver = make_sharded_schur_solver(block_mesh(device="cpu"))
    dx, w = solver(_t(Hb), _t(C), _t(q), torch.zeros(C.shape[1], **F64))
    _save(rank, out, xs=xs, dx=dx, w=w, xs_local=br(_t(U), X0))


def hang_world(rank, size):
    """Rank 0 waits in an all-reduce that rank 1 never joins."""
    import torch.distributed as dist

    if rank == 1:
        time.sleep(600)
    dist.all_reduce(torch.ones(1))


def fail_world(rank, size):
    """Rank 1 fails while rank 0 waits in an all-reduce."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
