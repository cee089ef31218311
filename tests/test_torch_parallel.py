"""The parallel port's instance batches and Schur consensus on four gloo
ranks on the CPU, against ``cvx_tpu`` on the same numpy inputs.

Mirrors ``tests/test_parallel.py::TestBatchedSolve`` and ``::TestSchur``
and ``tests/test_round5.py::TestSeparableCertify``.  One spawned world of
four ranks (``tests/_torch_parallel_worker.py::parallel_world``) runs
every sharded case of this file once and writes an ``.npz``; the tests
hold it against the reference run here (vmapped, or on its local path)
and against the port's local runs.

Tolerances, the reference's own: the sharded "BR" batch within 1e-8 of
the local one and of the reference; the Schur KKT solve and the
certificate within 1e-10; the sharded separable barrier within 1e-6 of
the local one (the reference's bound; measured 0); the certified K2
route's shards equal in bits to the local call (each instance is its own
lane).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from cvx_tpu import parallel as rpar
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.parallel import schur as rschur
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import DistKL, SolverParams
from cvx_tpu_torch.parallel import schur, shard_batch, vmap_solve
from cvx_tpu_torch.parallel.mesh import Mesh, spawn_ranks

# the test processes share the CPU's cores (see test_torch_qp.py)
torch.set_num_threads(1)

WORLD_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_world")
    out = str(d / "out.npz")
    spawn_ranks(W.parallel_world, 4, out, init_method=f"file://{d}/rdv",
                device="cpu", timeout=WORLD_TIMEOUT)
    return dict(np.load(out))


def _ref_sep(data):
    return rschur.SeparableProblem(*(jnp.asarray(v) for v in data))


def _sep(data, dtype=torch.float64):
    return schur.SeparableProblem(*(torch.tensor(v, dtype=dtype)
                                    for v in data))


def _ref_br(H, U, X0, pars=None):
    def one(u, x0):
        return RefDistKL.create(H.shape[1], H=jnp.asarray(H), u=u
                                ).solve_jittable(x0, method="BR",
                                                 pars=pars).x

    return np.asarray(jax.vmap(one)(jnp.asarray(U), jnp.asarray(X0)))


class TestBatchedSolve:
    """test_parallel.py::TestBatchedSolve."""

    def test_vmap_solve_kl(self):
        H, U, X0 = W.kl_batch_data()
        prob = DistKL.create(16, H=H, u=np.zeros(2), device="cpu")
        fn = vmap_solve(lambda u, x: prob.solve_jittable_batch(
            u, x, method="BR").x)
        xs = fn(torch.tensor(U), torch.tensor(X0))
        assert xs.shape == (8, 16)
        assert float((xs.sum(1) - 1.0).abs().max()) < 1e-6
        assert np.max(np.abs(xs.numpy() - _ref_br(H, U, X0))) < 1e-8

    def test_shard_batch_takes_the_rank_rows(self):
        """``shard_batch`` (mesh.py's counterpart of placing a batch with
        its leading axis sharded): rank 1 of 4 holds rows 2-3 of every
        leaf; a batch that does not divide raises."""
        mesh = Mesh(group=None, axis="dp", size=4, rank=1,
                    device=torch.device("cpu"))
        tree = {"u": torch.arange(16.0).reshape(8, 2),
                "x": (torch.arange(8), None)}
        got = shard_batch(tree, mesh)
        assert torch.equal(got["u"], tree["u"][2:4])
        assert torch.equal(got["x"][0], torch.tensor([2, 3]))
        assert got["x"][1] is None
        with pytest.raises(ValueError, match="divisible"):
            shard_batch(torch.zeros(6, 2), mesh)

    def test_mesh_without_a_group_raises(self):
        """A mesh of several ranks with no process group raises at its
        first collective instead of keeping this rank's share (a sharded
        solver would sum a quarter of its rows); one rank keeps its
        values."""
        t = torch.arange(4.0)
        wide = Mesh(group=None, axis="m", size=4, rank=0,
                    device=torch.device("cpu"))
        for call in (wide.sum, wide.max, wide.min, wide.all, wide.gather,
                     lambda v: wide.broadcast(v, 0),
                     lambda v: wide.agree(True)):
            with pytest.raises(RuntimeError, match="no process group"):
                call(t)
        one = Mesh(group=None, axis="m", size=1, rank=0,
                   device=torch.device("cpu"))
        assert torch.equal(one.sum(t), t) and torch.equal(one.gather(t), t)
        assert torch.equal(one.broadcast(t, 0), t) and one.agree(True)

    def test_axis_must_name_the_mesh(self):
        """A function's ``axis`` names the mesh axis it shards over (the
        reference's defaults: "dp", "blocks", "m", "tp"); a mesh of another
        axis raises, as ``shard_map`` does for an unknown axis name."""
        from cvx_tpu_torch.parallel import (barrier_solve_msharded,
                                            make_sharded_cholesky,
                                            make_sharded_schur_solver,
                                            shard_solve)

        dp = Mesh(group=None, axis="dp", size=1, rank=0,
                  device=torch.device("cpu"))
        shard_solve(lambda u: u, dp)
        shard_batch(torch.zeros(2), dp)
        with pytest.raises(ValueError, match="this mesh's axis is 'dp'"):
            make_sharded_schur_solver(dp)
        with pytest.raises(ValueError, match="this mesh's axis is 'dp'"):
            make_sharded_cholesky(dp, 128, block=128)
        with pytest.raises(ValueError, match="axis 'm'"):
            barrier_solve_msharded(None, torch.zeros(2, 2), torch.zeros(2),
                                   torch.ones(2), torch.zeros(2), mesh=dp)
        with pytest.raises(ValueError, match="axis 'blocks'"):
            shard_solve(lambda u: u, dp, axis="blocks")

    def test_spawn_ranks_defaults_to_the_card(self):
        """``spawn_ranks`` puts its ranks on the card unless the caller
        passes ``device="cpu"``; with no card that default raises before a
        rank starts."""
        import inspect

        assert inspect.signature(spawn_ranks).parameters[
            "device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                spawn_ranks(W.fail_world, 2, init_method="file:///unused")

    def test_shard_solve_matches_vmap(self, world):
        H, U, X0 = W.kl_batch_data()
        prob = DistKL.create(16, H=H, u=np.zeros(2), device="cpu")
        local = prob.solve_jittable_batch(torch.tensor(U), torch.tensor(X0),
                                          method="BR").x.numpy()
        assert np.max(np.abs(world["br_x"] - local)) <= 1e-8
        assert np.max(np.abs(world["br_x"] - _ref_br(H, U, X0))) <= 1e-8

    def test_sharded_feasibility_screen_matches_local(self, world):
        H, U, bad = W.screen_data()
        assert np.array_equal(world["scr_infeasible"], bad)
        ref = RefDistKL.create(16, H=jnp.asarray(H), u=jnp.zeros(2)
                               ).feasibility_screen_batch(jnp.asarray(U))
        assert np.array_equal(np.asarray(ref.infeasible), bad)
        for name in ("x", "w", "s_lower", "s_upper"):
            got, loc = world["scr_" + name], world["scr_local_" + name]
            assert np.max(np.abs(got - loc)) <= 1e-12, name

    def test_sharded_certified_route_equal_bits(self, world):
        """The flagship dp route (``__graft_entry__.py:173-214``): K2's
        plain version on each shard, the same bits as the local call."""
        for name in ("x", "lam", "nu", "duality_gap", "ineq_res", "eq_gap"):
            assert np.array_equal(world["k2_" + name],
                                  world["k2_local_" + name]), name
        assert np.max(np.abs(world["k2_duality_gap"])) <= 1e-8
        assert np.max(world["k2_ineq_res"]) <= 1e-7


class TestSchur:
    """test_parallel.py::TestSchur."""

    def test_schur_kkt_matches_dense(self):
        import scipy.linalg as sla

        data, q, rhs = W.schur_data()
        P, C = data[0], data[4]
        K, nb, p = P.shape[0], P.shape[1], C.shape[1]
        H = P + np.eye(nb)[None]
        dx, w = schur.schur_kkt_solve(*(torch.tensor(v) for v in
                                        (H, C, q, rhs)))
        Hd = sla.block_diag(*H)
        Cd = np.concatenate(C, axis=1)
        KKT = np.block([[Hd, Cd.T], [Cd, np.zeros((p, p))]])
        sol = np.linalg.solve(KKT, np.concatenate([-q.ravel(), rhs]))
        assert np.max(np.abs(dx.numpy().ravel() - sol[:K * nb])) < 1e-8
        assert np.max(np.abs(w.numpy() - sol[K * nb:])) < 1e-8
        rdx, rw = rschur.schur_kkt_solve(*(jnp.asarray(v) for v in
                                           (H, C, q, rhs)))
        assert np.max(np.abs(dx.numpy() - np.asarray(rdx))) < 1e-10
        assert np.max(np.abs(w.numpy() - np.asarray(rw))) < 1e-10

    def test_separable_barrier_solve(self):
        data, _, _ = W.schur_data()
        sol = schur.separable_barrier_solve(_sep(data),
                                            torch.zeros(8, 6,
                                                        dtype=torch.float64))
        coupling = np.einsum("kpn,kn->p", data[4], sol.x.numpy()) - data[5]
        assert np.linalg.norm(coupling) < 1e-4
        assert float(sol.duality_gap) < 1e-7
        assert sol.stalled.shape == (8,) and not bool(sol.stalled.any())
        assert sol.lam.shape == data[3].shape and bool((sol.lam > 0).all())
        ref = rschur.separable_barrier_solve(_ref_sep(data),
                                             jnp.zeros((8, 6)))
        assert np.max(np.abs(sol.x.numpy() - np.asarray(ref.x))) < 1e-6
        assert np.array_equal(sol.stalled.numpy(), np.asarray(ref.stalled))

    def test_sharded_schur_matches_local(self, world):
        data, q, rhs = W.schur_data()
        H = data[0] + np.eye(6)[None]
        dx, w = schur.schur_kkt_solve(*(torch.tensor(v) for v in
                                        (H, data[4], q, rhs)))
        assert np.max(np.abs(world["schur_dx"] - dx.numpy())) <= 1e-10
        assert np.max(np.abs(world["schur_w"] - w.numpy())) <= 1e-10
        rdx, rw = rschur.schur_kkt_solve(*(jnp.asarray(v) for v in
                                           (H, data[4], q, rhs)))
        assert np.max(np.abs(world["schur_dx"] - np.asarray(rdx))) <= 1e-10
        assert np.max(np.abs(world["schur_w"] - np.asarray(rw))) <= 1e-10

    def test_sharded_separable_solve(self, world):
        data, _, _ = W.schur_data()
        x_local = schur.separable_barrier_solve(
            _sep(data), torch.zeros(8, 6, dtype=torch.float64)).x
        assert np.max(np.abs(world["sep_x"] - x_local.numpy())) <= 1e-6
        # and the reference's sharded solve on the 8-device CPU mesh
        solver = rschur.make_sharded_schur_solver(rpar.block_mesh(8))
        ref = rschur.separable_barrier_solve(_ref_sep(data),
                                             jnp.zeros((8, 6)),
                                             kkt_solver=solver)
        assert np.max(np.abs(world["sep_x"] - np.asarray(ref.x))) <= 1e-6


class TestSeparableCertify:
    """test_round5.py::TestSeparableCertify."""

    PARS = dict(tol=1e-7, mu=20.0, max_iter=12)

    def _local(self, ub=10.0):
        sp = _sep(W.certify_data(ub=ub), torch.float32)
        sol = schur.separable_barrier_solve(
            sp, torch.zeros(8, 12, dtype=torch.float32),
            SolverParams(**self.PARS))
        return sp, sol, schur.separable_certify(sp, sol.x, sol.lam, sol.nu)

    def _ref(self, ub=10.0):
        rp = _ref_sep(W.certify_data(ub=ub))
        sol = rschur.separable_barrier_solve(rp, jnp.zeros((8, 12),
                                                           jnp.float32),
                                             RefParams(**self.PARS))
        return rschur.separable_certify(rp, sol.x, sol.lam, sol.nu)

    def test_certifies_barrier_exit_to_1e8(self):
        sp, _, cert = self._local()
        assert abs(float(cert.gap)) <= 1e-8
        assert float(cert.ineq_res) <= 1e-10
        assert float(cert.eq_res) <= 1e-9
        # a true bound: an independent host-f64 dual value at the SAME
        # (lam, w)
        P, a, G, u, C, c = (v.astype(np.float64) for v in W.certify_data())
        lam, w, x = cert.lam.numpy(), cert.nu.numpy(), cert.x.numpy()
        assert np.min(lam) >= 0.0
        g, f = -w @ c, 0.0
        for k in range(8):
            wv = a[k] + G[k].T @ lam[k] + C[k].T @ w
            g += -0.5 * wv @ np.linalg.solve(P[k], wv) - lam[k] @ u[k]
            f += a[k] @ x[k] + 0.5 * x[k] @ (P[k] @ x[k])
        assert abs((f - g) - float(cert.gap)) < 1e-10
        ref = self._ref()
        assert np.max(np.abs(cert.x.numpy() - np.asarray(ref.x))) < 1e-10
        assert abs(float(cert.gap) - float(ref.gap)) < 1e-10

    def test_sharded_certify_matches_local(self, world):
        _, _, c_loc = self._local()
        assert abs(float(world["cert_gap"])) <= 1e-8
        assert float(world["cert_eq_res"]) <= 1e-9
        assert abs(float(world["cert_gap"]) - float(c_loc.gap)) < 1e-10
        assert np.max(np.abs(world["cert_x"] - c_loc.x.numpy())) < 1e-10
        ref = self._ref()
        assert np.max(np.abs(world["cert_x"] - np.asarray(ref.x))) < 1e-10

    def test_certify_with_active_constraints(self, world):
        _, _, cert = self._local(ub=0.15)
        for gap, ineq, eq, lam in ((cert.gap, cert.ineq_res, cert.eq_res,
                                    cert.lam),
                                   (world["act_cert_gap"],
                                    world["act_cert_ineq_res"],
                                    world["act_cert_eq_res"],
                                    world["act_cert_lam"])):
            assert abs(float(gap)) <= 1e-8
            assert float(ineq) <= 1e-10
            assert float(eq) <= 1e-9
            assert float(np.max(np.asarray(lam))) > 0.0   # really active
        assert np.max(np.abs(world["act_cert_x"] - cert.x.numpy())) < 1e-10
        ref = self._ref(ub=0.15)
        assert np.max(np.abs(cert.x.numpy() - np.asarray(ref.x))) < 1e-10


def test_parallel_imports_no_jax():
    """``cvx_tpu_torch.parallel`` (and the worker module of these tests)
    import neither JAX nor ``cvx_tpu``."""
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import cvx_tpu_torch.parallel, cvx_tpu_torch.parallel.dryrun, "
            "_torch_parallel_worker; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cvx_tpu.')) or m == 'cvx_tpu']; "
            "assert not bad, bad")
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
