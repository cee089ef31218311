"""The parallel port's constraint-axis (m) sharded barrier and primal-dual
methods on four gloo ranks on the CPU, against ``cvx_tpu``'s local
solvers on the same numpy inputs.

Mirrors ``tests/test_constraint_shard.py``.  One spawned world of four
ranks (``tests/_torch_parallel_worker.py::constraint_shard_world``) runs
every sharded case once and writes an ``.npz``.  Sizes are cut to m =
512 / n = 32 (256 / 32 with an equality row, 128 quadratic rows in n =
16).  Tolerance, the reference's own: max |dx| < 1e-6 against the local
solvers (``cvx_tpu``'s and the port's).  Newton step counts are held
against ``cvx_tpu``'s own m-sharded solvers on a 4-device mesh (the same
row split) within ``ITERS_SLACK``: the barrier's last stage (t ~ 1e13)
ends by a failed line search, a rounding decision, and the reference's
own count moves 2.2x with its device count alone (248 / 112 / 110 steps
on 1 / 4 / 8 devices at m = 512, n = 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from cvx_tpu import parallel as rpar
from cvx_tpu.problem.constraint_set import ConstraintSet as RefCS
from cvx_tpu.problem.constraints import LinearBlock as RefLinear
from cvx_tpu.problem.constraints import QuadBlock as RefQuad
from cvx_tpu.problem.equality import EqualityConstraint as RefEq
from cvx_tpu.problem.objective import QuadraticObjective as RefQuadObj
from cvx_tpu.solvers.barrier import barrier_solve as ref_barrier
from cvx_tpu.solvers.primal_dual import primal_dual_solve as ref_pd
from cvx_tpu.solvers.types import SolverParams as RefParams
from cvx_tpu_torch.parallel import primal_dual_solve_msharded
from cvx_tpu_torch.parallel.mesh import Mesh, spawn_ranks
from cvx_tpu_torch.problem.constraint_set import ConstraintSet
from cvx_tpu_torch.problem.constraints import LinearBlock, NonlinearBlock
from cvx_tpu_torch.problem.objective import QuadraticObjective
from cvx_tpu_torch.problem.sets import positive_orthant

torch.set_num_threads(1)

DX = 1e-6
ITERS_SLACK = 0.25


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("constraint_shard_world")
    out = str(d / "out.npz")
    spawn_ranks(W.constraint_shard_world, 4, out,
                init_method=f"file://{d}/rdv", device="cpu", timeout=240.0)
    return dict(np.load(out))


def _ref(m, n, eq, method):
    G, ub, z = W.msharded_data(m, n)
    obj = RefQuadObj(P=jnp.eye(n), a=jnp.asarray(-z),
                     r=jnp.asarray(0.5 * z @ z))
    cnts = RefCS(blocks=(RefLinear(G=jnp.asarray(G), c=jnp.zeros(m),
                                   ub=jnp.asarray(ub)),))
    eqs = RefEq(A=jnp.full((1, n), 1.0 / n), b=jnp.zeros(1)) if eq else None
    if method == "br":
        return ref_barrier(obj, cnts, jnp.zeros(n),
                           RefParams(tol=1e-9, mu=20.0), eqs=eqs)
    return ref_pd(obj, cnts, jnp.zeros(n), RefParams(tol=1e-8), eqs=eqs)


def _ref_sharded(case):
    """``cvx_tpu``'s m-sharded solve of a world case on a 4-device mesh
    (the ranks' row split)."""
    mesh = rpar.instance_mesh(4, axis="m")
    P = RefParams(tol=1e-9, mu=20.0)
    if case == "quad":
        cen, ub, zq = W.quad_data()
        mq, nq = cen.shape
        quad = RefQuad(P=jnp.tile(jnp.eye(nq)[None], (mq, 1, 1)),
                       a=jnp.asarray(-cen),
                       r=jnp.asarray(0.5 * (cen * cen).sum(1)),
                       ub=jnp.asarray(ub))
        obj = RefQuadObj(P=jnp.eye(nq), a=jnp.asarray(-zq),
                         r=jnp.asarray(0.5 * zq @ zq))
        return rpar.barrier_solve_msharded_cnts(
            obj, RefCS(blocks=(quad,)), jnp.zeros(nq), P, mesh=mesh)
    m, n = (256, 32) if case.startswith("eq_") else (512, 32)
    G, ub, z = W.msharded_data(m, n)
    obj = RefQuadObj(P=jnp.eye(n), a=jnp.asarray(-z),
                     r=jnp.asarray(0.5 * z @ z))
    eq = dict(A=jnp.full((1, n), 1.0 / n), b=jnp.zeros(1))
    kw = eq if case.startswith("eq_") else {}
    if case.endswith("br"):
        return rpar.barrier_solve_msharded(
            obj, jnp.asarray(G), jnp.zeros(m), jnp.asarray(ub), jnp.zeros(n),
            P, mesh=mesh, **kw)
    cnts = RefCS(blocks=(RefLinear(G=jnp.asarray(G), c=jnp.zeros(m),
                                   ub=jnp.asarray(ub)),))
    return rpar.primal_dual_solve_msharded(
        obj, cnts, jnp.zeros(n), RefParams(tol=1e-8),
        eqs=RefEq(**kw) if kw else None, mesh=mesh)


class TestMSharded:
    """test_constraint_shard.py::TestMSharded."""

    @pytest.mark.parametrize("case", ["br", "eq_br", "pd", "eq_pd", "quad"])
    def test_iters_against_the_sharded_reference(self, world, case):
        """Newton steps within ``ITERS_SLACK`` of the reference's on the
        same 4-way split (measured: 98 / 112, 69 / 69, 17 / 17, 13 / 13,
        96 / 96), and the barrier's schedule gap m / t in the iterate's
        dtype, equal to the reference's."""
        ref = _ref_sharded(case)
        got, want = int(world[case + "_iters"]), int(ref.iters)
        assert abs(got - want) <= ITERS_SLACK * want, (got, want)
        if case in ("br", "eq_br"):
            assert world[case + "_duality_gap"].dtype == np.float64
            assert float(world[case + "_duality_gap"]) == float(
                ref.duality_gap)

    def test_sharded_equals_local(self, world):
        ref = _ref(512, 32, False, "br")
        assert not bool(world["br_stalled"])
        assert float(world["br_duality_gap"]) < 1e-8   # m/t schedule bound
        assert np.max(np.abs(world["br_x"] - np.asarray(ref.x))) < DX
        assert world["br_lam"].shape == (512,)
        assert np.all(np.isfinite(world["br_lam"]))

    def test_sharded_with_equalities(self, world):
        ref = _ref(256, 32, True, "br")
        assert float(world["eq_br_eq_gap"]) < 1e-8
        assert np.max(np.abs(world["eq_br_x"] - np.asarray(ref.x))) < DX

    def test_pd_sharded_equals_local(self, world):
        ref = _ref(512, 32, False, "pd")
        assert not bool(world["pd_stalled"])
        assert float(world["pd_duality_gap"]) < 1e-7
        assert np.max(np.abs(world["pd_x"] - np.asarray(ref.x))) < DX
        assert world["pd_lam"].shape == (512,)
        assert np.max(np.abs(world["pd_lam"] - np.asarray(ref.lam))) < DX

    def test_pd_sharded_with_equalities(self, world):
        ref = _ref(256, 32, True, "pd")
        assert float(world["eq_pd_eq_gap"]) < 1e-7
        assert np.max(np.abs(world["eq_pd_x"] - np.asarray(ref.x))) < DX

    def test_quad_block_barrier_sharded(self, world):
        cen, ub, z = W.quad_data()
        m, n = cen.shape
        quad = RefQuad(P=jnp.tile(jnp.eye(n)[None], (m, 1, 1)),
                       a=jnp.asarray(-cen),
                       r=jnp.asarray(0.5 * (cen * cen).sum(1)),
                       ub=jnp.asarray(ub))
        obj = RefQuadObj(P=jnp.eye(n), a=jnp.asarray(-z),
                         r=jnp.asarray(0.5 * z @ z))
        cnts = RefCS(blocks=(quad,))
        ref = ref_barrier(obj, cnts, jnp.zeros(n),
                          RefParams(tol=1e-9, mu=20.0))
        assert not bool(world["quad_stalled"])
        assert np.max(np.abs(world["quad_x"] - np.asarray(ref.x))) < DX
        assert float(np.min(np.asarray(
            cnts.margins(jnp.asarray(world["quad_x"]))))) > -1e-9

    def test_msharded_rejects_nonlinear_and_indivisible(self):
        n = 8
        f64 = dict(dtype=torch.float64)
        obj = QuadraticObjective(P=torch.eye(n, **f64),
                                 a=torch.zeros(n, **f64),
                                 r=torch.zeros((), **f64))
        # the checks run before any collective: a mesh record is enough
        mesh = Mesh(group=None, axis="m", size=8, rank=0,
                    device=torch.device("cpu"))
        nl = NonlinearBlock(fn=lambda p, x: (x @ x)[None], params=None,
                            ub=torch.ones(1, **f64), num=1, in_dim=n)
        with pytest.raises(ValueError, match="Nonlinear"):
            primal_dual_solve_msharded(obj, ConstraintSet(blocks=(nl,)),
                                       torch.zeros(n, **f64), mesh=mesh)
        lin = LinearBlock(G=torch.ones(3, n, **f64),
                          c=torch.zeros(3, **f64), ub=torch.ones(3, **f64))
        with pytest.raises(ValueError, match="divisible"):
            primal_dual_solve_msharded(obj, ConstraintSet(blocks=(lin,)),
                                       torch.zeros(n, **f64), mesh=mesh)
        lin8 = LinearBlock(G=torch.ones(8, n, **f64),
                           c=torch.zeros(8, **f64), ub=torch.ones(8, **f64))
        with pytest.raises(ValueError, match="whole-space"):
            primal_dual_solve_msharded(
                obj, ConstraintSet(blocks=(lin8,),
                                   domain=positive_orthant(n)),
                torch.zeros(n, **f64), mesh=mesh)

    def test_active_constraints_bind(self, world):
        """The sharded solve respects the constraints: feasible, the
        unconstrained optimum z cut off, stationarity with the barrier
        dual estimate lam = 1/(t d)."""
        G, ub, z = W.msharded_data(512, 32)
        x, lam = world["br_x"], world["br_lam"]
        assert float(np.min(ub - G @ x)) > -1e-9
        assert float(np.min(ub - G @ z)) < 0
        assert float(np.max(np.abs((x - z) + G.T @ lam))) < 1e-3
