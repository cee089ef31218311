"""The parallel port's row-sharded Cholesky, solve and KKT elimination on
four gloo ranks on the CPU, against ``cvx_tpu.parallel.tp_chol`` on the
8-device CPU mesh and ``jnp.linalg`` on the same numpy inputs.

Mirrors ``tests/test_tp_chol.py``.  One spawned world of four ranks
(``tests/_torch_parallel_worker.py::tp_chol_world``) runs every sharded
case once at n = 256, block 32, and writes an ``.npz``.  Tolerances, the
reference's own: the factor within 1e-9, the solve within 1e-8, the KKT
round trip within 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from cvx_tpu.parallel import instance_mesh as ref_mesh
from cvx_tpu.parallel.tp_chol import (make_sharded_cholesky as
                                      ref_sharded_cholesky)
from cvx_tpu_torch.parallel import (make_sharded_chol_solve,
                                    make_sharded_cholesky,
                                    make_tp_kkt_solver)
from cvx_tpu_torch.parallel.mesh import Mesh, spawn_ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_chol_world")
    out = str(d / "out.npz")
    spawn_ranks(W.tp_chol_world, 4, out, init_method=f"file://{d}/rdv",
                device="cpu", timeout=240.0)
    return dict(np.load(out))


class TestShardedCholesky:
    """test_tp_chol.py::TestShardedCholesky."""

    def test_matches_local(self, world):
        H = W.spd_data(256, seed=0)
        L_ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(H)))
        assert np.max(np.abs(world["L"] - L_ref)) < 1e-9
        # the reference's own sharded factor on its 8-device CPU mesh
        L_sh = ref_sharded_cholesky(ref_mesh(8, axis="tp"), 256, block=32)(
            jnp.asarray(H))
        assert np.max(np.abs(world["L"] - np.asarray(L_sh))) < 1e-9

    def test_solve_matches(self, world):
        H = W.spd_data(256, seed=0)
        B = np.random.default_rng(1).standard_normal((256, 3))
        X_ref = np.asarray(jnp.linalg.solve(jnp.asarray(H), jnp.asarray(B)))
        assert np.max(np.abs(world["X"] - X_ref)) < 1e-8

    def test_shape_validation(self):
        # the check runs before any collective: a mesh record is enough
        mesh = Mesh(group=None, axis="tp", size=8, rank=0,
                    device=torch.device("cpu"))
        for make in (make_sharded_cholesky, make_sharded_chol_solve):
            with pytest.raises(ValueError, match="divisible"):
                make(mesh, 1000, block=128)
        with pytest.raises(ValueError, match="divisible"):
            make_tp_kkt_solver(mesh, 1000, 4, block=128)


class TestTpKkt:
    """test_tp_chol.py::TestTpKkt: the KktTest.scala:117-147 round trip
    at mesh scale."""

    def test_kkt_round_trip(self, world):
        assert np.max(np.abs(world["kkt_x"] - world["x_true"])) < 1e-7
        assert np.max(np.abs(world["kkt_w"] - world["w_true"])) < 1e-7
