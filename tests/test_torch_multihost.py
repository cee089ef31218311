"""The parallel port's process groups joined the two ways a cluster joins
them, and the launcher's failure modes, on gloo ranks on the CPU.

Mirrors ``tests/test_multihost.py``: ranks wired through
``parallel.mesh.init_distributed`` (an explicit ``tcp://`` address, rank
and world size, or the ``env://`` variables) run the dp "BR" batch and
the sharded Schur KKT solve; the results match the single-process
reference within its bound (1e-10 for the Schur solve; the "BR" batch
within 1e-10 of the port's local run and 1e-8 of the reference, the
parity bound of ``tests/test_torch_dist_kl_generic.py``).  A rank that
hangs in a collective, or fails, fails the launch within its time limit,
and every rank is stopped.  Also the port's counterpart of
``__graft_entry__.dryrun_multichip`` on four CPU ranks.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from cvx_tpu.models import DistKL as RefDistKL
from cvx_tpu.parallel.schur import schur_kkt_solve as ref_schur
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch.parallel.mesh import free_port, spawn_ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("how", ["tcp", "env"])
def test_four_ranks_match_single_process(how, tmp_path, monkeypatch):
    out = str(tmp_path / "multihost.npz")
    port = free_port()
    if how == "tcp":
        init = f"tcp://127.0.0.1:{port}"
    else:
        # the ranks read the address from the environment they inherit
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(port))
        init = "env://"
    spawn_ranks(W.multihost_world, 4, out, init_method=init, device="cpu",
                timeout=240.0)
    data = np.load(out)

    H, U, (Hb, C, q) = W.multihost_data()
    pars = RefParams(max_iter=20, tol=1e-6, kkt_method="chol", kkt_refine=1)

    def one(u):
        prob = RefDistKL.create(16, H=jnp.asarray(H), u=u)
        return prob.solve_jittable(jnp.full((16,), 1.0 / 16), method="BR",
                                   pars=pars).x

    xs_ref = np.asarray(jax.vmap(one)(jnp.asarray(U)))
    assert np.max(np.abs(data["xs"] - data["xs_local"])) <= 1e-10
    assert np.max(np.abs(data["xs"] - xs_ref)) <= 1e-8
    dx_ref, w_ref = ref_schur(jnp.asarray(Hb), jnp.asarray(C), jnp.asarray(q),
                              jnp.zeros(C.shape[1]))
    assert np.allclose(data["dx"], np.asarray(dx_ref), atol=1e-10)
    assert np.allclose(data["w"], np.asarray(w_ref), atol=1e-10)


def test_hung_rank_fails_within_its_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn_ranks(W.hang_world, 2, init_method=f"file://{tmp_path}/rdv",
                    device="cpu", timeout=15.0)
    assert time.monotonic() - t0 < 60.0


def test_failing_rank_fails_the_launch(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(W.fail_world, 2, init_method=f"file://{tmp_path}/rdv",
                    device="cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_dryrun_multichip_four_cpu_ranks():
    """``__graft_entry__.py:56-214``'s dry run: the six shardings on four
    gloo ranks, each within its bound of its local run (the certified dp
    route in bits)."""
    from cvx_tpu_torch.parallel.dryrun import dryrun_multichip

    errs = dryrun_multichip(4, "cpu", timeout=240.0)
    assert set(errs) == {"dp BR", "blocks Schur", "m barrier",
                         "m primal-dual", "tp KKT", "dp certified"}
    assert errs["dp certified"] == 0.0
