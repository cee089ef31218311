"""The barrier's last-stage null steps, the port beside the reference on
the same data (``tests/_structured_spin.py`` and ``probe_structured.py
--stages``).

At t ~ 1e11-1e12 the Newton decrement of some instances sits at a
rounding floor above tol, and the Armijo test ``fs <= f0 + alpha s q``
accepts a candidate whose value equals f0: the stage then runs to
``max_iter`` = 1,000 (the reference's ``cvx_tpu/solvers/structured.py``
and ``solvers/newton.py``; the port's counterparts keep the rule).  Which
instances spin depends on rounding.  Measured on the CPU (ROADMAP Queue
3):

* ``chip_smoke.py`` phase 4c's DiagQP family (``default_rng(11)``, n =
  100, k = 4 rows, one sum-to-one row, tol 1e-9) at B = 2,000: the
  reference's vmapped loop spins on five instances (839 and 1989 in stage
  8, 250, 261 and 404 in stage 10; 2,428 masked-loop steps), the port's
  on none (387 steps);
* phase 4b's ``"BR"`` batch (bench.py's family, f64), its five longest
  instances on the H100 (2478, 2373, 1595, 4733, 1107; 1,074-1,080
  steps) and three ordinary ones: the reference spins on four of the
  eight (1595, 1, 2478, 4733), the port on one (1107).

So the spin is the reference's, and shows in it at least as often.  The
pin runs those instances through both packages and holds the port to it:
no more instances reach ``max_iter`` in the port than in the reference,
nor than the port's measured count on them (0 of the DiagQP eight, 1 of
the ``"BR"`` eight), and on the instances where neither does, the port's
Newton steps are no more than the reference's plus max(8, 10 %) (a few
steps part the two packages near tol).  Both columns are in the message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _structured_spin import DIAG_TOL, br_data, diagqp_data
from cvx_tpu.models.dist_kl import DistKL as RefDistKL
from cvx_tpu.models.qp import DiagQP as RefDiagQP
from cvx_tpu.solvers import SolverParams as RefParams
from cvx_tpu_torch import DistKL
from cvx_tpu_torch.models import DiagQP
from cvx_tpu_torch.solvers import SolverParams
from cvx_tpu_torch.solvers.structured import record_stages

# six test processes share the CPU's cores (see test_torch_qp.py)
torch.set_num_threads(1)

MAX_ITER = SolverParams().max_iter
# instances at max_iter in the port, measured on the CPU, of the eight each
PORT_SPINS = {"diagqp": 0, "br": 1}
F64 = dict(dtype=torch.float64)


def _diagqp():
    idx = [839, 1989, 250, 261, 404, 0, 1, 2]
    c, a, U, ub, x0 = diagqp_data(2000)
    a, ub = a[idx], ub[idx]
    one = np.ones((1, c.size))
    rpars = RefParams(tol=DIAG_TOL, kkt_method="chol")

    def solve(ai, ubi):
        return RefDiagQP(c=jnp.asarray(c), a=ai, U=jnp.asarray(U), ub=ubi,
                         A=jnp.asarray(one), b=jnp.ones(1)).solve_jittable(
            jnp.asarray(x0), rpars).iters

    ref = jax.jit(jax.vmap(solve))(jnp.asarray(a), jnp.asarray(ub))
    dq = DiagQP.create(c, a, U, ub, one, np.ones(1), device="cpu")
    with record_stages() as stages:
        sol = dq.solve_jittable(torch.tensor(x0), SolverParams(
            tol=DIAG_TOL, kkt_method="chol"))
    # the record holds the masked loop: a stage runs as long as its
    # longest instance, so no instance runs longer than all stages
    assert len(stages) == 1 and sum(stages[0]) >= int(sol.iters.max())
    return idx, np.asarray(ref), sol.iters.numpy()


def _br():
    idx = [2478, 2373, 1595, 4733, 1107, 0, 1, 2]
    H, U, X0 = br_data(idx)
    n = H.shape[1]
    ref0 = RefDistKL.create(n, H=jnp.asarray(H), u=jnp.zeros(2))
    ref = jax.jit(jax.vmap(lambda ui, x0: dataclasses.replace(ref0, u=ui)
                           .solve_jittable(x0, "BR").iters))(
        jnp.asarray(U), jnp.asarray(X0))
    prob = DistKL.create(n, H=torch.tensor(H, **F64),
                         u=torch.zeros(2, **F64), device="cpu")
    port = prob.solve_jittable_batch(torch.tensor(U, **F64),
                                     torch.tensor(X0, **F64), "BR").iters
    return idx, np.asarray(ref), port.numpy()


@pytest.mark.parametrize("family", ["diagqp", "br"])
def test_port_spins_no_more_than_the_reference(family):
    idx, ref, port = {"diagqp": _diagqp, "br": _br}[family]()
    side = {i: (int(r), int(p)) for i, r, p in zip(idx, ref, port)}
    ref_spun, port_spun = ref >= MAX_ITER, port >= MAX_ITER
    assert port_spun.sum() <= min(ref_spun.sum(), PORT_SPINS[family]), \
        f"(reference, port): {side}"
    calm = ~ref_spun & ~port_spun
    slack = np.maximum(8, np.ceil(0.1 * ref))
    assert np.all(port[calm] <= ref[calm] + slack[calm]), \
        f"(reference, port): {side}"
