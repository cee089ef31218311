"""Newton steps by outer stage of the reference's barrier (the structured
BR_fast of DiagQP and the generic ``"BR"``), in its vmapped
``while_loop``, on the port's numpy data: the reference's column beside
``probe_structured.py --stages``, which prints the same table for a port
tree (its ``stage_table`` and ``cut_runs`` are used here).

Two families:

* ``chip_smoke.py`` phase 4c's DiagQP batch (``cvx_tpu_torch._bench.
  diagqp_data``: ``default_rng(11)``, n = 100, k = 4 random rows, one
  sum-to-one row, ``SolverParams(tol=1e-9, kkt_method="chol")``);
* instances of phase 4b's ``"BR"`` batch (bench.py's family,
  ``solve_jittable(method="BR")``, f64), chosen by index.

A stage's steps per instance are the difference of ``iters`` between runs
cut after s and s - 1 outer stages (``outer_max_iter``).

    python -m tests._structured_spin [--batch 2000] [--br 0,17,...]
    python -m tests._structured_spin --once [--batch 10000]

prints one JSON line per family with the per-stage maxima, their sum, and
the instances that reach ``max_iter`` in a stage (``--batch 0`` skips the
DiagQP family).  ``--once`` runs the DiagQP family uncut and lists the
instances that reach ``max_iter`` (not in which stage); its port
counterpart is ``probe_structured.py --device cpu --batch B`` (the DiagQP
row's ``spun``).  JAX runs on the CPU in f64.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from cvx_tpu_torch._bench import diagqp_data  # noqa: E402
from probe_structured import (DIAG_TOL, br_data, cut_runs,  # noqa: E402
                              stage_table)


def _diagqp_iters(B, pars):
    """The reference's DiagQP batch, vmapped: iters per instance."""
    import jax
    import jax.numpy as jnp
    from cvx_tpu.models.qp import DiagQP as RefDiagQP

    c, a, U, ub, x0 = diagqp_data(B)
    one = np.ones((1, c.size))

    def solve(ai, ubi):
        return RefDiagQP(c=jnp.asarray(c), a=ai, U=jnp.asarray(U), ub=ubi,
                         A=jnp.asarray(one), b=jnp.ones(1)).solve_jittable(
            jnp.asarray(x0), pars).iters
    return np.asarray(jax.jit(jax.vmap(solve))(jnp.asarray(a),
                                               jnp.asarray(ub)))


def _br_iters(idx, pars):
    """The reference's "BR" route on the instances ``idx``, vmapped."""
    import jax
    import jax.numpy as jnp
    from cvx_tpu.models.dist_kl import DistKL as RefDistKL

    H, U, X0 = br_data(idx)
    prob = RefDistKL.create(H.shape[1], H=jnp.asarray(H), u=jnp.zeros(2))

    def solve(ui, x0):
        return dataclasses.replace(prob, u=ui).solve_jittable(
            x0, "BR", pars).iters
    return np.asarray(jax.jit(jax.vmap(solve))(jnp.asarray(U),
                                               jnp.asarray(X0)))


def _params(s, **kw):
    from cvx_tpu.solvers import SolverParams

    return SolverParams(**kw) if s is None else SolverParams(
        outer_max_iter=s, **kw)


def ref_diagqp(B):
    """The DiagQP family's stage table in the reference."""
    return stage_table(cut_runs(
        lambda p: _diagqp_iters(B, p),
        lambda s: _params(s, tol=DIAG_TOL, kkt_method="chol")),
        _params(None).max_iter)


def ref_br(idx):
    """The "BR" instances' stage table in the reference."""
    return stage_table(cut_runs(lambda p: _br_iters(idx, p), _params),
                       _params(None).max_iter)


def ref_once(B):
    """One uncut run of the DiagQP family: the instances at ``max_iter``."""
    pars = _params(None, tol=DIAG_TOL, kkt_method="chol")
    iters = _diagqp_iters(B, pars)
    spun = np.nonzero(iters >= pars.max_iter)[0]
    return dict(over_max_iter=len(spun), spun=[int(i) for i in spun],
                iters_max=int(iters.max()), iters_sum=int(iters.sum()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2000)
    ap.add_argument("--br", default="",
                    help="comma-separated instances of the BR batch")
    ap.add_argument("--once", action="store_true",
                    help="one uncut DiagQP run at --batch (which instances "
                         "spin, not in which stage)")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if args.once:
        print(json.dumps(dict(pkg="ref", family="DiagQP once", B=args.batch,
                              **ref_once(args.batch))), flush=True)
        return 0
    if args.batch:
        print(json.dumps(dict(pkg="ref", family="DiagQP", B=args.batch,
                              **ref_diagqp(args.batch))), flush=True)
    idx = [int(v) for v in args.br.split(",") if v]
    if idx:
        print(json.dumps(dict(pkg="ref", family="BR", instances=idx,
                              **ref_br(idx))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
