"""Carrying problems and results between the JAX package and the port.

The two packages share no code; they meet in numpy arrays.  A ``DistKL``
of either package is a handful of arrays (H, u, A, r, prior) and the
integer n, and the generic records (linear and quadratic constraint
blocks, equalities, linear and quadratic objectives, constraint sets) are
arrays under the reference's field names, so moving a problem across is
a copy of those fields.  Each helper takes any object with those names.
A ``NonlinearBlock`` or ``CustomObjective`` is a function, not data: the
port's is built from its torch ``fn`` and ``params``.  The QP family and
``Solution`` records cross the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.dist_kl import DistKL
from .models.qp import QP, DiagQP
from .problem.constraint_set import ConstraintSet
from .problem.constraints import LinearBlock, QuadBlock
from .problem.equality import EqualityConstraint
from .problem.objective import LinearObjective, QuadraticObjective
from .solvers.types import Solution


def _fields(rec, names, device, dtype):
    """The named array fields of ``rec`` as tensors of one floating dtype
    (default: the first field's) on ``device``."""
    arrs = [np.asarray(getattr(rec, k)) for k in names]
    dtype = dtype or torch.from_numpy(np.zeros(0, arrs[0].dtype)).dtype
    return [torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)
            for a in arrs]


def linear_block_from_numpy(b, *, device="cuda", dtype=None) -> LinearBlock:
    """The port's ``LinearBlock`` from fields G, c, ub (and label)."""
    G, c, ub = _fields(b, ("G", "c", "ub"), device, dtype)
    return LinearBlock(G=G, c=c, ub=ub, label=getattr(b, "label", None))


def quad_block_from_numpy(b, *, device="cuda", dtype=None) -> QuadBlock:
    """The port's ``QuadBlock`` from fields P, a, r, ub (and label)."""
    P, a, r, ub = _fields(b, ("P", "a", "r", "ub"), device, dtype)
    return QuadBlock(P=P, a=a, r=r, ub=ub, label=getattr(b, "label", None))


def equality_from_numpy(e, *, device="cuda", dtype=None
                        ) -> EqualityConstraint:
    """The port's ``EqualityConstraint`` from fields A, b."""
    A, b = _fields(e, ("A", "b"), device, dtype)
    return EqualityConstraint(A=A, b=b)


def linear_objective_from_numpy(o, *, device="cuda", dtype=None
                                ) -> LinearObjective:
    """The port's ``LinearObjective`` from fields a, r."""
    a, r = _fields(o, ("a", "r"), device, dtype)
    return LinearObjective(a=a, r=r)


def quadratic_objective_from_numpy(o, *, device="cuda", dtype=None
                                   ) -> QuadraticObjective:
    """The port's ``QuadraticObjective`` from fields P, a, r."""
    P, a, r = _fields(o, ("P", "a", "r"), device, dtype)
    return QuadraticObjective(P=P, a=a, r=r)


def constraint_set_from_numpy(cs, *, device="cuda", dtype=None
                              ) -> ConstraintSet:
    """The port's ``ConstraintSet`` from a set of linear (G, c, ub) and
    quadratic (P, a, r, ub) blocks, on the whole space (a nonlinear
    block raises ``TypeError``: add the port's with ``add_blocks``)."""
    blocks = []
    for b in cs.blocks:
        if hasattr(b, "P"):
            blocks.append(quad_block_from_numpy(b, device=device, dtype=dtype))
        elif hasattr(b, "G"):
            blocks.append(linear_block_from_numpy(b, device=device,
                                                  dtype=dtype))
        else:
            raise TypeError(
                f"{type(b).__name__} is a function, not data: build the "
                "port's NonlinearBlock from its torch fn and params")
    return ConstraintSet(blocks=tuple(blocks))


def distkl_from_numpy(d, *, device="cuda", dtype=None) -> DistKL:
    """The port's ``DistKL`` from the fields H, u, A, r, n, prior of a
    reference ``DistKL`` (arrays anything ``np.asarray`` takes, prior may
    be None).  ``dtype`` defaults to the dtype of H.  ``device`` defaults
    to the card, as ``DistKL.create``'s does; pass ``device="cpu"`` for the
    plain PyTorch versions."""
    H = np.asarray(d.H)
    dtype = dtype or torch.from_numpy(np.zeros(0, H.dtype)).dtype

    def to(a):
        return torch.from_numpy(np.array(a)).to(dtype=dtype, device=device)

    return DistKL(H=to(H), u=to(d.u), A=to(d.A), r=to(d.r), n=int(d.n),
                  prior=None if d.prior is None else to(d.prior))


def qp_from_numpy(q, *, device="cuda", dtype=None) -> QP:
    """The port's ``QP`` from the fields P, a, G, h, A, b of a reference
    ``QP`` (a, h, b may carry a leading batch axis); ``dtype`` defaults to
    the arrays' joint floating dtype, ``device`` to the card."""
    return QP.create(*(np.asarray(getattr(q, k))
                       for k in ("P", "a", "G", "h", "A", "b")),
                     dtype=dtype, device=device)


def diagqp_from_numpy(q, *, device="cuda", dtype=None) -> DiagQP:
    """The port's ``DiagQP`` from the fields c, a, U, ub, A, b of a
    reference ``DiagQP`` (or an ``LP``)."""
    return DiagQP.create(*(np.asarray(getattr(q, k))
                           for k in ("c", "a", "U", "ub", "A", "b")),
                         dtype=dtype, device=device)


def solution_from_numpy(sol, *, device="cuda") -> Solution:
    """The port's ``Solution`` from the fields of a reference one (arrays
    anything ``np.asarray`` takes, each keeping its dtype; a missing
    ``ineq_res`` stays None)."""
    def leaf(name):
        v = getattr(sol, name, None)
        return None if v is None else torch.from_numpy(
            np.array(v)).to(device)

    return Solution(**{f.name: leaf(f.name)
                       for f in dataclasses.fields(Solution)})


def solution_to_numpy(sol: Solution) -> dict:
    """Every leaf of a ``Solution`` as a numpy array (None stays None)."""
    return {f.name: (None if getattr(sol, f.name) is None
                     else getattr(sol, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(sol)}
