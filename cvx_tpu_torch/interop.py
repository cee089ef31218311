"""Carrying problems and results between the JAX package and the port.

The two packages share no code; they meet in numpy arrays.  A ``DistKL``
of either package is a handful of arrays (H, u, A, r, prior) and the
integer n, so moving a problem across is a copy of those fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.dist_kl import DistKL
from .solvers.types import Solution


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


def solution_to_numpy(sol: Solution) -> dict:
    """Every leaf of a ``Solution`` as a numpy array (None stays None)."""
    return {f.name: (None if getattr(sol, f.name) is None
                     else getattr(sol, f.name).detach().cpu().numpy())
            for f in dataclasses.fields(sol)}
