"""Open convex domains (sets where objectives and constraints are defined).

Counterpart of ``cvx_tpu/problem/sets.py`` (cvx/ConvexSet.scala:13-109,
cvx/ConvexSets.scala): a membership predicate plus an optional interior
``sample`` point.  The line searches call the predicate on every
candidate, so it is a fused expression over a batch: ``fn(params, x)``
takes points (..., n) and returns a bool per point (...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


def _always_true(params, x):
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


@dataclass(frozen=True)
class Domain:
    """Membership predicate for an open convex set, with an optional
    interior ``sample`` point (ConvexSet.scala samplePoint: Option)."""

    fn: Callable[[Any, torch.Tensor], torch.Tensor] = _always_true
    params: Any = None
    sample: torch.Tensor | None = None

    def contains(self, x):
        return self.fn(self.params, x)

    def take(self, idx) -> "Domain":
        """The domain of instances ``idx``: parameter-free domains and
        strictly feasible sets restrict; others raise NotImplementedError
        (their callers then keep the whole batch)."""
        if self.params is None:
            return self
        if hasattr(self.params, "take"):
            return Domain(fn=self.fn, params=self.params.take(idx),
                          sample=self.sample)
        raise NotImplementedError("a Domain with parameters of its own")

    def lift(self, extra: int) -> "Domain":
        """Cartesian product with R^extra: the predicate sees only x[:n];
        the sample is padded with the origin (ConvexSets.scala:57-86)."""
        if extra == 0:
            # xs[..., :-0] would be the EMPTY slice
            return self
        fn, n_extra = self.fn, extra

        def lifted(params, xs):
            return fn(params, xs[..., :-n_extra])

        sample = None
        if self.sample is not None:
            sample = torch.cat([self.sample,
                                self.sample.new_zeros((extra,))])
        return Domain(fn=lifted, params=self.params, sample=sample)

    def affine_pullback(self, z, F) -> "Domain":
        """Preimage under x = z + F u (ConvexSets.scala:89-107); the sample
        maps back through the least-squares solve F u0 = x0 - z."""
        sample = None
        if self.sample is not None:
            from ..ops.eigsolve import svd_solve

            sample, _ = svd_solve(F, self.sample - z)
        if self.fn is _always_true:
            # the whole space pulls back to the whole space
            return Domain(sample=sample)
        fn = self.fn

        def pulled(params, u):
            inner, z_, F_ = params
            return fn(inner, z_ + (u @ F_.mT if F_.dim() == 2
                                   else (F_ @ u[..., None])[..., 0]))

        return Domain(fn=pulled, params=(self.params, z, F), sample=sample)

    def intersect(self, other: "Domain") -> "Domain":
        f, g = self.fn, other.fn

        def both(params, x):
            pf, pg = params
            return f(pf, x) & g(pg, x)

        # a factor's sample need not lie in the other factor
        return Domain(fn=both, params=(self.params, other.params))


def whole_space(dim: int | None = None, dtype=torch.float64,
                device=None) -> Domain:
    """R^n; samples the origin when ``dim`` is given (ConvexSets.scala:
    10-14)."""
    sample = None if dim is None else torch.zeros((dim,), dtype=dtype,
                                                  device=device)
    return Domain(sample=sample)


def _all_positive(params, x):
    return torch.all(x > 0, dim=-1)


def positive_orthant(dim: int | None = None, dtype=torch.float64,
                     device=None) -> Domain:
    """{x : x_j > 0}, the KL objective's domain; samples 1/dim when
    ``dim`` is given (ConvexSets.scala:17-22)."""
    sample = None if dim is None else torch.full((dim,), 1.0 / dim,
                                                 dtype=dtype, device=device)
    return Domain(fn=_all_positive, sample=sample)


def cartesian_product(C: Domain, D: Domain, n: int) -> Domain:
    """C x D on R^(n+m): the first ``n`` coordinates against C, the rest
    against D; the sample is the concatenation when both carry one
    (ConvexSets.scala:57-86)."""
    fC, fD = C.fn, D.fn

    def fn(params, x):
        pC, pD = params
        return fC(pC, x[..., :n]) & fD(pD, x[..., n:])

    sample = None
    if C.sample is not None and D.sample is not None:
        sample = torch.cat([C.sample, D.sample])
    return Domain(fn=fn, params=(C.params, D.params), sample=sample)


def _strictly(params, x):
    return params.satisfied_strictly(x)


def strictly_feasible_set(cnts, feasible_point=None) -> Domain:
    """{x : every constraint of ``cnts`` holds strictly} (ConvexSet.scala:
    86-109).  A given ``feasible_point`` becomes the sample and is checked
    here (the reference's factory assert)."""
    if not hasattr(cnts, "satisfied_strictly"):
        from .constraint_set import ConstraintSet

        cnts = ConstraintSet(blocks=(cnts,))
    sample = None
    if feasible_point is not None:
        sample = torch.as_tensor(feasible_point)
        if not bool(torch.all(cnts.satisfied_strictly(sample))):
            raise ValueError(
                "strictly_feasible_set: feasible point does not satisfy "
                "all constraints strictly")
    return Domain(fn=_strictly, params=cnts, sample=sample)
