"""Problem modeling layer: objectives, constraint blocks, equalities and
domains over a batch of points (counterpart of ``cvx_tpu/problem``)."""

from .constraint_set import ConstraintSet
from .constraints import (LinearBlock, NonlinearBlock, QuadBlock, abs_bounded,
                          abs_sum_bounded, expectation_lt,
                          first_coordinates_positive, half_norm2_bounded,
                          positivity, rows_leq)
from .equality import EqualityConstraint, expectation_eq, sum_to_one
from .objective import (AffineObjective, CustomObjective, LinearObjective,
                        QuadraticObjective, affine_pullback, norm_squared,
                        p_norm_p, power_objective, quadratic_residual,
                        regularized_equation_residual)
from .sets import (Domain, cartesian_product, positive_orthant,
                   strictly_feasible_set, whole_space)

__all__ = [
    "ConstraintSet", "LinearBlock", "NonlinearBlock", "QuadBlock",
    "abs_bounded", "abs_sum_bounded", "expectation_lt",
    "first_coordinates_positive", "half_norm2_bounded", "positivity",
    "rows_leq", "EqualityConstraint", "expectation_eq", "sum_to_one",
    "AffineObjective", "CustomObjective", "LinearObjective",
    "QuadraticObjective", "affine_pullback", "norm_squared", "p_norm_p",
    "power_objective", "quadratic_residual",
    "regularized_equation_residual", "Domain", "cartesian_product",
    "positive_orthant", "strictly_feasible_set", "whole_space",
]
