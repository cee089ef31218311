"""Solver configuration and result records, the Newton engines, the
barrier and primal-dual interior-point methods, phase-I feasibility and
the structured barrier."""

from .barrier import barrier_solve
from .newton import newton_minimize, newton_minimize_eq
from .phase1 import (FeasibilityReport, InfeasibleProblemError,
                     feasibility_analysis, find_feasible_point,
                     phase1_by_reduction, phase1_simple, phase1_soi,
                     phase1_with_eqs_as_ineqs)
from .primal_dual import primal_dual_solve
from .structured import barrier_solve_structured
from .types import (NewtonResult, OptState, Solution, SolverParams,
                    phase1_criterion, standard_criterion)

__all__ = [
    "FeasibilityReport", "InfeasibleProblemError", "NewtonResult",
    "OptState", "Solution", "SolverParams", "barrier_solve",
    "barrier_solve_structured", "feasibility_analysis",
    "find_feasible_point", "newton_minimize", "newton_minimize_eq",
    "phase1_by_reduction", "phase1_criterion", "phase1_simple",
    "phase1_soi", "phase1_with_eqs_as_ineqs", "primal_dual_solve",
    "standard_criterion",
]
