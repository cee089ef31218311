"""Solver configuration and result records."""

from .types import Solution, SolverParams

__all__ = ["Solution", "SolverParams"]
