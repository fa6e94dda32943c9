"""Pressure solvers of the dense layout (DFSPH)."""

from .common import SolverDiagnostics
from .nonpressure import ForceSet

__all__ = ["SolverDiagnostics", "ForceSet"]
