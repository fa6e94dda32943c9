"""Pressure solvers (DFSPH, IISPH) of the dense and gather layouts, and
the non-pressure forces."""

from .common import SolverDiagnostics, StepContext
from .nonpressure import CustomForce, ForceSet, MaskedCustomForce

__all__ = [
    "SolverDiagnostics",
    "StepContext",
    "ForceSet",
    "CustomForce",
    "MaskedCustomForce",
]
