"""Pressure plus divergence iterations a step, averaged over the window
(``StepDiagnostics.solver``: exact counts)."""


def read(run):
    vals = [s.iters for s in run.steps if not s.raised]
    return sum(vals) / len(vals) if vals else None
