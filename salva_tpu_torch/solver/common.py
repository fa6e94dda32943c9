"""Solver diagnostics shared by the pressure solvers."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SolverDiagnostics(NamedTuple):
    """Iteration counts and final errors of one substep's solves
    (``salva_tpu.solver.common.SolverDiagnostics``). The loops run on the
    host, so the counts are Python ints; the errors stay 0-dim device
    tensors until read."""

    pressure_iters: int
    pressure_error: torch.Tensor
    divergence_iters: int
    divergence_error: torch.Tensor
