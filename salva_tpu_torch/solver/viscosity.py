"""Viscosity force configurations: XSPH, artificial (Monaghan) and DFSPH
(implicit strain-rate projection) viscosity.

The merged per-type configurations of ``salva_tpu.solver.viscosity``
(one coefficient per fluid, 0 for fluids that do not carry the force).
Only the configurations are ported: the port runs these forces on the
dense layout (``solver/forces_dense.py``); their gather-layout ``apply``
waits for the gather layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class XSPHViscosityForce:
    """Velocity-smoothing XSPH viscosity (`xsph_viscosity.rs:30-97`)."""

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="xsph_viscosity", init=False)


@dataclasses.dataclass(frozen=True)
class ArtificialViscosityForce:
    """Monaghan artificial viscosity (`artificial_viscosity.rs:40-125`).

    Defaults alpha=1, beta=0, speed_of_sound=10 (`:30-36`).

    Deviation from the reference, as in ``salva_tpu``: the boundary force
    feedback applies each contact's own contribution; the reference
    accumulates the running per-particle sum into every subsequent
    contact (`artificial_viscosity.rs:113-116`), an upstream bug fixed
    consciously (``DESIGN.md``).
    """

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]
    alphas: Tuple[float, ...]
    betas: Tuple[float, ...]
    speeds_of_sound: Tuple[float, ...]
    kind: str = dataclasses.field(default="artificial_viscosity", init=False)


@dataclasses.dataclass(frozen=True)
class DFSPHViscosityForce:
    """Implicit strain-rate projection viscosity (`dfsph_viscosity.rs`).

    Per-fluid viscosity coefficients in [0, 1]; fluids with
    ``participating = 0`` are excluded from both the solve and the error
    mean (one joint loop whose termination uses the max over the
    participating fluids' mean errors, as in ``salva_tpu``).
    Fluid-internal only: no boundary term (`dfsph_viscosity.rs:82-86`).

    As ``salva_tpu`` documents, the reference's iteration diverges at its
    own gain on free blobs (`dfsph_viscosity.rs:308-313`); the port is
    faithful to that behavior.
    """

    viscosity_coefficients: Tuple[float, ...]
    participating: Tuple[int, ...]
    min_viscosity_iter: int = 1
    max_viscosity_iter: int = 50
    max_viscosity_error: float = 0.01
    kind: str = dataclasses.field(default="dfsph_viscosity", init=False)
