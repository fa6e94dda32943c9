"""Surface tension configurations: Akinci 2013, He 2014 and WCSPH
cohesion.

The merged per-type configurations of ``salva_tpu.solver.surface_tension``
(one coefficient per fluid, 0 for fluids that do not carry the force).
Only the configurations are ported: the port runs these forces on the
dense layout (``solver/forces_dense.py``); their gather-layout ``apply``
waits for the gather layout, as ``solver/viscosity.py``'s do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Akinci2013SurfaceTensionForce:
    """Cohesion + curvature + boundary adhesion
    (`akinci2013_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_adhesion_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="akinci2013_surface_tension",
                                  init=False)


@dataclasses.dataclass(frozen=True)
class He2014SurfaceTensionForce:
    """Color-field surface tension (`he2014_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_tension_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="he2014_surface_tension",
                                  init=False)


@dataclasses.dataclass(frozen=True)
class WCSPHSurfaceTensionForce:
    """Position-difference cohesion (`wcsph_surface_tension.rs`).

    Deviation from the reference, as in ``salva_tpu``: its boundary loop
    iterates the *fluid-fluid* contact list while indexing boundary arrays
    (`wcsph_surface_tension.rs:68-69`), an upstream bug; the fluid-boundary
    contacts are iterated as clearly intended (``DESIGN.md``).
    """

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_tension_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="wcsph_surface_tension",
                                  init=False)
