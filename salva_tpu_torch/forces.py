"""User-facing non-pressure force descriptors.

These mirror the constructors of the reference's force objects
(``src/solver/{viscosity,surface_tension,elasticity}``); the world merges
the per-fluid instances into the vectorized per-type configurations in
``solver/``. A copy of ``salva_tpu.forces`` (which imports no JAX), so
that a scene reads the same in both packages; the port runs every force
here, on every layout.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class XSPHViscosity:
    """`XSPHViscosity::new(fluid, boundary)` (`xsph_viscosity.rs:21-28`)."""

    fluid_viscosity_coefficient: float
    boundary_viscosity_coefficient: float = 0.0


@dataclasses.dataclass
class ArtificialViscosity:
    """`ArtificialViscosity::new` with defaults alpha=1, beta=0, c=10
    (`artificial_viscosity.rs:27-38`)."""

    fluid_viscosity_coefficient: float
    boundary_viscosity_coefficient: float = 0.0
    alpha: float = 1.0
    beta: float = 0.0
    speed_of_sound: float = 10.0


@dataclasses.dataclass
class DFSPHViscosity:
    """`DFSPHViscosity::new(coefficient)` with coefficient in [0, 1]
    (`dfsph_viscosity.rs:101-120`)."""

    viscosity_coefficient: float
    min_viscosity_iter: int = 1
    max_viscosity_iter: int = 50
    max_viscosity_error: float = 0.01

    def __post_init__(self):
        if not 0.0 <= self.viscosity_coefficient <= 1.0:
            raise ValueError(
                "The viscosity coefficient must be between 0.0 and 1.0."
            )


@dataclasses.dataclass
class Akinci2013SurfaceTension:
    """`Akinci2013SurfaceTension::new(tension, adhesion)`
    (`akinci2013_surface_tension.rs:26-36`)."""

    fluid_tension_coefficient: float
    boundary_adhesion_coefficient: float = 0.0


@dataclasses.dataclass
class He2014SurfaceTension:
    """`He2014SurfaceTension::new(tension, boundary_tension)`
    (`he2014_surface_tension.rs:20-29`)."""

    fluid_tension_coefficient: float
    boundary_tension_coefficient: float = 0.0


@dataclasses.dataclass
class WCSPHSurfaceTension:
    """`WCSPHSurfaceTension::new(tension, boundary_tension)`
    (`wcsph_surface_tension.rs:21-29`)."""

    fluid_tension_coefficient: float
    boundary_tension_coefficient: float = 0.0


@dataclasses.dataclass
class Becker2009Elasticity:
    """`Becker2009Elasticity::new(young_modulus, poisson_ratio,
    nonlinear_strain)` (`becker2009_elasticity.rs:61-82`)."""

    young_modulus: float
    poisson_ratio: float
    nonlinear_strain: bool = False


FORCE_TYPES = (
    XSPHViscosity,
    ArtificialViscosity,
    DFSPHViscosity,
    Akinci2013SurfaceTension,
    He2014SurfaceTension,
    WCSPHSurfaceTension,
    Becker2009Elasticity,
)
