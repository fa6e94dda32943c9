"""Global configuration dataclasses of the PyTorch port.

The same frozen dataclasses as ``salva_tpu.config`` (field for field, so a
configuration reads the same in both packages). The reference engine
(dimforge/salva) configures itself through cargo features
(``dim2``/``dim3``), constructor parameters (``LiquidWorld::new(solver,
particle_radius, smoothing_factor)``, reference ``src/liquid_world.rs:39-57``)
and public solver fields (``src/solver/pressure/dfsph_solver.rs:21-38``).

Several defaults below were chosen in the JAX package from TPU
measurements (the cap tiers, ``dense_spill_auto``, ``pallas_auto_cells``,
the brute-tier ceilings). In this package each of them is a hypothesis
until it is measured on the GPU; the port does not read
``use_pallas`` / ``pallas_variant`` / ``pallas_auto_cells`` at all — the
hand kernels run whenever the tensors live on a CUDA device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static configuration of the gather-layout neighbor search (the
    [N, K] table width, the candidate window per query, and the query
    rows per block). The dense layout does not read it."""

    max_neighbors: int = 64
    max_candidates: int = 288
    query_chunk: int = 65536

    def replace(self, **kw) -> "NeighborConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DFSPHConfig:
    """Divergence-Free SPH solver parameters.

    Defaults mirror the reference (``dfsph_solver.rs:54-70``): 1..50
    pressure iterations with 5% density tolerance, 1..50 divergence
    iterations with 0.1 tolerance, and a minimum neighbor count of 6 (2D) /
    20 (3D) for the divergence solve.
    """

    min_pressure_iter: int = 1
    max_pressure_iter: int = 50
    max_density_error: float = 0.05
    min_divergence_iter: int = 1
    max_divergence_iter: int = 50
    max_divergence_error: float = 0.1
    # ``None`` means the dim-dependent reference default (6 in 2D, 20 in 3D).
    min_neighbors_for_divergence_solve: Optional[int] = None
    # Warm-start factor: each solve's initial stiffness guess is
    # ``warm_start x`` the previous step's accumulated stiffness (the
    # SPlisHSPlasH DFSPH warm start; the reference solver is cold-started
    # every step, `dfsph_solver.rs:432-503`). 0.0 (default) disables —
    # the exact reference trajectory.
    warm_start: float = 0.0

    kind: str = dataclasses.field(default="dfsph", init=False)

    def min_neighbors(self, dim: int) -> int:
        if self.min_neighbors_for_divergence_solve is not None:
            return self.min_neighbors_for_divergence_solve
        return 6 if dim == 2 else 20

    def replace(self, **kw) -> "DFSPHConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class IISPHConfig:
    """Implicit Incompressible SPH solver parameters.

    Defaults mirror the reference (``iisph_solver.rs``): 1..50 relaxed
    Jacobi pressure iterations with 5% density tolerance and relaxation
    factor ``omega`` 0.5. Runs on the dense layout
    (``solver/iisph_dense.py``) and the gather layout
    (``solver/iisph.py``)."""

    min_pressure_iter: int = 1
    max_pressure_iter: int = 50
    max_density_error: float = 0.05
    omega: float = 0.5

    kind: str = dataclasses.field(default="iisph", init=False)

    def replace(self, **kw) -> "IISPHConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Top-level static simulation configuration.

    ``h`` (the SPH kernel radius / grid cell width) is derived exactly like
    the reference: ``particle_radius * smoothing_factor * 2.0``
    (``liquid_world.rs:47``). Field meanings are those of
    ``salva_tpu.config.SimConfig``; the notes below say what this package
    does with each.
    """

    dim: int = 3
    particle_radius: float = 0.05
    smoothing_factor: float = 2.0
    neighbors: NeighborConfig = NeighborConfig()
    # "dense" (binned cell grid; needs ``domain``), "brute" (the all-pairs
    # tier, ``geometry.dense_grid.brute_spec``: one exact capacity^2 pair
    # block as a 1D cyclic grid of ``brute_cells`` cells; needs
    # ``domain``), "auto" (dense when a domain is set, brute instead on a
    # GPU when the capacities sit under ``brute_max_particles`` /
    # ``brute_max_boundary``), "gather" (the Morton grid and [N, K]
    # neighbour tables; what "auto" resolves to without a domain, for a
    # mostly empty grid, or with a force that has no dense form).
    layout: str = "auto"
    brute_cells: int = 32
    brute_max_particles: int = 4096
    brute_max_boundary: int = 32768
    # Static simulation domain ((mins...), (maxs...)) enabling the dense
    # layout. Particles leaving the box are clamped to its border cells.
    domain: Optional[tuple] = None
    # Fluid-tracking grid window (cells per axis), set by the world: the
    # dense grid covers a window of these dims whose origin follows the
    # live fluid bounding box each substep. None = the full domain.
    fitted_dims: Optional[tuple] = None
    # Dense layout capacities: max particles per cell (cell width = h).
    dense_cap: int = 12
    dense_cap_boundary: int = 24
    # Compact active-cell layout: not ported (raises when True).
    dense_compact: bool = False
    dense_active_ratio: float = 0.25
    dense_active_ratio_boundary: float = 0.5
    # Frozen pair coefficients: not ported (raises when True).
    dense_frozen_pairs: bool = False
    dense_pair_dtype: str = "float32"
    # Boundary side binned over occupied boundary cells only (the sparse
    # boundary path); the fluid-owner passes read it rematerialized onto
    # the full grid.
    dense_sparse_boundary: bool = True
    # Sparse fluid-boundary hoist table size (columns within one cell of
    # an occupied boundary cell); set by the world. None = full-grid fb
    # hoist.
    dense_fb_columns: Optional[int] = None
    # Dense+spill structure: not ported (raises when set).
    dense_spill_columns: Optional[int] = None
    dense_spill_adj_columns: Optional[int] = None
    dense_spill_k: int = 8
    dense_spill_auto: bool = False
    # Uniform-particle fast path: (fluid_handle, mass, density0) when the
    # world holds exactly one fluid; the mass / rest-density channels are
    # then derived from the occupancy mask. Set by the world.
    uniform_particles: Optional[tuple] = None
    # Recompute boundary volumes (V_b = 1/sum W_bb) this step; the world
    # clears it for steps where no boundary changed.
    recompute_boundary_volumes: bool = True
    # Half-stencil symmetry for the plain fluid-fluid passes on CPU
    # tensors (each +/- offset pair shares one pair block); False runs
    # the full-stencil plain folds there. The hand kernels always walk the
    # full stencil.
    dense_half_stencil: bool = True
    # Kept for API parity with the JAX package; not read here (the kernel
    # choice depends on the tensors' device alone).
    use_pallas: bool = None
    pallas_variant: str = "v3"
    pallas_auto_cells: int = 100_000
    # Number of solver substeps per `step` call
    # (``timestep_manager.rs:87-94``: one).
    n_substeps: int = 1
    # Names of the SPH kernels used for density / gradient evaluation.
    kernel_density: str = "cubic"
    kernel_gradient: str = "cubic"

    def __post_init__(self):
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")

    @property
    def h(self) -> float:
        return self.particle_radius * self.smoothing_factor * 2.0

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def particle_volume(particle_radius: float, dim: int) -> float:
    """Default particle volume.

    Volume of a cuboid of half-width ``particle_radius`` scaled by 0.8 so a
    grid-aligned block is pressure-free (SplishSplash-inspired; reference
    ``src/object/fluid.rs:110-120``).
    """
    if dim == 2:
        return particle_radius * particle_radius * 4.0 * 0.8
    return particle_radius * particle_radius * particle_radius * 8.0 * 0.8
