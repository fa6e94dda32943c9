"""`LiquidWorld`: the top-level stateful wrapper around the step.

Port of ``salva_tpu.world``: add and remove fluids and boundaries,
``step`` and ``step_with_coupling`` (the ``CouplingManager`` hooks of
``coupling/``: ``update_boundaries`` before each substep,
``transmit_forces`` after), emitters and deletion on the device through
the alive mask (``emit_particles``, ``delete_where``) and on the host
(``add_particles``, ``delete_particles``, the deferred
``delete_particle_at_next_timestep``), boundary resampling
(``set_boundary_particles``, ``set_boundaries_bulk``), isometries
(``transform_*_by``), Morton reordering (``z_sort``), the particle
queries (``particles_intersecting_aabb`` / ``_shape``), adaptive CFL
substepping (``adaptive_timestep``) and the failure checks
(``debug_checks``). The host side
manages slots, capacity growth and the auto-tuned dense layout (cap tier
with overflow self-heal, the opt-in 12 + spill tier with its tables'
self-heal, fluid-tracking grid window, sparse fluid-boundary table);
every per-step array operation runs on ``device`` as torch tensors.

``device`` defaults to ``"cuda"``; without a GPU the world raises unless
the caller asks for the CPU with ``device="cpu"``. On CUDA the four hot
pair passes run as the hand kernels of ``ops/pair.py``; on the CPU as
their plain versions.

Solvers: DFSPH and IISPH on three layouts: the dense layout over a
static ``domain`` (the grid, or by its ``SimConfig`` flag the compact
active-cell layout, frozen pair coefficients or the dense+spill
structure), the brute all-pairs tier (``layout="brute"``, and
``"auto"`` on a GPU for small worlds), and the gather layout (Morton grid
and [N, K] neighbour tables; ``layout="gather"``, and what ``"auto"``
resolves to without a domain, for a mostly empty grid, or when a fluid
carries a ``CustomForce``). Every SPH kernel choice
(``SimConfig.kernel_density`` / ``kernel_gradient``), and the XSPH,
artificial-viscosity, DFSPH-viscosity, Akinci 2013 / WCSPH / He 2014
surface-tension, Becker 2009 elasticity and custom non-pressure forces.
Checkpoints: ``io.save_world`` / ``load_world``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from . import counters
from . import forces as force_specs
from .config import DFSPHConfig, NeighborConfig, SimConfig, particle_volume
from .counters import Counters
from .geometry import build_grid, evaluate_contacts, find_neighbors
from .geometry import dense_grid as dg
from .geometry.grid import DEAD_KEY, cell_coords, morton_key
from .geometry.neighbors import GroupInfo
from .kernels import get_kernel
from .object.interaction_groups import InteractionGroups
from .object.state import (
    BoundariesState,
    FluidsState,
    set_rows,
    set_rows_drop,
)
from .solver.dense_common import fold_pairs
from .solver.elasticity import (
    Becker2009ElasticityForce,
    build_elasticity_state,
    elasticity_coefficients,
)
from .solver.nonpressure import (
    CustomForce,
    ForceSet,
    MaskedCustomForce,
    merge_per_fluid,
)
from .solver.surface_tension import (
    Akinci2013SurfaceTensionForce,
    He2014SurfaceTensionForce,
    WCSPHSurfaceTensionForce,
)
from .solver.viscosity import (
    ArtificialViscosityForce,
    DFSPHViscosityForce,
    XSPHViscosityForce,
)
from .shapes import dot, world_sdf
from .step import (
    StepDiagnostics,
    build_step_fn,
    init_solver_state,
    solver_state_shape,
)
from .timestep import TimestepManager


class Fluid:
    """Host-side fluid description (`src/object/fluid.rs`)."""

    def __init__(
        self,
        positions,
        particle_radius: Optional[float] = None,
        density0: float = 1000.0,
        velocities=None,
        nonpressure_forces: Optional[List] = None,
        interaction_groups: InteractionGroups = InteractionGroups(),
    ):
        self.positions = np.asarray(positions, np.float32).reshape(
            -1, np.asarray(positions).shape[-1] if len(positions) else 2
        )
        self.velocities = (
            np.asarray(velocities, np.float32) if velocities is not None else None
        )
        self.particle_radius = particle_radius
        self.density0 = float(density0)
        self.nonpressure_forces = list(nonpressure_forces or [])
        self.interaction_groups = interaction_groups

    @property
    def num_particles(self) -> int:
        return len(self.positions)


class Boundary:
    """Host-side boundary description (`src/object/boundary.rs`)."""

    def __init__(
        self,
        positions,
        velocities=None,
        interaction_groups: InteractionGroups = InteractionGroups(),
    ):
        arr = np.asarray(positions, np.float32)
        self.positions = arr.reshape(-1, arr.shape[-1]) if arr.size else arr.reshape(0, 0)
        self.velocities = (
            np.asarray(velocities, np.float32) if velocities is not None else None
        )
        self.interaction_groups = interaction_groups


@dataclasses.dataclass
class _FluidRecord:
    density0: float
    groups: InteractionGroups
    nonpressure_forces: List
    particle_radius: float = 0.0
    removed: bool = False


@dataclasses.dataclass
class _BoundaryRecord:
    groups: InteractionGroups
    removed: bool = False


# The non-pressure forces a fluid may carry: those of ``forces.py`` and
# user subclasses of ``CustomForce`` (which run on the gather layout).
_PORTED_FORCES = (
    force_specs.XSPHViscosity,
    force_specs.ArtificialViscosity,
    force_specs.DFSPHViscosity,
    force_specs.Akinci2013SurfaceTension,
    force_specs.WCSPHSurfaceTension,
    force_specs.He2014SurfaceTension,
    force_specs.Becker2009Elasticity,
    CustomForce,
)


def _next_capacity(needed: int, minimum: int = 64) -> int:
    cap = minimum
    while cap < needed:
        cap *= 2
    return cap


def _emit(st, pos, vel, vol, density0, handle, memberships, filt):
    """Write an emission template into the first free slots (device-side
    `Fluid::add_particles`, `fluid.rs:126-150`): rank free slots by
    cumsum, invert the ranking into per-row target slots, scatter. Rows
    beyond the free-slot count drop."""
    e = pos.shape[0]
    n = st.alive.shape[0]
    dev = st.alive.device
    free = ~st.alive
    rank = torch.cumsum(free.to(torch.int32), 0) - 1
    iota = torch.arange(n, device=dev)
    tgt = set_rows_drop(
        torch.full((e,), n, dtype=torch.long, device=dev),
        torch.where(free & (rank < e), rank, e).long(), iota,
    )
    return st.replace(
        positions=set_rows_drop(st.positions, tgt, pos),
        velocities=set_rows_drop(st.velocities, tgt, vel),
        volumes=set_rows_drop(st.volumes, tgt, vol),
        density0=set_rows_drop(st.density0, tgt, density0),
        alive=set_rows_drop(st.alive, tgt, True),
        fluid_id=set_rows_drop(st.fluid_id, tgt, handle),
        memberships=set_rows_drop(st.memberships, tgt, memberships),
        filter=set_rows_drop(st.filter, tgt, filt),
    )


def _grow_state(old, new):
    """``new`` (a larger empty state) with ``old``'s rows copied in."""
    cap = old.capacity
    kw = {}
    for f in dataclasses.fields(old):
        t = getattr(new, f.name).clone()
        t[:cap] = getattr(old, f.name)
        kw[f.name] = t
    return new.replace(**kw)


class LiquidWorld:
    """The physics world for simulating fluids with boundaries.

    ``h = particle_radius * smoothing_factor * 2.0`` exactly like
    `liquid_world.rs:47`.
    """

    def __init__(
        self,
        solver=None,
        particle_radius: float = 0.05,
        smoothing_factor: float = 2.0,
        dim: int = 3,
        neighbors: Optional[NeighborConfig] = None,
        n_substeps: int = 1,
        adaptive_timestep: bool = False,
        domain=None,
        layout: str = "auto",
        dense_cap: Optional[int] = None,
        dense_cap_boundary: Optional[int] = None,
        fit_grid: bool = True,
        device=None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LiquidWorld runs on a CUDA device by default and none "
                    "is available; pass device=\"cpu\" to run the plain "
                    "PyTorch passes on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.solver_config = solver if solver is not None else DFSPHConfig()
        # ``dense_cap(_boundary)=None`` auto-sizes the per-cell slot
        # capacities from measured occupancy (``_resolved_dense_caps``);
        # explicit ints are honored unchanged.
        self._dense_cap_request = dense_cap
        self._dense_cap_boundary_request = dense_cap_boundary
        self._auto_caps: Optional[tuple] = None
        self._auto_caps_capacity = None
        # Auto-sized spill table (config.dense_spill_columns): set when the
        # auto cap tier picks 12 + spill (``dense_spill_auto``); grown by
        # the overflow path. The auto-widened condensed K table
        # (config.dense_spill_k): grown on a K overflow.
        self._auto_spill: Optional[int] = None
        self._auto_spill_k: Optional[int] = None
        # Fluid-tracking grid window (config.fitted_dims): dims chosen
        # here with quantization + hysteresis, origin tracked per substep.
        self._fit_grid = bool(fit_grid)
        self._fitted_dims: Optional[tuple] = None
        self._fit_floor_dims: Optional[np.ndarray] = None
        self._initial_fit_done = False
        # Number of window resizes / cap bumps so far (benchmarks read it
        # to see a layout change inside a timed window).
        self.grid_refit_count = 0
        self._full_bvol_stale = True
        self._fb_cols_cache: Optional[tuple] = None
        self._last_dt = 1.0 / 60.0
        self.sim = SimConfig(
            dim=dim,
            particle_radius=particle_radius,
            smoothing_factor=smoothing_factor,
            neighbors=neighbors or NeighborConfig(),
            n_substeps=n_substeps,
            layout=layout,
            domain=(
                tuple(tuple(float(v) for v in side) for side in domain)
                if domain is not None
                else None
            ),
            dense_cap=dense_cap if dense_cap is not None else 12,
            dense_cap_boundary=(
                dense_cap_boundary if dense_cap_boundary is not None else 24
            ),
        )
        self.counters = Counters()
        self.timestep_manager = TimestepManager(
            particle_radius, adaptive=adaptive_timestep
        )

        self.fluids_state = FluidsState.empty(64, dim, self.device)
        self.boundaries_state = BoundariesState.empty(64, dim, self.device)
        self._fluid_alive = np.zeros(64, bool)
        self._fluid_slot_owner = np.full(64, -1, np.int64)
        self._boundary_alive = np.zeros(64, bool)
        self._boundary_slot_owner = np.full(64, -1, np.int64)

        self._fluid_records: List[_FluidRecord] = []
        self._boundary_records: List[_BoundaryRecord] = []
        self._force_set: Optional[ForceSet] = None
        # Becker 2009 rest state (rest contacts from the gather search),
        # rebuilt before the next step when particles change.
        self._elasticity_state = None
        self._elasticity_dirty = False

        # Failure detection (SURVEY.md §5.3): after each step, raise on
        # non-finite positions and warn on every overflow (one host sync
        # a step) instead of the interval checks below.
        self.debug_checks = False
        # Boundary volumes must be recomputed after any boundary change.
        self._boundary_dirty = True
        self._solver_state = None
        self.last_diagnostics: Optional[StepDiagnostics] = None
        # Deferred particle removal (`fluid.rs:71-98`): global slot ids
        # flagged between steps, released at the next step start.
        self._pending_deletions: set = set()
        # Device-side emission / deletion leave the host slot mirrors
        # stale until a host slot operation needs them.
        self._fluid_mirror_stale = False
        # Overflow checks (one host sync each) run on the first step and
        # every ``overflow_check_interval`` steps after.
        self.warn_overflow = True
        self.overflow_check_interval = 16
        self._steps_taken = 0
        self._overflow_alert = 0

    # -- basic accessors ---------------------------------------------------

    @property
    def h(self) -> float:
        return self.sim.h

    @property
    def particle_radius(self) -> float:
        return self.sim.particle_radius

    @property
    def dim(self) -> int:
        return self.sim.dim

    @property
    def num_fluids(self) -> int:
        return len(self._fluid_records)

    @property
    def num_boundaries(self) -> int:
        return len(self._boundary_records)

    # -- capacity management ----------------------------------------------

    def _grow_fluids(self, needed: int):
        cap = self.fluids_state.capacity
        if needed <= cap:
            return
        new_cap = _next_capacity(needed)
        self.fluids_state = _grow_state(
            self.fluids_state, FluidsState.empty(new_cap, self.dim, self.device)
        )
        self._fluid_alive = np.concatenate(
            [self._fluid_alive, np.zeros(new_cap - cap, bool)]
        )
        self._fluid_slot_owner = np.concatenate(
            [self._fluid_slot_owner, np.full(new_cap - cap, -1, np.int64)]
        )
        if self._elasticity_state is not None:
            self._elasticity_dirty = True
        if self._solver_state is not None:
            st = self._solver_state
            grown = torch.zeros((new_cap,) + tuple(st.shape[1:]),
                                dtype=st.dtype, device=st.device)
            grown[: st.shape[0]] = st
            self._solver_state = grown

    def _grow_boundaries(self, needed: int):
        cap = self.boundaries_state.capacity
        if needed <= cap:
            return
        new_cap = _next_capacity(needed)
        self.boundaries_state = _grow_state(
            self.boundaries_state,
            BoundariesState.empty(new_cap, self.dim, self.device),
        )
        self._boundary_alive = np.concatenate(
            [self._boundary_alive, np.zeros(new_cap - cap, bool)]
        )
        self._boundary_slot_owner = np.concatenate(
            [self._boundary_slot_owner, np.full(new_cap - cap, -1, np.int64)]
        )

    def _alloc_fluid_slots(self, n: int) -> np.ndarray:
        self._sync_fluid_mirrors()
        free = np.where(self._fluid_slot_owner < 0)[0]
        if len(free) < n:
            used = int((self._fluid_slot_owner >= 0).sum())
            self._grow_fluids(used + n)
            free = np.where(self._fluid_slot_owner < 0)[0]
        return free[:n]

    def _alloc_boundary_slots(self, n: int) -> np.ndarray:
        free = np.where(self._boundary_slot_owner < 0)[0]
        if len(free) < n:
            used = int((self._boundary_slot_owner >= 0).sum())
            self._grow_boundaries(used + n)
            free = np.where(self._boundary_slot_owner < 0)[0]
        return free[:n]

    # -- object management -------------------------------------------------

    def add_fluid(self, fluid: Fluid) -> int:
        for force in fluid.nonpressure_forces:
            if not isinstance(force, _PORTED_FORCES):
                raise NotImplementedError(
                    f"{type(force).__name__} is not a non-pressure force "
                    "of salva_tpu_torch; fluids may carry "
                    + ", ".join(f.__name__ for f in _PORTED_FORCES)
                    + " subclasses"
                )
        handle = len(self._fluid_records)
        self._fluid_records.append(
            _FluidRecord(
                density0=fluid.density0,
                groups=fluid.interaction_groups,
                nonpressure_forces=fluid.nonpressure_forces,
                particle_radius=(
                    float(fluid.particle_radius)
                    if fluid.particle_radius is not None
                    else self.particle_radius
                ),
            )
        )
        self._force_set = None
        if fluid.num_particles:
            self._write_fluid_particles(
                handle, fluid.positions, fluid.velocities
            )
        if self._has_elasticity(handle):
            self._elasticity_dirty = True
        return handle

    def add_boundary(self, boundary: Boundary) -> int:
        self._full_bvol_stale = True
        handle = len(self._boundary_records)
        self._boundary_records.append(
            _BoundaryRecord(groups=boundary.interaction_groups)
        )
        if boundary.positions.size:
            self._write_boundary_particles(
                handle, boundary.positions, boundary.velocities
            )
        return handle

    def remove_fluid(self, handle: int):
        self._sync_fluid_mirrors()
        slots = np.where(self._fluid_slot_owner == handle)[0]
        self._release_fluid_slots(slots)
        self._fluid_records[handle].removed = True
        self._force_set = None

    def remove_boundary(self, handle: int):
        self._full_bvol_stale = True
        slots = np.where(self._boundary_slot_owner == handle)[0]
        if len(slots):
            bd = self.boundaries_state
            self.boundaries_state = bd.replace(
                alive=set_rows(bd.alive, self._index(slots), False)
            )
        self._boundary_alive[slots] = False
        self._boundary_slot_owner[slots] = -1
        self._boundary_records[handle].removed = True
        self._boundary_dirty = True

    def _index(self, slots):
        return torch.as_tensor(slots, dtype=torch.long, device=self.device)

    def _release_fluid_slots(self, slots: np.ndarray):
        if len(slots):
            fl = self.fluids_state
            self.fluids_state = fl.replace(
                alive=set_rows(fl.alive, self._index(slots), False)
            )
        self._fluid_alive[slots] = False
        self._fluid_slot_owner[slots] = -1

    def _write_fluid_particles(self, handle: int, positions, velocities=None):
        rec = self._fluid_records[handle]
        n = len(positions)
        slots = self._alloc_fluid_slots(n)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        vol = particle_volume(rec.particle_radius, self.dim)
        st = self.fluids_state
        pos = torch.as_tensor(positions, dtype=torch.float32,
                              device=self.device)
        vel = (
            torch.as_tensor(velocities, dtype=torch.float32,
                            device=self.device)
            if velocities is not None
            else torch.zeros_like(pos)
        )
        self.fluids_state = st.replace(
            positions=set_rows(st.positions, idx, pos),
            velocities=set_rows(st.velocities, idx, vel),
            volumes=set_rows(st.volumes, idx, vol),
            density0=set_rows(st.density0, idx, rec.density0),
            alive=set_rows(st.alive, idx, True),
            fluid_id=set_rows(st.fluid_id, idx, handle),
            memberships=set_rows(st.memberships, idx,
                                  rec.groups.memberships),
            filter=set_rows(st.filter, idx, rec.groups.filter),
        )
        self._fluid_alive[slots] = True
        self._fluid_slot_owner[slots] = handle
        return slots

    def _write_boundary_particles(self, handle: int, positions,
                                  velocities=None):
        rec = self._boundary_records[handle]
        n = len(positions)
        slots = self._alloc_boundary_slots(n)
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        st = self.boundaries_state
        pos = torch.as_tensor(positions, dtype=torch.float32,
                              device=self.device)
        vel = (
            torch.as_tensor(velocities, dtype=torch.float32,
                            device=self.device)
            if velocities is not None
            else torch.zeros_like(pos)
        )
        self.boundaries_state = st.replace(
            positions=set_rows(st.positions, idx, pos),
            velocities=set_rows(st.velocities, idx, vel),
            alive=set_rows(st.alive, idx, True),
            boundary_id=set_rows(st.boundary_id, idx, handle),
            memberships=set_rows(st.memberships, idx,
                                  rec.groups.memberships),
            filter=set_rows(st.filter, idx, rec.groups.filter),
        )
        self._boundary_alive[slots] = True
        self._boundary_slot_owner[slots] = handle
        self._boundary_dirty = True
        return slots

    # -- particle-level API (emitters / deletion, `fluid.rs:71-150`) -------

    def fluid_slots(self, handle: int) -> np.ndarray:
        self._sync_fluid_mirrors()
        return np.where(
            (self._fluid_slot_owner == handle) & self._fluid_alive
        )[0]

    def boundary_slots(self, handle: int) -> np.ndarray:
        return np.where(
            (self._boundary_slot_owner == handle) & self._boundary_alive
        )[0]

    def reserve_fluid_capacity(self, n: int):
        """Pre-grow the fluid arrays to hold at least ``n`` particles
        (emitter scenes, `faucet3.rs`, reserve their steady-state head
        count up front: ``emit_particles`` never grows the arrays)."""
        self._grow_fluids(int(n))

    def add_particles(self, handle: int, positions, velocities=None):
        """`Fluid::add_particles` (`fluid.rs:126-150`)."""
        self._sync_fluid_mirrors()
        slots = self._write_fluid_particles(handle, positions, velocities)
        if self._has_elasticity(handle):
            self._elasticity_dirty = True
        return slots

    def _sync_fluid_mirrors(self):
        """Refresh the host slot mirrors after device-side emission or
        deletion mutated the alive mask (one fetch, only when a host-side
        slot operation needs the free list)."""
        if not self._fluid_mirror_stale:
            return
        alive = self.fluids_state.alive.cpu().numpy()
        fid = self.fluids_state.fluid_id.cpu().numpy()
        self._fluid_alive = alive.copy()
        self._fluid_slot_owner = np.where(alive, fid, -1).astype(np.int64)
        self._fluid_mirror_stale = False

    def emit_particles(self, handle: int, positions, velocities=None):
        """Device-side `add_particles`: write a fixed emission template
        into free slots with no host round trip (the emitter pattern of
        `examples3d/faucet3.rs:69-105`). Capacity must be reserved up
        front (``reserve_fluid_capacity``); emissions beyond the free
        slot count are dropped. Host slot mirrors are refreshed lazily."""
        rec = self._fluid_records[handle]
        pos = torch.as_tensor(positions, dtype=torch.float32,
                              device=self.device)
        vel = (
            torch.as_tensor(velocities, dtype=torch.float32,
                            device=self.device)
            if velocities is not None
            else torch.zeros_like(pos)
        )
        self.fluids_state = _emit(
            self.fluids_state, pos, vel,
            particle_volume(rec.particle_radius, self.dim), rec.density0,
            handle, rec.groups.memberships, rec.groups.filter,
        )
        self._fluid_mirror_stale = True
        if self._has_elasticity(handle):
            self._elasticity_dirty = True

    def delete_where(self, handle: int, predicate):
        """Device-side predicate deletion: kill this fluid's particles
        where ``predicate(positions, velocities) -> bool mask`` holds,
        through the alive mask (the deletion half of the faucet emitter
        pattern)."""
        fl = self.fluids_state
        kill = (
            predicate(fl.positions, fl.velocities).to(torch.bool)
            & fl.alive
            & (fl.fluid_id == handle)
        )
        self.fluids_state = fl.replace(alive=fl.alive & ~kill)
        self._fluid_mirror_stale = True

    def delete_particles(self, handle: int, indices):
        """Delete particles by index within the fluid, immediately (the
        eager variant; see :meth:`delete_particle_at_next_timestep` for
        the reference's deferred semantics)."""
        slots = self.fluid_slots(handle)[np.asarray(indices)]
        self._release_fluid_slots(slots)

    def delete_particle_at_next_timestep(self, handle: int, index: int):
        """Mark a particle for removal at the start of the next step
        (`Fluid::delete_particle_at_next_timestep`, `fluid.rs:71-77`;
        applied by the step like `apply_particles_removal`,
        `liquid_world.rs:79-81`)."""
        slot = int(self.fluid_slots(handle)[int(index)])
        self._pending_deletions.add(slot)

    def num_deleted_particles(self, handle: int) -> int:
        """Particles of ``handle`` marked for deferred removal
        (`fluid.rs:79-82`)."""
        owner = self._fluid_slot_owner
        return sum(1 for s in self._pending_deletions if owner[s] == handle)

    def _apply_particles_removal(self):
        """Apply deferred deletions (`fluid.rs:88-98`)."""
        if self._pending_deletions:
            self._release_fluid_slots(
                np.fromiter(self._pending_deletions, np.int64)
            )
            self._pending_deletions.clear()

    def transform_fluid_by(self, handle: int, rotation=None, translation=None):
        """Apply an isometry to all particles of a fluid
        (`Fluid::transform_by`, `fluid.rs:166-168`). ``rotation`` is a
        ``[dim, dim]`` matrix (None = identity)."""
        self._transform_slots("fluids_state", self.fluid_slots(handle),
                              rotation, translation)

    def transform_boundary_by(self, handle: int, rotation=None,
                              translation=None):
        """Apply an isometry to all particles of a boundary
        (`Boundary::transform_by`, `boundary.rs:55-57`)."""
        self._transform_slots("boundaries_state", self.boundary_slots(handle),
                              rotation, translation)
        self._boundary_dirty = True

    def _transform_slots(self, attr, slots, rotation, translation):
        if not len(slots):
            return
        state = getattr(self, attr)
        idx = self._index(slots)
        pos = state.positions[idx]
        if rotation is not None:
            pos = pos @ torch.as_tensor(rotation, dtype=torch.float32,
                                        device=self.device).T
        if translation is not None:
            pos = pos + torch.as_tensor(translation, dtype=torch.float32,
                                        device=self.device)
        setattr(self, attr, state.replace(
            positions=set_rows(state.positions, idx, pos)))

    def fluid_positions(self, handle: int) -> np.ndarray:
        return self.fluids_state.positions.cpu().numpy()[
            self.fluid_slots(handle)
        ]

    def fluid_velocities(self, handle: int) -> np.ndarray:
        return self.fluids_state.velocities.cpu().numpy()[
            self.fluid_slots(handle)
        ]

    def boundary_positions(self, handle: int) -> np.ndarray:
        return self.boundaries_state.positions.cpu().numpy()[
            self.boundary_slots(handle)
        ]

    def boundary_forces(self, handle: int) -> np.ndarray:
        """Accumulated force feedback of a boundary (`boundary.rs:62-67`)."""
        return self.boundaries_state.forces.cpu().numpy()[
            self.boundary_slots(handle)
        ]

    def set_boundary_particles(self, handle: int, positions, velocities=None):
        """Replace all particles of a boundary (used by coupling to
        re-sample moving colliders each substep): in place when the count
        is unchanged, else the old slots are released and new ones
        allocated."""
        self._boundary_dirty = True
        slots = np.where(self._boundary_slot_owner == handle)[0]
        n_new = len(positions)
        if len(slots) == n_new:
            idx = self._index(slots)
            st = self.boundaries_state
            pos = torch.as_tensor(np.asarray(positions, np.float32),
                                  device=self.device)
            vel = (
                torch.as_tensor(np.asarray(velocities, np.float32),
                                device=self.device)
                if velocities is not None
                else torch.zeros_like(pos)
            )
            self.boundaries_state = st.replace(
                positions=set_rows(st.positions, idx, pos),
                velocities=set_rows(st.velocities, idx, vel),
                alive=set_rows(st.alive, idx, True),
            )
            self._boundary_alive[slots] = True
        else:
            if len(slots):
                bd = self.boundaries_state
                self.boundaries_state = bd.replace(
                    alive=set_rows(bd.alive, self._index(slots), False)
                )
                self._boundary_alive[slots] = False
                self._boundary_slot_owner[slots] = -1
            if n_new:
                self._write_boundary_particles(handle, positions, velocities)

    def set_boundaries_bulk(self, updates):
        """Replace the particles of several boundaries in ONE update
        (coupling: the per-substep work stays constant in the collider
        count). ``updates``: {handle: (positions, velocities|None)}.
        Handles whose particle count changed go through
        :meth:`set_boundary_particles`."""
        idx_parts, pos_parts, vel_parts = [], [], []
        leftovers = {}
        for handle, (pts, vels) in updates.items():
            pts = np.asarray(pts, np.float32)
            slots = np.where(self._boundary_slot_owner == handle)[0]
            if len(slots) == len(pts):
                idx_parts.append(slots)
                pos_parts.append(pts)
                vel_parts.append(
                    np.asarray(vels, np.float32)
                    if vels is not None else np.zeros_like(pts)
                )
            else:
                leftovers[handle] = (pts, vels)
        if idx_parts:
            idx_np = np.concatenate(idx_parts)
            idx = self._index(idx_np)
            st = self.boundaries_state
            self.boundaries_state = st.replace(
                positions=set_rows(st.positions, idx, torch.as_tensor(
                    np.concatenate(pos_parts), device=self.device)),
                velocities=set_rows(st.velocities, idx, torch.as_tensor(
                    np.concatenate(vel_parts), device=self.device)),
                alive=set_rows(st.alive, idx, True),
            )
            self._boundary_alive[idx_np] = True
            self._boundary_dirty = True
        for handle, (pts, vels) in leftovers.items():
            self.set_boundary_particles(handle, pts, vels)

    # -- force-set assembly -------------------------------------------------

    def _has_elasticity(self, handle: int) -> bool:
        return any(
            isinstance(f, force_specs.Becker2009Elasticity)
            for f in self._fluid_records[handle].nonpressure_forces
        )

    def _build_force_set(self) -> ForceSet:
        """Merge the fluids' force instances into one configuration per
        force type, one coefficient per fluid; each custom force is
        wrapped to act on its own fluid only (``salva_tpu.world``'s
        ``_build_force_set``)."""
        nf = self.num_fluids
        by_type: Dict[type, Dict[int, object]] = {}
        custom: List = []
        for fid, rec in enumerate(self._fluid_records):
            if rec.removed:
                continue
            for inst in rec.nonpressure_forces:
                if isinstance(inst, CustomForce):
                    flags = tuple(1 if i == fid else 0 for i in range(nf))
                    custom.append(MaskedCustomForce(inst, flags))
                else:
                    by_type.setdefault(type(inst), {})[fid] = inst

        merged: List = list(custom)
        for ftype, inst in by_type.items():
            def col(attr, default=0.0):
                return merge_per_fluid(inst, nf, attr, default)

            if ftype is force_specs.XSPHViscosity:
                merged.append(
                    XSPHViscosityForce(
                        col("fluid_viscosity_coefficient"),
                        col("boundary_viscosity_coefficient"),
                    )
                )
            elif ftype is force_specs.ArtificialViscosity:
                merged.append(
                    ArtificialViscosityForce(
                        col("fluid_viscosity_coefficient"),
                        col("boundary_viscosity_coefficient"),
                        col("alpha", 1.0),
                        col("beta", 0.0),
                        col("speed_of_sound", 10.0),
                    )
                )
            elif ftype is force_specs.DFSPHViscosity:
                any_inst = next(iter(inst.values()))
                merged.append(
                    DFSPHViscosityForce(
                        col("viscosity_coefficient"),
                        tuple(1 if i in inst else 0 for i in range(nf)),
                        min_viscosity_iter=any_inst.min_viscosity_iter,
                        max_viscosity_iter=any_inst.max_viscosity_iter,
                        max_viscosity_error=any_inst.max_viscosity_error,
                    )
                )
            elif ftype is force_specs.Akinci2013SurfaceTension:
                merged.append(
                    Akinci2013SurfaceTensionForce(
                        col("fluid_tension_coefficient"),
                        col("boundary_adhesion_coefficient"),
                    )
                )
            elif ftype is force_specs.He2014SurfaceTension:
                merged.append(
                    He2014SurfaceTensionForce(
                        col("fluid_tension_coefficient"),
                        col("boundary_tension_coefficient"),
                    )
                )
            elif ftype is force_specs.WCSPHSurfaceTension:
                merged.append(
                    WCSPHSurfaceTensionForce(
                        col("fluid_tension_coefficient"),
                        col("boundary_tension_coefficient"),
                    )
                )
            elif ftype is force_specs.Becker2009Elasticity:
                coeffs = [
                    elasticity_coefficients(inst[i].young_modulus,
                                            inst[i].poisson_ratio)
                    if i in inst else (0.0, 0.0, 0.0)
                    for i in range(nf)
                ]
                merged.append(
                    Becker2009ElasticityForce(
                        tuple(c[0] for c in coeffs),
                        tuple(c[1] for c in coeffs),
                        tuple(c[2] for c in coeffs),
                        tuple(
                            1 if i in inst and inst[i].nonlinear_strain else 0
                            for i in range(nf)
                        ),
                        tuple(1 if i in inst else 0 for i in range(nf)),
                    )
                )
        return ForceSet(tuple(merged))

    def _rebuild_elasticity_state(self):
        """Capture the rest state of every elasticity-carrying fluid
        (`becker2009_elasticity.rs:84-113`): a same-fluid neighbour table
        of the current positions from the gather search (zero group masks
        fail every group test, so only same-model pairs pass)."""
        self._elasticity_dirty = False
        elastic = [fid for fid in range(self.num_fluids)
                   if not self._fluid_records[fid].removed
                   and self._has_elasticity(fid)]
        if not elastic:
            self._elasticity_state = None
            return
        fl = self.fluids_state
        is_elastic = torch.isin(
            fl.fluid_id,
            torch.tensor(elastic, dtype=torch.int32, device=self.device),
        ) & fl.alive
        h, dim = self.h, self.dim
        nbcfg = self.sim.neighbors
        zero_groups = GroupInfo(torch.zeros_like(fl.memberships),
                                torch.zeros_like(fl.filter), fl.fluid_id)
        # Binned by a true division, as the JAX package's eager rest
        # state is (its step's search multiplies by the reciprocal).
        grid = build_grid(fl.positions, is_elastic, h, dim, divide=True)
        nl = find_neighbors(
            fl.positions, is_elastic, zero_groups,
            grid, fl.positions, is_elastic, zero_groups,
            h, dim, nbcfg.max_neighbors, nbcfg.max_candidates,
            same_model_always=True, query_chunk=nbcfg.query_chunk,
            divide=True,
        )
        contacts = evaluate_contacts(
            fl.positions, fl.positions, nl, h, dim,
            w_fn=get_kernel(self.sim.kernel_density)[0],
            dw_fn=get_kernel(self.sim.kernel_gradient)[1],
        )
        self._elasticity_state = build_elasticity_state(fl, contacts,
                                                        is_elastic)

    # -- stepping ----------------------------------------------------------

    def _prepare(self):
        if self._force_set is None:
            self._force_set = self._build_force_set()
        if self._elasticity_dirty:
            self._rebuild_elasticity_state()
        expected = solver_state_shape(
            self.solver_config, self.fluids_state.capacity, self.dim
        )
        st = self._solver_state
        if st is None or tuple(st.shape) != expected:
            fresh = init_solver_state(
                self.solver_config, self.fluids_state.capacity, self.dim,
                self.device,
            )
            if (
                st is not None
                and st.ndim == 2
                and len(expected) == 2
                and st.shape[0] == expected[0]
                and st.shape[1] < expected[1]
            ):
                # Legacy DFSPH state (velocity changes only, as older
                # checkpoints hold it): keep it and zero the warm-start
                # stiffness columns.
                fresh[:, : st.shape[1]] = st
            self._solver_state = fresh

    def step(self, dt: float, gravity):
        """Advance the simulation by dt seconds (`liquid_world.rs:62-64`)."""
        self.step_with_coupling(dt, gravity, None)

    def _effective_sim(self) -> SimConfig:
        """Resolve the layout for the next step. The brute all-pairs tier
        (``_brute_active``) takes per-cyclic-cell caps from the capacities
        and no grid machinery. The dense layout auto-tunes uniform
        particles, cap tier, grid window and sparse fb table; with
        ``layout="auto"`` a grid far larger than the particle capacity
        resolves to the gather layout, as does a world without a domain
        (and, in ``step._dense_config``, one carrying a force with no
        dense form)."""
        sim = self.sim
        if sim.domain is not None and self._brute_active():
            uniform = self._uniform_particles()
            if sim.uniform_particles != uniform:
                sim = sim.replace(uniform_particles=uniform)
            cells = int(sim.brute_cells)
            return sim.replace(
                layout="brute",
                dense_cap=-(-self.fluids_state.capacity // cells),
                dense_cap_boundary=max(
                    1, -(-self.boundaries_state.capacity // cells)
                ),
                use_pallas=False,
                fitted_dims=None,
                dense_spill_columns=None,
                dense_fb_columns=None,
            )
        if sim.domain is not None:
            uniform = self._uniform_particles()
            if sim.uniform_particles != uniform:
                sim = sim.replace(uniform_particles=uniform)
            auto_f = self._dense_cap_request is None
            if (auto_f and self._auto_spill is not None
                    and not self._spill_supported()):
                # A configuration changed after the tier resolved (the
                # half stencil turned off, say) must not reach DenseCtx
                # with a stale spill table, and a tier resolved for spill
                # (cap 12) must not run without its table (it would shed
                # more contacts than the 16 tier), so the whole tier
                # resolves again.
                self._auto_caps = None
                self._auto_spill = None
            caps = self._resolved_dense_caps()
            if (sim.dense_cap, sim.dense_cap_boundary) != caps:
                sim = sim.replace(
                    dense_cap=caps[0], dense_cap_boundary=caps[1]
                )
            if auto_f:
                # The spill table goes with the auto cap tier (an explicit
                # cap request leaves dense_spill_columns to the caller).
                spill = self._auto_spill
                if sim.dense_spill_columns != spill:
                    sim = sim.replace(dense_spill_columns=spill)
                k = self._auto_spill_k
                if spill is not None and k and sim.dense_spill_k != k:
                    sim = sim.replace(dense_spill_k=k)
            if self._fit_grid and not self._initial_fit_done:
                self._initial_fit()
            if sim.fitted_dims != self._fitted_dims:
                sim = sim.replace(fitted_dims=self._fitted_dims)
            fbc = self._resolved_fb_columns(sim)
            if sim.dense_fb_columns != fbc:
                sim = sim.replace(dense_fb_columns=fbc)
        if sim.layout != "auto" or sim.domain is None:
            return sim
        mins, maxs = sim.domain
        cells = 1
        for lo, hi in zip(mins, maxs):
            cells *= max(int(np.ceil((hi - lo) / sim.h)) + 4, 3)
        if self.device.type == "cpu":
            slot_limit = 64 * self.fluids_state.capacity
        else:
            slot_limit = max(64 * self.fluids_state.capacity, 30_000_000)
        if cells * sim.dense_cap > slot_limit:
            return sim.replace(layout="gather")
        return sim

    # -- fluid-tracking grid window (config.fitted_dims) --------------------

    def _full_grid_dims(self) -> np.ndarray:
        """The full-domain grid dims (same formula as spec_for_aabb)."""
        h = self.sim.h
        mins = np.asarray(self.sim.domain[0], np.float64)
        maxs = np.asarray(self.sim.domain[1], np.float64)
        origin = mins - 2 * h
        return np.maximum(np.ceil((maxs - origin) / h).astype(int) + 2, 3)

    def _initial_fit(self):
        """First window sizing from the host-visible state (pre-step)."""
        self._initial_fit_done = True
        fl = self.fluids_state
        alive = counters.fetch("initial_fit", fl.alive).numpy()
        pos = counters.fetch("initial_fit", fl.positions).numpy()[alive]
        if len(pos) == 0:
            return
        vel = counters.fetch("initial_fit", fl.velocities).numpy()[alive]
        vmax = float(np.sqrt((vel * vel).sum(axis=-1).max())) if len(vel) else 0.0
        self._refit_dims(pos.min(axis=0), pos.max(axis=0), vmax)

    def _maybe_refit_grid(self):
        """Resize the window from the extent diagnostics (runs on the
        overflow-check cadence)."""
        if not self._fit_grid or self.sim.domain is None:
            return
        if self._brute_active():
            return  # no grid window on the all-pairs tier
        d = self.last_diagnostics
        if d is None or d.fluid_min is None:
            return
        lo = counters.fetch("overflow_check", d.fluid_min).numpy()
        hi = counters.fetch("overflow_check", d.fluid_max).numpy()
        lo, hi = lo.astype(np.float64), hi.astype(np.float64)
        if not np.isfinite(lo).all() or (hi < lo).any():
            return  # no live fluid
        vmax = (float(counters.fetch("overflow_check", d.max_speed))
                if d.max_speed is not None else 0.0)
        self._refit_dims(lo, hi, vmax)

    def _refit_dims(self, lo, hi, vmax):
        """Quantized, hysteretic window-size update (see
        ``salva_tpu.world.LiquidWorld._refit_dims``): the window holds the
        fluid extent plus 2 low-side cells, a vmax-scaled high-side slack
        and rounding to 4-cell steps; growth overshoots x1.3 per axis that
        ran out of room; ``reserve_grid_window`` sets a floor."""
        h = self.sim.h
        full = self._full_grid_dims()
        extent = np.ceil((np.asarray(hi) - np.asarray(lo)) / h).astype(int)
        grow = 1 + int(
            np.ceil(2.0 * vmax * self.overflow_check_interval
                    * self._last_dt / h)
        )
        need = extent + 1  # fluid cells
        dims = need + 4 + min(grow, 16)  # low margin + high slack
        dims = (np.ceil(dims / 4.0) * 4).astype(int)
        dims = np.minimum(np.maximum(dims, 8), full)
        if self._fit_floor_dims is not None:
            dims = np.minimum(np.maximum(dims, self._fit_floor_dims), full)

        cur = self._fitted_dims
        growing = False
        if cur is not None:
            cur = np.asarray(cur)
            ok = (cur >= need + 4).all()  # still room for margins
            not_bloated = float(np.prod(cur)) <= 1.7 * float(np.prod(dims))
            if ok and not_bloated:
                return
            growing = not ok
        if growing:
            grow_axis = cur < need + 4
            target = np.where(
                grow_axis,
                np.ceil(cur * 1.3 / 4.0) * 4,
                np.where(dims * 1.3 <= cur, dims, cur),
            ).astype(int)
            dims = np.minimum(np.maximum(dims, target), full)
        if float(np.prod(dims)) >= 0.85 * float(np.prod(full)):
            new = None  # window ~= domain: not worth it
        else:
            new = tuple(int(v) for v in dims)
        if new != self._fitted_dims:
            self._fitted_dims = new
            self.grid_refit_count += 1

    def reserve_grid_window(self, mins, maxs):
        """Declare the extent the fluid is expected to reach, sizing the
        fitted grid window to cover it up front."""
        if not self._fit_grid or self.sim.domain is None:
            return
        h = self.sim.h
        extent = np.ceil(
            (np.asarray(maxs, np.float64) - np.asarray(mins, np.float64)) / h
        ).astype(int)
        dims = extent + 1 + 4 + 4
        dims = (np.ceil(dims / 4.0) * 4).astype(int)
        self._fit_floor_dims = np.minimum(
            np.maximum(dims, 8), self._full_grid_dims()
        )
        if self._initial_fit_done:
            self._refit_dims(mins, maxs, 0.0)

    def _refresh_full_boundary_volumes(self):
        """One full-extent boundary-boundary volume pass (V_b = 1 / sum_k
        W_bk over all boundary pairs within h that pass the interaction
        groups, `dfsph_solver.rs:72-96`), so wall particles OUTSIDE the
        fitted window carry correct cached volumes. Runs once per
        boundary-set change: the boundaries bin over the occupied cells of
        the whole domain, sized from their measured occupancy."""
        bd = self.boundaries_state
        alive = bd.alive
        if not bool(counters.fetch("full_boundary_volumes", alive.any())):
            return
        h, dim = self.h, self.dim
        spec = dg.spec_for_aabb(self.sim.domain[0], self.sim.domain[1], h,
                                cap=1)
        cell, _ = dg.cell_of(spec, bd.positions)
        occ = torch.bincount(cell[alive].long(), minlength=spec.num_cells)
        spec = spec.replace(cap=int(counters.fetch("full_boundary_volumes",
                                                   occ.max())))
        n_active = int(counters.fetch("full_boundary_volumes",
                                      (occ > 0).sum()))
        binb = dg.bin_particles_active(spec, n_active, bd.positions, alive)
        sb = dg.ActiveSpec(n_active + 1, spec.cap)
        P = dg.to_grid(sb, binb, bd.positions, fill=dg.POS_SENTINEL)
        mem = dg.to_grid(sb, binb, bd.memberships)
        flt = dg.to_grid(sb, binb, bd.filter)
        bid = dg.to_grid(sb, binb, bd.boundary_id, fill=-1)
        nbt = dg.neighbor_table(
            spec, binb.active_cells, binb.cell_to_active
        ).long()
        w_fn = get_kernel(self.sim.kernel_density)[0]

        def body(acc, dpos, r2, within, j):
            ok = (((mem[:, None, :] & j["flt"][None]) != 0)
                  & ((j["mem"][None] & flt[:, None, :]) != 0))
            ok = ok | (bid[:, None, :] == j["id"][None])
            w = w_fn(torch.sqrt(r2), h, dim)
            return acc + torch.sum(torch.where(within & ok, w, 0.0), dim=1)

        wsum = fold_pairs(
            dg.neighbor_offsets(dim), h, dim, P, binb.mask, P, binb.mask,
            lambda arr, o: arr[..., nbt[:, o]],
            {"mem": mem, "flt": flt, "id": bid}, body,
            torch.zeros_like(binb.mask),
        )
        wsum = dg.from_grid(sb, binb, wsum, 0.0)
        vol = torch.where(
            alive & (wsum > 0.0),
            1.0 / torch.where(wsum > 0.0, wsum, 1.0),
            0.0,
        )
        self.boundaries_state = bd.replace(volumes=vol)

    def _cell_counts(self, positions, alive):
        """Per-occupied-cell particle counts at the current state
        (host-side; only when the auto cap sizing is (re)computed). None
        when no live particles."""
        pos = counters.fetch("cell_counts", positions).numpy()
        pos = pos[counters.fetch("cell_counts", alive).numpy()]
        if len(pos) == 0:
            return None
        h = self.sim.h
        mins = np.asarray(self.sim.domain[0], np.float64)
        # Same origin rule as geometry.dense_grid.spec_for_aabb.
        origin = mins - 2 * h
        c = np.floor((pos - origin) / h).astype(np.int64)
        c -= c.min(axis=0)
        dims = c.max(axis=0) + 1
        key = c[:, 0]
        for axis in range(1, self.dim):
            key = key * dims[axis] + c[:, axis]
        _, counts = np.unique(key, return_counts=True)
        return counts

    def _max_cell_occupancy(self, positions, alive) -> int:
        counts = self._cell_counts(positions, alive)
        return 0 if counts is None else int(counts.max())

    def _resolved_dense_caps(self):
        """(dense_cap, dense_cap_boundary) with ``None`` requests sized
        from measured occupancy: fluid tier 8 when occupancy leaves
        headroom (<= 5), else 12 with an auto-sized spill table when the
        spill structure is opted in and supported (``_spill_supported``),
        else 16 (impact fronts compress cells past the resting 8);
        boundary cap the next multiple of 8 above occupancy + 2. Cached
        until a capacity changes or an overflow bump. These are the JAX
        package's TPU-derived tiers, kept for parity until the GPU
        benchmark measures its own."""
        req_f = self._dense_cap_request
        req_b = self._dense_cap_boundary_request
        if req_f is not None and req_b is not None:
            return (req_f, req_b)
        cap_key = (self.fluids_state.capacity, self.boundaries_state.capacity)
        if self._auto_caps is None or self._auto_caps_capacity != cap_key:
            occ_f = self._max_cell_occupancy(
                self.fluids_state.positions, self.fluids_state.alive
            )
            occ_b = self._max_cell_occupancy(
                self.boundaries_state.positions, self.boundaries_state.alive
            )
            if occ_f <= 5:
                cap_f = 8
                self._auto_spill = None
            elif self._spill_supported():
                cap_f = 12
                self._auto_spill = self._sized_spill_columns(cap_f)
            else:
                cap_f = 16
                self._auto_spill = None
            cap_b = max(8, -(-(occ_b + 2) // 8) * 8)
            self._auto_caps = (cap_f, cap_b)
            self._auto_caps_capacity = cap_key
        auto_f, auto_b = self._auto_caps
        return (
            req_f if req_f is not None else auto_f,
            req_b if req_b is not None else auto_b,
        )

    def _brute_active(self) -> bool:
        """Whether steps run the brute all-pairs tier (layout="brute",
        or "auto" on a CUDA world with capacities under the brute
        ceilings, as the reference does on an accelerator; a CPU world
        keeps the grid). It needs the dense machinery: with a force that
        has no dense form, "auto" stays on the gather layout."""
        sim = self.sim
        if sim.domain is None or sim.layout not in ("auto", "brute"):
            return False
        if sim.layout == "auto":
            if self.device.type == "cpu":
                return False
            if (
                self.fluids_state.capacity > sim.brute_max_particles
                or self.boundaries_state.capacity > sim.brute_max_boundary
            ):
                return False
        if self.solver_config.kind not in ("dfsph", "iisph"):
            return False
        from .solver.forces_dense import to_dense_forces

        if self._force_set is None:
            self._force_set = self._build_force_set()
        return to_dense_forces(self._force_set) is not None

    def _spill_supported(self) -> bool:
        """Whether the auto tier may take 12 + spill: only when opted in
        (``dense_spill_auto``; off by default, as in the JAX package, where
        it ran 2.29x slower than the plain 16 tier on the TPU), on the
        single-device grid with the half stencil and the sparse boundary
        binning, without frozen pairs, and with particle-wise forces only
        (the dense pair forces do not know the extended layout). The
        reference also excludes its Pallas kernels, which this package
        does not have."""
        sim = self.sim
        if not sim.dense_spill_auto:
            return False
        if sim.dense_compact or not sim.dense_sparse_boundary:
            return False
        if not sim.dense_half_stencil or sim.dense_frozen_pairs:
            return False
        from .solver.forces_dense import ParticleWiseForce, to_dense_forces

        if self._force_set is None:
            self._force_set = self._build_force_set()
        dense = to_dense_forces(self._force_set)
        if dense is None:
            return False  # the gather layout anyway
        return all(isinstance(f, ParticleWiseForce) for f in dense)

    def _sized_spill_columns(self, cap_f: int) -> int:
        """The spill table's size: 4x the over-cap cells of the current
        state, at least max(512, the occupied cells / 64 rounded up to
        512) (a fresh lattice has none; impact compression scales with
        the front's area), quantized to 512 so occupancy drift does not
        resize it; the overflow path doubles it when it fills."""
        counts = self._cell_counts(
            self.fluids_state.positions, self.fluids_state.alive
        )
        measured = int((counts > cap_f).sum()) if counts is not None else 0
        occupied = 0 if counts is None else len(counts)
        floor = max(512, -(-occupied // 64 // 512) * 512)
        return max(floor, -(-4 * measured // 512) * 512)

    def _resolved_fb_columns(self, sim: SimConfig) -> Optional[int]:
        """Static boundary-adjacency table size for the sparse fb hoist
        (config.dense_fb_columns): 1.5x the measured dilated
        boundary-occupied cell count, quantized to 512 columns. None
        disables (no boundaries, or no sparse boundary binning)."""
        if sim.dense_compact or not sim.dense_sparse_boundary:
            return None
        bd = self.boundaries_state
        cap_key = bd.capacity
        if self._fb_cols_cache is not None and (
            self._fb_cols_cache[0] == cap_key
        ):
            return self._fb_cols_cache[1]
        alive = counters.fetch("fb_columns", bd.alive).numpy()
        if not alive.any():
            self._fb_cols_cache = (cap_key, None)
            return None
        pos = counters.fetch("fb_columns", bd.positions).numpy()[alive]
        h = sim.h
        origin = np.asarray(sim.domain[0], np.float64) - 2 * h
        c = np.floor((pos - origin) / h).astype(np.int64)
        cells = np.unique(c, axis=0)
        offs = np.array(
            np.meshgrid(*([[-1, 0, 1]] * self.dim), indexing="ij")
        ).reshape(self.dim, -1).T
        dilated = (cells[:, None, :] + offs[None, :, :]).reshape(-1, self.dim)
        n = len(np.unique(dilated, axis=0))
        cols = int(-(-(n * 3) // (2 * 512)) * 512)
        self._fb_cols_cache = (cap_key, cols)
        return cols

    def _uniform_particles(self):
        """(handle, mass, density0) when all live particles provably share
        them (the world holds one fluid that is not removed), else None."""
        live = [(h, r) for h, r in enumerate(self._fluid_records)
                if not r.removed]
        if len(live) != 1:
            return None
        handle, rec = live[0]
        m0 = particle_volume(rec.particle_radius, self.dim) * rec.density0
        return (int(handle), float(m0), float(rec.density0))

    def _boundary_volume_mode(self, sim: SimConfig, coupling) -> SimConfig:
        """Skip the boundary-volume pair pass on steps where no boundary
        changed (volumes depend only on boundary positions)."""
        if sim.domain is None or sim.layout == "gather":
            return sim
        recompute = self._boundary_dirty or coupling is not None
        if sim.recompute_boundary_volumes != recompute:
            sim = sim.replace(recompute_boundary_volumes=recompute)
        return sim

    def step_with_coupling(self, dt: float, gravity, coupling):
        """Advance with two-way rigid-body coupling
        (`liquid_world.rs:67-158`). ``coupling`` follows the
        `CouplingManager` protocol (`coupling/base.py`) or is None: its
        ``update_boundaries`` runs before each substep and its
        ``transmit_forces`` after, timed into
        ``counters.cd.boundary_update_time`` and
        ``counters.coupling_transmit_time``. The step is the ``world.step``
        span; its stages are spans too (``counters.py``)."""
        c = self.counters
        c.reset()
        with counters.span("world.step", c.step_time,
                           step=self._steps_taken):
            self._advance(dt, gravity, coupling)
        c.finish_step(self.device, self.last_diagnostics)

    def _advance(self, dt: float, gravity, coupling):
        c = self.counters
        with counters.span("world.prepare"):
            self._last_dt = float(dt)
            if (
                self._fit_grid
                and self._initial_fit_done
                and self._steps_taken == 0
                and self._fitted_dims is not None
            ):
                # A pre-step fit sized the window's velocity slack with the
                # default dt; with the real dt now known, redo the fit.
                self._fitted_dims = None
                self._initial_fit()
            self._apply_particles_removal()
            self._prepare()
            gravity = torch.as_tensor(gravity, dtype=torch.float32,
                                      device=self.device)
            num_fluids = max(self.num_fluids, 1)
            sim_eff = self._boundary_volume_mode(self._effective_sim(),
                                                 coupling)
            if sim_eff.fitted_dims is not None and self._full_bvol_stale:
                self._refresh_full_boundary_volumes()
                self._full_bvol_stale = False
            # Building the step is cheap (closures over the static config).
            step_fn = build_step_fn(sim_eff, self.solver_config,
                                    self._force_set, num_fluids)

        tm = self.timestep_manager
        tm.reset(dt)
        # The CFL bound (`timestep_manager.rs:36-46`) uses the particles'
        # accelerations; they are folded inside the substep here, so
        # a_i = (v - v_prev) / dt is recovered from the previous substep's
        # velocity change (slots never move inside the loop), and gravity
        # stands in on a step's first substep. One scalar device-to-host
        # fetch a substep, only when adaptive.
        prev_vel = self.fluids_state.velocities
        inv_prev_dt = 0.0
        while not tm.is_done():
            vmax = 0.0
            if tm.adaptive:
                fl = self.fluids_state
                vmax = float(counters.fetch("cfl", _cfl_vmax(
                    fl.velocities, prev_vel, fl.alive, gravity, inv_prev_dt,
                    tm.remaining_time)))
                prev_vel = fl.velocities
            sub_dt = tm.advance(vmax)
            inv_prev_dt = 1.0 / sub_dt if sub_dt > 0.0 else 0.0
            if coupling is not None:
                with counters.span("coupling.update_boundaries",
                                   c.cd.boundary_update_time,
                                   substep=c.nsubsteps):
                    coupling.update_boundaries(self, sub_dt)
            with counters.span("world.substep", c.dispatch_time,
                               substep=c.nsubsteps):
                (
                    self.fluids_state,
                    self.boundaries_state,
                    self._solver_state,
                    self.last_diagnostics,
                ) = step_fn(
                    self.fluids_state,
                    self.boundaries_state,
                    self._solver_state,
                    self._elasticity_state,
                    sub_dt,
                    gravity,
                )
            if coupling is not None:
                with counters.span("coupling.transmit_forces",
                                   c.coupling_transmit_time,
                                   substep=c.nsubsteps):
                    coupling.transmit_forces(self, sub_dt)
            c.nsubsteps += 1

        # Coupled boundaries move every substep: their volumes stay due.
        if coupling is None:
            self._boundary_dirty = False
        self._steps_taken += 1
        if self.debug_checks:
            with counters.span("world.overflow_check"):
                self._run_debug_checks()
                self._maybe_refit_grid()
        elif self.warn_overflow and (
            self._steps_taken == 1
            or self._steps_taken % max(self.overflow_check_interval, 1) == 0
            or self._overflow_alert > 0
        ):
            with counters.span("world.overflow_check"):
                self._overflow_alert = max(self._overflow_alert - 1, 0)
                refits_before = self.grid_refit_count
                self._warn_on_overflow()
                self._maybe_refit_grid()
                # Window-escape latency: when a check sees clamped
                # particles AND the refit just resized, keep checking every
                # step until the window stops moving.
                d = self.last_diagnostics
                if (
                    self.grid_refit_count != refits_before
                    and d is not None
                    and int(counters.fetch("overflow_check",
                                           d.candidate_overflow)) > 0
                ):
                    self._overflow_alert = max(self.overflow_check_interval,
                                               1)

    def _warn_on_overflow(self):
        """Capacity overflow silently drops contacts, so it must be loud
        even without ``debug_checks``; the auto cap tier self-heals."""
        d = self.last_diagnostics
        if d is None:
            return
        n_over = int(counters.fetch("overflow_check", d.neighbor_overflow))
        c_over = int(counters.fetch("overflow_check", d.candidate_overflow))
        if n_over > 0 and self._bump_auto_dense_cap():
            warnings.warn(
                f"neighbor capacity overflow: {n_over} entries dropped — "
                "auto-grew the dense cap for subsequent steps "
                "(transient compression exceeded the measured tier)"
            )
        elif n_over > 0:
            warnings.warn(
                f"neighbor capacity overflow: {n_over} entries dropped — "
                "physics degraded; raise dense_cap"
            )
        if c_over > 0:
            warnings.warn(
                f"candidate window / domain overflow: {c_over} (particles "
                "clamped); enlarge the domain"
            )

    def _run_debug_checks(self):
        """Failure detection (SURVEY.md §5.3): warn on every capacity
        overflow (growing the auto cap tier), raise on non-finite live
        positions, the structured equivalent of the reference's asserts
        and clamps (`dfsph_solver.rs:92,662`)."""
        d = self.last_diagnostics
        if d is not None:
            n_over = int(counters.fetch("overflow_check",
                                        d.neighbor_overflow))
            if n_over > 0:
                bumped = self._bump_auto_dense_cap()
                warnings.warn(
                    f"neighbor capacity overflow: {n_over}"
                    " entries dropped — "
                    + ("auto-grew the dense cap/spill sizing for "
                       "subsequent steps" if bumped else
                       "physics degraded; raise max_neighbors / dense_cap")
                )
            c_over = int(counters.fetch("overflow_check",
                                        d.candidate_overflow))
            if c_over > 0:
                warnings.warn(
                    "candidate window / domain overflow: "
                    f"{c_over} (particles clamped or candidates truncated)"
                )
        fl = self.fluids_state
        bad = ~torch.isfinite(fl.positions).all(dim=-1) & fl.alive
        if bool(counters.fetch("overflow_check", bad.any())):
            raise FloatingPointError(
                "non-finite fluid positions after step (instability: reduce "
                "dt or check force coefficients)"
            )

    def _bump_auto_dense_cap(self) -> bool:
        """Self-healing for the auto cap and spill sizing, in order:

        - a condensed-K overflow on a spill tier: widen ``dense_spill_k``
          toward 3^dim (where it holds a column's whole neighborhood), or,
          saturated, leave for the plain 16 tier;
        - a spill table overflow (cells or adjacency columns beyond the
          tables): double the spill table, up to 2^20;
        - rank overflow: the fluid tier to 12 + spill (when supported and
          below 12), else to 16, then in steps of 8 up to 48 (beyond that
          the pile-up is pathological, not a fluid state).

        Returns True when a change was applied."""
        if self._dense_cap_request is not None:
            return False
        if self.sim.domain is None or self._auto_caps is None:
            return False
        cap_f, cap_b = self._auto_caps
        d = self.last_diagnostics
        sp_over = sp_k_over = 0
        if d is not None and d.spill_overflow is not None:
            sp_over = int(counters.fetch("overflow_check", d.spill_overflow))
        if d is not None and d.spill_k_overflow is not None:
            sp_k_over = int(counters.fetch("overflow_check",
                                           d.spill_k_overflow))
        if self._auto_spill and sp_k_over > 0:
            n_off = 3 ** self.dim
            cur_k = self._auto_spill_k or self.sim.dense_spill_k
            if cur_k < n_off:
                self._auto_spill_k = min(2 * cur_k, n_off)
            else:
                self._auto_caps = (16, cap_b)
                self._auto_spill = None
            self.grid_refit_count += 1
            return True
        if self._auto_spill and sp_over > 0:
            grown = min(2 * self._auto_spill, 1 << 20)
            if grown == self._auto_spill:
                return False  # saturated: report it unhealed
            self._auto_spill = grown
            self.grid_refit_count += 1
            return True
        if cap_f >= 48:
            return False
        if cap_f < 12 and self._spill_supported():
            self._auto_caps = (12, cap_b)
            self._auto_spill = self._sized_spill_columns(12)
        elif cap_f < 16:
            self._auto_caps = (16, cap_b)
        else:
            self._auto_caps = (cap_f + 8, cap_b)
        self.grid_refit_count += 1
        return True

    # -- ordering / queries ------------------------------------------------

    def z_sort(self):
        """Reorder the fluid slots in Morton order for gather locality
        (`Fluid::z_sort`, `fluid.rs:153-163`; dead slots sort last),
        carrying the host slot mirrors, the solver state, the elasticity
        rest state (``rest_j`` through the inverse permutation) and the
        pending deletions along. The cells divide by ``h`` as the JAX
        package's eager ``z_sort`` does (``geometry.grid.cell_coords``).
        Returns the permutation: slot ``i`` now holds what slot
        ``perm[i]`` held."""
        self._sync_fluid_mirrors()
        fl = self.fluids_state
        keys = morton_key(cell_coords(fl.positions, self.h), self.dim)
        keys = torch.where(fl.alive, keys, DEAD_KEY)
        perm = torch.argsort(keys, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(len(perm), device=perm.device)
        perm_np = perm.cpu().numpy()

        self.fluids_state = fl.replace(**{
            f.name: getattr(fl, f.name)[perm] for f in dataclasses.fields(fl)
        })
        self._fluid_alive = self._fluid_alive[perm_np]
        self._fluid_slot_owner = self._fluid_slot_owner[perm_np]
        if self._pending_deletions:
            inv_np = inv.cpu().numpy()
            self._pending_deletions = {int(inv_np[s])
                                       for s in self._pending_deletions}
        if self._solver_state is not None:
            self._solver_state = self._solver_state[perm]
        if self._elasticity_state is not None:
            es = self._elasticity_state
            self._elasticity_state = dataclasses.replace(
                es,
                positions0=es.positions0[perm],
                volumes0=es.volumes0[perm],
                rest_j=inv[es.rest_j[perm]].to(es.rest_j.dtype),
                rest_valid=es.rest_valid[perm],
                rest_w=es.rest_w[perm],
                rest_grad=es.rest_grad[perm],
            )
        return perm_np

    def _query_sets(self):
        self._sync_fluid_mirrors()
        return (
            ("fluid", self.fluids_state, self._fluid_alive,
             self._fluid_slot_owner),
            ("boundary", self.boundaries_state, self._boundary_alive,
             self._boundary_slot_owner),
        )

    def particles_intersecting_aabb(self, mins, maxs):
        """Particle ids near an AABB (loosened by the particle radius),
        `liquid_world.rs:211-246`: (kind, handle, index) tuples. The
        distances are taken on the world's device in the dtype numpy
        gives them in the JAX package (float64 for Python bounds), so the
        hits are the same."""
        mins = np.asarray(mins)
        maxs = np.asarray(maxs)
        dtype = getattr(torch, np.result_type(np.float32, mins, maxs).name)
        lo = torch.as_tensor(mins, dtype=dtype, device=self.device)
        hi = torch.as_tensor(maxs, dtype=dtype, device=self.device)
        out = []
        for kind, state, alive, owner in self._query_sets():
            pos = state.positions.to(dtype)
            off = pos - torch.minimum(torch.maximum(pos, lo), hi)
            d = torch.sqrt(dot(off, off))
            near = (d < self.particle_radius).cpu().numpy()
            hits = np.where(alive & near)[0]
            out.extend(_slot_ids(kind, owner, alive, hits))
        return out

    def particles_intersecting_shape(self, shape, rotation, translation):
        """Particle ids near a posed SDF shape (`liquid_world.rs:248-280`):
        (kind, handle, index) tuples; a ``TriMesh`` answers through its
        voxelized field, on the world's device."""
        rotation = torch.as_tensor(np.asarray(rotation), dtype=torch.float32,
                                   device=self.device)
        translation = torch.as_tensor(np.asarray(translation),
                                      dtype=torch.float32, device=self.device)
        out = []
        for kind, state, alive, owner in self._query_sets():
            d = world_sdf(shape, state.positions, rotation, translation)
            near = (d <= self.particle_radius).cpu().numpy()
            hits = np.where(alive & near)[0]
            out.extend(_slot_ids(kind, owner, alive, hits))
        return out


def _cfl_vmax(vel, prev_vel, alive, gravity, inv_prev_dt, t_rem):
    """``max_i ||v_i + a_i * t_remaining||`` (`timestep_manager.rs:36-46`)
    over alive slots, with ``a_i`` recovered from the previous substep's
    velocity change; gravity on the first substep of a step
    (``inv_prev_dt == 0``). ``inv_prev_dt`` and ``t_rem`` are Python
    floats rounded to float32 first, as the JAX package casts them."""
    inv_prev_dt = float(np.float32(inv_prev_dt))
    t_rem = float(np.float32(t_rem))
    if inv_prev_dt > 0.0:
        accel = (vel - prev_vel) * inv_prev_dt
    else:
        accel = gravity[None, :].expand_as(vel)
    v_pred = vel + accel * t_rem
    speed = torch.sqrt(dot(v_pred, v_pred))
    return torch.where(alive, speed, 0.0).amax()


def _slot_ids(kind, owner, alive, hits):
    """(kind, handle, index-within-handle) tuples for hit slots: one
    rank pass over the live slots, not a scan per hit."""
    live = np.flatnonzero(alive & (owner >= 0))
    ow = owner[live]
    order = np.argsort(ow, kind="stable")
    so = ow[order]
    n = len(so)
    is_first = np.ones(n, bool)
    if n > 1:
        is_first[1:] = so[1:] != so[:-1]
    first = np.maximum.accumulate(np.where(is_first, np.arange(n), 0))
    ranks = np.empty(n, np.int64)
    ranks[order] = np.arange(n) - first
    idx_of_slot = np.full(len(owner), -1, np.int64)
    idx_of_slot[live] = ranks
    return [
        (kind, int(owner[s]), int(idx_of_slot[s]))
        for s in hits
        if idx_of_slot[s] >= 0
    ]
