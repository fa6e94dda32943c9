"""The simulation step: neighbour search (or binning) -> kernels ->
densities -> pressure solver -> integration, as one Python function over
the state tensors (``salva_tpu.step``).

The substep loop is that of ``src/liquid_world.rs:84-148``. Two layouts:
the dense layout (the binned grid, or the brute all-pairs tier, over a
static ``domain``; ``solver/dfsph_dense.py``, ``iisph_dense.py``) and the
gather layout (the Morton grid and [N, K] neighbour tables of
``geometry/``; ``solver/dfsph.py``, ``iisph.py``), which runs every world
without a domain and every world carrying a ``CustomForce``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import SimConfig
from .geometry import (
    build_grid,
    evaluate_contacts,
    find_neighbors,
    weighted_sum_over_neighbors,
)
from .kernels import get_kernel
from .solver import dfsph, iisph
from .solver.common import (
    SolverDiagnostics,
    StepContext,
    boundary_volumes,
    compute_densities,
)
from .solver.elasticity import Becker2009ElasticityForce
from .solver.nonpressure import ForceSet


@dataclasses.dataclass
class StepDiagnostics:
    """Per-step observability (``salva_tpu.step.StepDiagnostics``): device
    tensors, except the solver iteration counts (Python ints)."""

    solver: SolverDiagnostics
    ncontacts_ff: torch.Tensor
    ncontacts_fb: torch.Tensor
    neighbor_overflow: torch.Tensor
    candidate_overflow: torch.Tensor
    max_density_ratio: torch.Tensor
    # Live fluid extent + speed (drive the fitted-grid refit policy).
    fluid_min: Optional[torch.Tensor] = None
    fluid_max: Optional[torch.Tensor] = None
    max_speed: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "StepDiagnostics":
        return dataclasses.replace(self, **kw)


def solver_state_shape(solver_cfg, capacity: int, dim: int):
    """Shape of the persistent solver scratch: DFSPH carries the velocity
    changes (`dfsph_solver.rs:44,688-691`) plus the warm-start stiffness
    sums in columns [dim] / [dim+1]; IISPH carries its pressures
    (`iisph_solver.rs:35,673-677`)."""
    if solver_cfg.kind == "dfsph":
        return (capacity, dim + 2)
    if solver_cfg.kind == "iisph":
        return (capacity,)
    raise ValueError(f"unknown solver kind {solver_cfg.kind!r}")


def init_solver_state(solver_cfg, capacity: int, dim: int, device):
    """Zeroed solver scratch of :func:`solver_state_shape` on ``device``."""
    return torch.zeros(solver_state_shape(solver_cfg, capacity, dim),
                       dtype=torch.float32, device=device)


def _dense_config(sim: SimConfig, solver_cfg, forces: ForceSet):
    """Resolve the dense-layout configuration, or None for the gather
    layout (``layout="auto"`` without a usable domain)."""
    from .geometry.dense_grid import brute_spec, spec_for_aabb
    from .solver.forces_dense import to_dense_forces

    if sim.layout == "gather":
        return None
    reasons = []
    if sim.domain is None:
        reasons.append("sim.domain is not set")
    if solver_cfg.kind not in ("dfsph", "iisph"):
        reasons.append(f"solver {solver_cfg.kind!r} has no dense path")
    dense_forces = to_dense_forces(forces)
    if dense_forces is None:
        reasons.append("a non-pressure force has no dense implementation")
    if reasons:
        if sim.layout in ("dense", "brute"):
            raise ValueError(
                f"layout={sim.layout!r} not possible: " + "; ".join(reasons)
            )
        return None
    if sim.layout == "brute":
        # All-pairs tier: dense_cap / dense_cap_boundary carry the
        # per-cyclic-cell slot counts (ceil(capacity / brute_cells),
        # resolved by the world); a mis-sized explicit cap surfaces as bin
        # overflow in the diagnostics, never as a silent drop.
        cells = int(sim.brute_cells)
        spec_f = brute_spec(sim.dense_cap * cells, cells)
        spec_b = brute_spec(sim.dense_cap_boundary * cells, cells)
        return spec_f, spec_b, dense_forces

    mins, maxs = sim.domain
    spec_f = spec_for_aabb(mins, maxs, sim.h, sim.dense_cap)
    if sim.fitted_dims is not None:
        # Fluid-tracking window: static dims; DenseCtx supplies the
        # per-substep origin (the spec keeps the domain origin as anchor).
        spec_f = spec_f.replace(
            dims=tuple(int(v) for v in sim.fitted_dims)
        )
    spec_b = spec_f.replace(cap=sim.dense_cap_boundary)
    return spec_f, spec_b, dense_forces


def build_substep_fn(sim: SimConfig, solver_cfg, forces: ForceSet,
                     num_fluids: int):
    """Build the substep function ``substep(fluids, boundaries,
    solver_state, es, dt, gravity)`` for a fixed static configuration
    (``es``: the elasticity state, or None)."""
    dense = _dense_config(sim, solver_cfg, forces)
    if dense is not None:
        if solver_cfg.kind == "dfsph":
            from .solver.dfsph_dense import build_dense_substep
        else:
            from .solver.iisph_dense import build_dense_substep

        spec_f, spec_b, dense_forces = dense
        return build_dense_substep(
            sim, solver_cfg, num_fluids, spec_f, spec_b, dense_forces
        )
    return _build_gather_substep(sim, solver_cfg, forces, num_fluids)


def _build_gather_substep(sim: SimConfig, solver_cfg, forces: ForceSet,
                          num_fluids: int):
    """The gather layout's substep (``salva_tpu.step``'s general path)."""
    h, dim, nb = sim.h, sim.dim, sim.neighbors
    kd_w, _ = get_kernel(sim.kernel_density)
    _, kg_dw = get_kernel(sim.kernel_gradient)
    solver = {"dfsph": dfsph, "iisph": iisph}[solver_cfg.kind]

    def substep(fluids, boundaries, solver_state, es, dt, gravity):
        dev = fluids.positions.device
        boundaries = boundaries.clear_forces()

        # Grid rebuild (`liquid_world.rs:90-106`).
        fgrid = build_grid(fluids.positions, fluids.alive, h, dim)
        bgrid = build_grid(boundaries.positions, boundaries.alive, h, dim)
        fgroups = fluids.groups()
        bgroups = boundaries.groups()

        # Contact detection (`contacts.rs:154-400`), three classes.
        ff_nl = find_neighbors(
            fluids.positions, fluids.alive, fgroups,
            fgrid, fluids.positions, fluids.alive, fgroups,
            h, dim, nb.max_neighbors, nb.max_candidates,
            same_model_always=True, query_chunk=nb.query_chunk,
        )
        fb_nl = find_neighbors(
            fluids.positions, fluids.alive, fgroups,
            bgrid, boundaries.positions, boundaries.alive, bgroups,
            h, dim, nb.max_neighbors, nb.max_candidates,
            same_model_always=False, query_chunk=nb.query_chunk,
        )
        # Kernel evaluation (`helper.rs:9-65`).
        ff = evaluate_contacts(fluids.positions, fluids.positions, ff_nl, h,
                               dim, w_fn=kd_w, dw_fn=kg_dw)
        fb = evaluate_contacts(fluids.positions, boundaries.positions, fb_nl,
                               h, dim, w_fn=kd_w, dw_fn=kg_dw)

        # Boundary volumes from the boundary-boundary W sums, no table
        # (`dfsph_solver.rs:72-96`); skipped when no boundary changed.
        if sim.recompute_boundary_volumes:
            bb_wsum, bb_overflow = weighted_sum_over_neighbors(
                boundaries.positions, boundaries.alive, bgroups,
                bgrid, boundaries.positions, boundaries.alive, bgroups,
                h, dim, nb.max_candidates, same_model_always=True,
                w_fn=kd_w, query_chunk=nb.query_chunk,
            )
            boundaries = boundaries.replace(
                volumes=boundary_volumes(bb_wsum, boundaries.alive))
        else:
            bb_overflow = torch.zeros((), dtype=torch.int32, device=dev)

        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        ctx = StepContext(
            fluids=fluids, boundaries=boundaries, ff=ff, fb=fb,
            densities=torch.zeros_like(fluids.volumes), dt=dt,
            inv_dt=torch.where(dt > 0, 1.0 / dt, 0.0),
            dim=dim, h=h, num_fluids=num_fluids,
        )
        densities = compute_densities(ctx)
        ctx = ctx.replace(densities=densities)

        def apply_nonpressure_forces(ctx):
            accel = torch.zeros_like(ctx.fluids.positions)
            bforces = torch.zeros_like(ctx.boundaries.forces)
            for force in forces:
                if isinstance(force, Becker2009ElasticityForce):
                    a, b = force.apply(ctx, es)
                else:
                    a, b = force.apply(ctx)
                accel = accel + a
                bforces = bforces + b
            return accel, bforces

        new_fluids, bforces, solver_state, sdiag = solver.step(
            solver_cfg, ctx, solver_state, gravity, apply_nonpressure_forces)
        boundaries = boundaries.replace(forces=bforces)
        diag = StepDiagnostics(
            solver=sdiag,
            ncontacts_ff=ff_nl.count.sum(dtype=torch.int32),
            ncontacts_fb=fb_nl.count.sum(dtype=torch.int32),
            neighbor_overflow=ff_nl.overflow + fb_nl.overflow,
            candidate_overflow=(ff_nl.cand_overflow + fb_nl.cand_overflow
                                + bb_overflow),
            max_density_ratio=torch.clamp(torch.where(
                fluids.alive, densities / fluids.density0, 0.0).amax(),
                min=0.0),
        )
        return new_fluids, boundaries, solver_state, diag

    return substep


def build_step_fn(sim: SimConfig, solver_cfg, forces: ForceSet,
                  num_fluids: int):
    """Full step = ``n_substeps`` substeps (`timestep_manager.rs:87-94`
    runs one; ``n_substeps > 1`` subdivides dt evenly)."""
    substep = build_substep_fn(sim, solver_cfg, forces, num_fluids)
    n_sub = sim.n_substeps

    def step(fluids, boundaries, solver_state, es, dt, gravity):
        sub_dt = dt / n_sub
        diag = None
        for _ in range(n_sub):
            fluids, boundaries, solver_state, diag = substep(
                fluids, boundaries, solver_state, es, sub_dt, gravity
            )
        # Fluid extent + peak speed for the fitted-grid refit policy.
        alive = fluids.alive[:, None]
        diag = diag.replace(
            fluid_min=torch.amin(
                torch.where(alive, fluids.positions, 1.0e30), dim=0
            ),
            fluid_max=torch.amax(
                torch.where(alive, fluids.positions, -1.0e30), dim=0
            ),
            max_speed=torch.sqrt(
                torch.clamp(
                    torch.where(
                        fluids.alive,
                        torch.sum(fluids.velocities ** 2, dim=-1),
                        0.0,
                    ).amax(),
                    min=0.0,
                )
            ),
        )
        return fluids, boundaries, solver_state, diag

    return step
