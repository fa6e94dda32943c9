"""The simulation step of the dense layout: binning -> hoisted sums ->
pressure solver -> integration, as one Python function over the state
tensors (``salva_tpu.step``, dense branch only).

The substep loop is that of ``src/liquid_world.rs:84-148``; the gather
layout (worlds without a ``domain``) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import SimConfig
from .solver.common import SolverDiagnostics
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


def init_solver_state(solver_cfg, capacity: int, dim: int, device="cpu"):
    """Persistent solver scratch: DFSPH carries the velocity changes
    (`dfsph_solver.rs:44,688-691`) plus the warm-start stiffness sums in
    columns [dim] / [dim+1]; IISPH carries its pressures."""
    if solver_cfg.kind == "dfsph":
        return torch.zeros((capacity, dim + 2), dtype=torch.float32,
                           device=device)
    if solver_cfg.kind == "iisph":
        return torch.zeros((capacity,), dtype=torch.float32, device=device)
    raise ValueError(f"unknown solver kind {solver_cfg.kind!r}")


def _dense_config(sim: SimConfig, solver_cfg, forces: ForceSet):
    """Resolve the dense-layout configuration, or None for the gather
    layout (``layout="auto"`` without a usable domain)."""
    from .geometry.dense_grid import spec_for_aabb
    from .solver.forces_dense import to_dense_forces

    if sim.layout == "gather":
        return None
    reasons = []
    if sim.domain is None:
        reasons.append("sim.domain is not set")
    if solver_cfg.kind not in ("dfsph", "iisph"):
        reasons.append(f"solver {solver_cfg.kind!r} has no dense path")
    dense_forces = to_dense_forces(forces)
    if reasons:
        if sim.layout in ("dense", "brute"):
            raise ValueError(
                f"layout={sim.layout!r} not possible: " + "; ".join(reasons)
            )
        return None
    if sim.layout == "brute":
        raise NotImplementedError(
            "layout='brute' (the all-pairs tier) is not ported to "
            "salva_tpu_torch"
        )

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
    """Build the substep function for a fixed static configuration."""
    dense = _dense_config(sim, solver_cfg, forces)
    if dense is None:
        raise NotImplementedError(
            "the gather layout is not ported to salva_tpu_torch: give the "
            "world a static `domain` (the dense layout)"
        )
    if solver_cfg.kind != "dfsph":
        raise NotImplementedError(
            f"the dense {solver_cfg.kind!r} solver is not ported to "
            "salva_tpu_torch"
        )
    from .solver.dfsph_dense import build_dense_substep

    spec_f, spec_b, dense_forces = dense
    return build_dense_substep(
        sim, solver_cfg, num_fluids, spec_f, spec_b, dense_forces
    )


def build_step_fn(sim: SimConfig, solver_cfg, forces: ForceSet,
                  num_fluids: int):
    """Full step = ``n_substeps`` substeps (`timestep_manager.rs:87-94`
    runs one; ``n_substeps > 1`` subdivides dt evenly)."""
    substep = build_substep_fn(sim, solver_cfg, forces, num_fluids)
    n_sub = sim.n_substeps

    def step(fluids, boundaries, solver_state, dt, gravity):
        sub_dt = dt / n_sub
        diag = None
        for _ in range(n_sub):
            fluids, boundaries, solver_state, diag = substep(
                fluids, boundaries, solver_state, sub_dt, gravity
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
