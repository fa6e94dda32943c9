"""Shared solver machinery: the solver diagnostics, and for the gather
layout the substep context, densities, boundary volumes, per-fluid error
reductions and the boundary-force scatter (``salva_tpu.solver.common``).

Every function is a map over the merged particle state
(``object/state.py``) and the evaluated contact tables
(``geometry/contacts.py``). Nothing here uses float atomics: the
per-fluid reductions loop over the fluids with masked sums, and the
boundary-force scatter sums each boundary particle's contributions in
flat table order through ``Contacts.scatter_table``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..geometry.contacts import Contacts
from ..object.state import BoundariesState, FluidsState


@dataclasses.dataclass
class StepContext:
    """Everything a gather-layout solver stage needs for one substep.

    - ``ff``: fluid-fluid contacts [N, K];
    - ``fb``: fluid-boundary contacts [N, Kb];
    - ``densities``: [N] f32, rho_i = sum m_j W + sum V_b rho0_i W
      (`dfsph_solver.rs:628-665`);
    - ``dt`` / ``inv_dt``: substep length (0-dim tensors).
    """

    fluids: FluidsState
    boundaries: BoundariesState
    ff: Contacts
    fb: Contacts
    densities: torch.Tensor
    dt: torch.Tensor
    inv_dt: torch.Tensor
    dim: int = 3
    h: float = 0.2
    num_fluids: int = 1

    def replace(self, **kw) -> "StepContext":
        return dataclasses.replace(self, **kw)

    @property
    def masses(self):
        return self.fluids.masses

    def ff_mass_j(self):
        """Mass of the j-side particle of each fluid-fluid contact."""
        return self.masses[self.ff.j]

    def fb_mass_j(self):
        """Effective boundary 'mass' of each fluid-boundary contact:
        ``V_bj * rho0_i`` (`dfsph_solver.rs:140-145`)."""
        return (self.boundaries.volumes[self.fb.j]
                * self.fluids.density0[:, None])


def compute_densities(ctx: StepContext) -> torch.Tensor:
    """rho_i = sum_ff m_j W_ij + sum_fb V_bj rho0_i W_ij
    (`dfsph_solver.rs:628-665`); dead particles get rho0."""
    rho = (torch.sum(ctx.ff_mass_j() * ctx.ff.w, dim=1)
           + torch.sum(ctx.fb_mass_j() * ctx.fb.w, dim=1))
    return torch.where(ctx.fluids.alive, rho, ctx.fluids.density0)


def boundary_volumes(wsum, alive) -> torch.Tensor:
    """V_b = 1 / sum_k W_bk over boundary-boundary neighbours
    (`dfsph_solver.rs:72-96`)."""
    safe = torch.where(wsum > 0.0, wsum, 1.0)
    return torch.where(alive & (wsum > 0.0), 1.0 / safe, 0.0)


def per_fluid_mean_max(values, fluid_id, alive, num_fluids: int):
    """max over fluids of (mean over that fluid's alive particles), the
    reference's error rule (`dfsph_solver.rs:150-160`); 0-dim tensor."""
    err = torch.zeros((), dtype=torch.float32, device=values.device)
    for f in range(num_fluids):
        sel = alive & (fluid_id == f)
        s = torch.sum(torch.where(sel, values, 0.0))
        cnt = torch.sum(sel.to(values.dtype))
        err = torch.maximum(
            err, torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0))
    return err


def scatter_boundary_forces(forces, fb: Contacts, contrib):
    """``forces`` plus the per-contact contributions ``contrib`` [N, Kb,
    dim] (zero on invalid slots) accumulated onto their boundary
    particles: the deterministic replacement of the reference's RwLock
    accumulation (`boundary.rs:62-67`). Each boundary particle adds its
    contributions one at a time in flat table order, the order of the
    JAX package's scatter-add on the CPU."""
    table = fb.scatter_table(forces.shape[0])
    flat = contrib.reshape(-1, contrib.shape[-1])
    flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
    out = forces
    for k in range(table.shape[1]):
        out = out + flat[table[:, k]]
    return out


class SolverDiagnostics(NamedTuple):
    """Iteration counts and final errors of one substep's solves
    (``salva_tpu.solver.common.SolverDiagnostics``). The loops run on the
    host, so the counts are Python ints; the errors stay 0-dim device
    tensors until read."""

    pressure_iters: int
    pressure_error: torch.Tensor
    divergence_iters: int
    divergence_error: torch.Tensor
