"""Collider <-> boundary coupling: the host path.

Port of ``salva_tpu.coupling.collider_coupling`` (the reference's
``ColliderCouplingSet`` / ``ColliderCouplingManager``,
``src/integrations/rapier/fluids_pipeline.rs:64-288``):

- ``StaticSampling``: precomputed collider-local boundary points are
  transformed by the collider pose each substep, with velocities evaluated
  from the body motion at the *world* points (``:180-191``).
- ``DynamicContactSampling``: every substep, fluid particles near the
  collider are projected onto its surface; penetrating particles are pushed
  out and their inward velocity is cancelled, and a boundary particle is
  emitted at each projection (``:192-255``). The whole fluid state is
  classified against the collider SDF in one vectorized pass on the
  world's device; the emitted points are fetched to the host.
- ``transmit_forces``: accumulated boundary forces become impulses
  ``force * dt`` on the parent body (``:263-287``), from one fetch of the
  boundary forces and positions a substep.

The bodies live on the host (``rigid_body.RigidBodyWorld``);
``device_pipeline`` is the path that keeps them on the device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from .. import counters
from .. import shapes as shp
from .rigid_body import RigidBodyWorld


class ColliderSampling:
    """Sampling strategy of one coupling (`fluids_pipeline.rs:64-72`)."""

    @staticmethod
    def static_sampling(points) -> "ColliderSampling":
        s = ColliderSampling()
        s.kind = "static"
        s.points = np.asarray(points, np.float32)
        return s

    @staticmethod
    def dynamic_contact_sampling(max_samples: int = 4096) -> "ColliderSampling":
        s = ColliderSampling()
        s.kind = "dynamic"
        s.max_samples = max_samples
        return s


@dataclasses.dataclass
class _CouplingEntry:
    boundary: int
    collider: int
    sampling: ColliderSampling


def dynamic_sample(positions, velocities, alive, d, n, dt: float, h: float,
                   margin: float):
    """One collider's DynamicContactSampling pass over the fluid state.

    ``d`` / ``n``: SDF distance and outward normal at the *predicted*
    positions ``p + v dt`` (`fluids_pipeline.rs:207-210`). Returns the
    updated positions and velocities, the emission mask and the
    projection points.
    """
    # The emission band h + h / 2 in float32, as the JAX package forms it.
    h32 = np.float32(h)
    band = float(h32 + h32 * np.float32(0.5))
    inside = alive & (d < 0.0)

    # Depenetration: push out along the outward normal by depth + margin
    # and cancel any inward velocity (`fluids_pipeline.rs:222-237`).
    push = (-d + margin)[:, None] * n
    new_pos = torch.where(inside[:, None], positions + push, positions)
    v_n = shp.dot(n, velocities)
    cancel = inside & (v_n < 0.0)
    new_vel = torch.where(cancel[:, None], velocities - v_n[:, None] * n,
                          velocities)

    # Emit a boundary particle at the surface projection for any particle
    # within the kernel-support prediction band (`:241-252`).
    emit = alive & (d <= band)
    proj = (positions + velocities * dt) - d[:, None] * n
    return new_pos, new_vel, emit, proj


class ColliderCouplingSet:
    """Registered collider<->boundary couplings + the CouplingManager impl.

    The reference splits this into the set (host data, `:81-136`) and a
    borrowing manager (`:137-288`); here the set itself implements the
    protocol, bound to a ``RigidBodyWorld``.
    """

    def __init__(self, rigid_world: RigidBodyWorld):
        self.rigid_world = rigid_world
        self.entries: Dict[int, _CouplingEntry] = {}

    def register_coupling(self, boundary_handle: int, collider_id: int,
                          sampling: ColliderSampling):
        """`ColliderCouplingSet::register_coupling` (`:98-112`)."""
        self.entries[collider_id] = _CouplingEntry(
            boundary_handle, collider_id, sampling
        )

    def unregister_coupling(self, collider_id: int) -> Optional[int]:
        """`ColliderCouplingSet::unregister_coupling` (`:114-122`);
        returns the now-uncoupled boundary handle."""
        e = self.entries.pop(collider_id, None)
        return e.boundary if e is not None else None

    def presample(self, world):
        """Write every static-sampling boundary at its collider's current
        pose, before the first step. The world sizes its dense layout (the
        boundary cap tier, the sparse fb table) from the boundary
        particles it holds when a step starts, and the first
        ``update_boundaries`` runs only inside that step: without this,
        the first step of a coupled dense world is sized for no boundary
        at all (the JAX package's host path does that, and overflows its
        boundary cap on basic3's walls)."""
        rw = self.rigid_world
        for entry in self.entries.values():
            if entry.sampling.kind != "static":
                continue
            R, t = rw.collider_pose(entry.collider)
            pts = entry.sampling.points @ R.T + t
            body = rw.body_of_collider(entry.collider)
            world.set_boundary_particles(entry.boundary, pts,
                                         body.velocities_at_points(pts))

    # -- CouplingManager protocol -------------------------------------------

    def update_boundaries(self, world, dt: float):
        rw = self.rigid_world
        # Static-sampling entries are host math (pose transform + rigid
        # velocities); batch them into ONE world update.
        static_updates = {}
        for entry in self.entries.values():
            collider = rw.colliders[entry.collider]
            body = rw.body_of_collider(entry.collider)
            R, t = rw.collider_pose(entry.collider)

            if entry.sampling.kind == "static":
                pts = entry.sampling.points @ R.T + t
                vels = body.velocities_at_points(pts)
                static_updates[entry.boundary] = (pts, vels)
            else:
                self._dynamic_update(world, entry, collider, body, R, t, dt)
        if static_updates:
            world.set_boundaries_bulk(static_updates)

    def _dynamic_update(self, world, entry, collider, body, R, t, dt: float):
        fl = world.fluids_state
        dev = fl.positions.device
        predicted = fl.positions + fl.velocities * dt
        _, d, n = shp.project_point(
            collider.shape, predicted,
            torch.as_tensor(R, device=dev), torch.as_tensor(t, device=dev),
        )
        margin = world.particle_radius * 0.1
        new_pos, new_vel, emit, proj = dynamic_sample(
            fl.positions, fl.velocities, fl.alive, d, n, dt, world.h, margin,
        )
        world.fluids_state = fl.replace(positions=new_pos, velocities=new_vel)

        hits = np.where(counters.fetch("coupling", emit).numpy())[0]
        if len(hits) > entry.sampling.max_samples:
            warnings.warn(
                f"DynamicContactSampling on boundary {entry.boundary}: "
                f"{len(hits)} contact samples exceed max_samples="
                f"{entry.sampling.max_samples}; dropping "
                f"{len(hits) - entry.sampling.max_samples}. Raise "
                "DynamicContactSampling.max_samples."
            )
        idx = hits[: entry.sampling.max_samples]
        pts = counters.fetch("coupling", proj).numpy()[idx]
        vels = body.velocities_at_points(pts) if len(pts) else np.zeros_like(pts)
        world.set_boundary_particles(entry.boundary, pts, vels)

    def transmit_forces(self, world, dt: float):
        """Boundary forces -> body impulses (`fluids_pipeline.rs:263-287`).

        One fetch of the merged force/position arrays serves every
        coupled body.
        """
        dyn = [
            e for e in self.entries.values()
            if self.rigid_world.body_of_collider(e.collider).is_dynamic
        ]
        if not dyn:
            return
        bd = world.boundaries_state
        forces_np = counters.fetch("coupling", bd.forces).numpy()
        pos_np = counters.fetch("coupling", bd.positions).numpy()
        for entry in dyn:
            body = self.rigid_world.body_of_collider(entry.collider)
            slots = world.boundary_slots(entry.boundary)
            if len(slots) == 0:
                continue
            body.apply_impulses_at_points(
                forces_np[slots] * dt, pos_np[slots]
            )
