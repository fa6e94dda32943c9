"""Device-resident rigid-body + coupling stepping.

Port of ``salva_tpu.coupling.device_pipeline``. The host pipeline
(``rigid_body.py`` + ``collider_coupling.py``) keeps body state in numpy
and crosses between host and device several times per substep (SDF
contact queries, the dynamic-sampling emit fetch, the force fetch). This
module keeps the whole coupled substep on the world's device:

- body pose/velocity state is a small ``NamedTuple`` of ``[B, ...]``
  tensors (``DeviceRigidState``);
- contact generation (collider samples vs every other collider's SDF,
  including dynamic-dynamic pairs), the sequential-impulse solve
  (``ops.rigid.solve_contacts``: one CUDA kernel on the card),
  integration and position projection run as tensor ops;
- boundary resampling (static pose transforms and DynamicContactSampling
  emission, compacted into fixed slot blocks on the device) writes the
  world's boundary tensors directly, with no emit fetch;
- force transmission reduces boundary forces to per-body impulses on the
  device.

A coupled substep then takes no host sync. Semantics mirror the host
engine (`fluids_pipeline.rs:137-288` role); the contact solver matches
``rigid_body.py`` up to the position-projection tie-break (max-depth
contact per body, resolved by first index on the device).

Scatters: the contact table and the emission blocks are compacted by
writing each kept row to its rank and every other row to one padding row
past the end, which is sliced off, so a write with duplicate indices
never lands in a row that is kept; the projection's per-body maximum and
first index are ``scatter_reduce`` ``amax`` / ``amin``. Runs are bitwise
repeatable.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from .. import shapes as shp
from ..object.state import set_rows, set_rows_drop
from ..ops import rigid
from .collider_coupling import dynamic_sample


class DeviceRigidState(NamedTuple):
    """Rigid body dynamic state on the device.

    ``rot``: [B, d, d] rotation matrices; ``angvel``: [B] in 2D (scalar
    omega) or [B, 3] in 3D.
    """

    trans: torch.Tensor
    rot: torch.Tensor
    linvel: torch.Tensor
    angvel: torch.Tensor
    # Dropped DynamicContactSampling emissions (capacity overflow),
    # accumulated for rare host-side surfacing.
    sampling_dropped: torch.Tensor


@dataclasses.dataclass(frozen=True)
class _ColliderMeta:
    shape: object  # SDF-capable (a TriMesh voxelized at freeze)
    body: int
    dynamic: bool


def _rot2(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack(
        [torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2
    )


def _skew3(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        -2,
    )


def _orthonormalize(R):
    u, _, vt = torch.linalg.svd(R)
    return u @ vt


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


class DeviceColliderCoupling:
    """CouplingManager implementation with device-resident rigid state.

    Built from a host ``RigidBodyWorld`` + ``ColliderCouplingSet`` at
    freeze time; thereafter the host objects are STALE until
    :meth:`sync_to_host` copies the poses back (one fetch, for rendering
    or user reads)."""

    # Contacts kept after compaction (penetrating samples are few; the
    # full candidate set is samples x colliders).
    max_contacts: int = 64

    def __init__(self, coupling_set, world):
        rw = coupling_set.rigid_world
        self.rigid_world = rw
        self.coupling_set = coupling_set
        self.dim = rw.dim
        self.device = world.device
        self._gravity_key = None
        self._gravity = torch.zeros(rw.dim, dtype=torch.float32,
                                    device=self.device)
        self._freeze(coupling_set, rw, world)

    def _tensor(self, values, dtype=torch.float32):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self.device)

    def _device_shape(self, shape):
        """The collider's SDF shape: a ``TriMesh`` is voxelized here, once,
        on the world's device (its ``VoxelSdf`` answers every substep's
        projection on the card)."""
        shp.check_ported(shape)
        if isinstance(shape, shp.TriMesh):
            from ..sampling.voxelize import trimesh_sdf

            return trimesh_sdf(shape, device=self.device)
        return shape

    # -- freeze ------------------------------------------------------------

    def _freeze(self, cs, rw, world):
        d = self.dim
        B = len(rw.bodies)
        self.n_bodies = B
        self.inv_mass = self._tensor([b.inv_mass for b in rw.bodies])
        self.inv_inertia = self._tensor(
            np.stack([np.atleast_1d(b._inv_inertia()) for b in rw.bodies])
            if B else np.zeros((0, 1))
        )  # [B, 1] in 2D, [B, 3] in 3D
        dynamic = [b.is_dynamic for b in rw.bodies]
        self.dynamic_mask = self._tensor(dynamic, torch.bool)
        self.any_dynamic = any(dynamic)

        self.colliders = tuple(
            _ColliderMeta(shape=self._device_shape(c.shape), body=c.body,
                          dynamic=rw.bodies[c.body].is_dynamic)
            for c in rw.colliders
        )
        NC = len(rw.colliders)
        self.collider_body = self._tensor([c.body for c in rw.colliders],
                                          torch.long)
        self.local_rot = self._tensor(
            np.stack([c.local_rotation for c in rw.colliders])
            if NC else np.zeros((0, d, d))
        )
        self.local_trans = self._tensor(
            np.stack([c.local_translation for c in rw.colliders])
            if NC else np.zeros((0, d))
        )

        # Contact samples of every dynamic collider (local frames).
        samp_pts, samp_body, samp_cid = [], [], []
        for cid, c in enumerate(rw.colliders):
            if not rw.bodies[c.body].is_dynamic:
                continue
            local = rw._collider_samples(c)
            samp_pts.append(np.asarray(local, np.float32))
            samp_body.append(np.full(len(local), c.body, np.int64))
            samp_cid.append(np.full(len(local), cid, np.int64))
        if samp_pts:
            self.samples = self._tensor(np.concatenate(samp_pts))
            self.sample_body = self._tensor(np.concatenate(samp_body),
                                            torch.long)
            self.sample_cid = self._tensor(np.concatenate(samp_cid),
                                           torch.long)
        else:
            self.samples = torch.zeros((0, d), device=self.device)
            self.sample_body = torch.zeros((0,), dtype=torch.long,
                                           device=self.device)
            self.sample_cid = torch.zeros_like(self.sample_body)

        # Coupling entries: normalize boundary slot blocks so counts are
        # static (dynamic entries reserve max_samples slots up front).
        # Static entries are concatenated into one block: one pose
        # transform and one write a substep for all of them.
        static_pts, static_cid, static_slots = [], [], []
        self.dynamic_entries = []
        self.transmit_entries = []
        for e in cs.entries.values():
            if e.sampling.kind == "static":
                pts = np.asarray(e.sampling.points, np.float32)
                # Written at the collider's current pose (the JAX package
                # writes the local points): the first step sizes its dense
                # layout from these positions before the first substep
                # moves them (collider_coupling.ColliderCouplingSet.
                # presample).
                R, t = rw.collider_pose(e.collider)
                world.set_boundary_particles(e.boundary, pts @ R.T + t)
            else:
                cap = int(e.sampling.max_samples)
                world.set_boundary_particles(
                    e.boundary, np.zeros((cap, d), np.float32)
                )
            slots = np.where(world._boundary_slot_owner == e.boundary)[0]
            slots_t = self._tensor(slots, torch.long)
            if e.sampling.kind == "static":
                static_pts.append(pts)
                static_cid.append(np.full(len(pts), e.collider, np.int64))
                static_slots.append(slots)
            else:
                # Reserved slots start dead (nothing emitted yet).
                bd = world.boundaries_state
                world.boundaries_state = bd.replace(
                    alive=set_rows(bd.alive, slots_t, False)
                )
                self.dynamic_entries.append(
                    dict(collider=e.collider, slots=slots_t, cap=cap)
                )
            if self.colliders[e.collider].dynamic:
                self.transmit_entries.append(
                    dict(body=self.colliders[e.collider].body, slots=slots_t)
                )
        if static_pts:
            cid = np.concatenate(static_cid)
            self.static_points = self._tensor(np.concatenate(static_pts))
            self.static_cid = self._tensor(cid, torch.long)
            self.static_body = self._tensor(
                [self.colliders[c].body for c in cid], torch.long
            )
            self.static_slots = self._tensor(np.concatenate(static_slots),
                                             torch.long)
        else:
            self.static_points = None

        self.friction = float(rw.friction)
        self.restitution = float(rw.restitution)
        self.contact_iterations = int(rw.contact_iterations)
        self.contact_slop = float(rw.contact_slop)
        self.particle_radius = float(world.particle_radius)
        self.h = float(world.h)

        def stack(attr, shape):
            return self._tensor(
                np.stack([np.atleast_1d(getattr(b, attr)).astype(np.float32)
                          for b in rw.bodies])
                if B else np.zeros(shape)
            )

        self.rigid_state = DeviceRigidState(
            trans=stack("translation", (0, d)),
            rot=stack("rotation", (0, d, d)),
            linvel=stack("linvel", (0, d)),
            angvel=stack("angvel", (0, 1)).reshape((B,) if d == 2 else (B, 3)),
            sampling_dropped=torch.zeros((), dtype=torch.int64,
                                         device=self.device),
        )

    # -- small device helpers ----------------------------------------------

    def _collider_poses(self, rs):
        """World rotation [NC, d, d] and translation [NC, d] of every
        collider."""
        Rb = rs.rot[self.collider_body]
        R = Rb @ self.local_rot
        t = (Rb @ self.local_trans[..., None])[..., 0] \
            + rs.trans[self.collider_body]
        return R, t

    def _point_vels(self, rs, body, pts):
        """Rigid velocities of bodies ``body`` ([S] or an int) at ``pts``."""
        r = pts - rs.trans[body]
        if self.dim == 2:
            perp = torch.stack([-r[..., 1], r[..., 0]], -1)
            w = rs.angvel[body]
            return rs.linvel[body] + (w[..., None] if w.ndim else w) * perp
        w = rs.angvel[body]
        return rs.linvel[body] + _cross(w.expand(r.shape), r)

    def _inv_inertia_world(self, rs, body, tau):
        """World-frame inverse inertia of ``body`` applied to ``tau``."""
        if self.dim == 2:
            return self.inv_inertia[body, 0] * tau
        R = rs.rot[body]
        return R @ (self.inv_inertia[body] * (R.T @ tau))

    # -- contacts ----------------------------------------------------------

    def _find_contacts_dev(self, rs, margin):
        """Fixed-capacity contact table: compacted penetrating samples.

        Returns a dict of [K] tensors (a, b (-1 = fixed), p, n, depth) and
        the 0-d ``count``, or None without dynamic samples."""
        K = self.max_contacts
        T = self.samples.shape[0]
        if T == 0 or not self.colliders:
            return None
        # World-space sample points.
        Rs = rs.rot[self.sample_body]  # [T, d, d]
        pts = (Rs @ self.samples[..., None])[..., 0] \
            + rs.trans[self.sample_body]
        Rc, tc = self._collider_poses(rs)
        cand_mask, cand_n, cand_depth, cand_b = [], [], [], []
        for cid, meta in enumerate(self.colliders):
            _, dist, nrm = shp.project_point(meta.shape, pts, Rc[cid],
                                             tc[cid])
            hit = dist < margin
            if meta.dynamic:
                hit = hit & (self.sample_body != meta.body) & (
                    self.sample_cid != cid
                )
            cand_mask.append(hit)
            cand_n.append(nrm)
            cand_depth.append(-dist)
            cand_b.append(torch.full((T,), meta.body if meta.dynamic else -1,
                                     dtype=torch.int32, device=self.device))
        mask = torch.cat(cand_mask)  # [T * NC]
        nc = len(self.colliders)
        rank = torch.cumsum(mask.to(torch.int32), 0) - 1
        keep = mask & (rank < K)
        tgt = torch.where(keep, rank, K).long()
        count = torch.clamp(torch.sum(mask.to(torch.int32)), max=K)
        def compact(values, fill):
            out = torch.full((K,) + tuple(values.shape[1:]), fill,
                             dtype=values.dtype, device=values.device)
            return set_rows_drop(out, tgt, values)

        return dict(
            a=compact(self.sample_body.to(torch.int32).repeat(nc), 0),
            b=compact(torch.cat(cand_b), -1),
            p=compact(pts.repeat(nc, 1), 0.0),
            n=compact(torch.cat(cand_n), 0.0),
            depth=compact(torch.cat(cand_depth), 0.0),
            count=count.to(torch.int32),
        )

    def _solve_velocities_dev(self, rs, con):
        """Sequential impulses over the contact table
        (``ops.rigid.solve_contacts``), mirroring
        ``rigid_body._solve_contact_velocities``."""
        linvel, angvel = rigid.solve_contacts(
            rs.trans, rs.rot, rs.linvel, rs.angvel, self.inv_mass,
            self.inv_inertia, con["a"], con["b"], con["p"], con["n"],
            con["count"], self.restitution, self.friction,
            self.contact_iterations,
        )
        return rs._replace(linvel=linvel, angvel=angvel)

    def _project_positions_dev(self, rs, beta=0.8, passes=2):
        """Per-body max-depth push (inverse-mass split for dyn-dyn)."""
        B = self.n_bodies
        K = self.max_contacts
        for _ in range(passes):
            con = self._find_contacts_dev(rs, -self.contact_slop)
            if con is None:
                return rs
            a = con["a"].long()
            active = torch.arange(K, device=self.device) < con["count"]
            corr = (con["depth"] - self.contact_slop) * beta
            has_b = con["b"] >= 0
            bs = torch.clamp(con["b"], min=0).long()
            wa = self.inv_mass[a]
            wb = torch.where(has_b, self.inv_mass[bs], 0.0)
            wsum = torch.clamp(wa + wb, min=1e-12)
            corr_a = torch.where(
                active, corr * torch.where(has_b, wa / wsum, 1.0), 0.0
            )
            corr_b = torch.where(active & has_b, corr * wb / wsum, 0.0)

            bodies = torch.cat([a, bs])
            corrs = torch.clamp(torch.cat([corr_a, corr_b]), min=0.0)
            norms = torch.cat([con["n"], -con["n"]])

            best = torch.zeros(B, dtype=corrs.dtype, device=self.device
                               ).scatter_reduce(0, bodies, corrs, "amax")
            # Tie-break: the first contact achieving the per-body max.
            is_best = (corrs == best[bodies]) & (corrs > 0.0)
            kidx = torch.arange(2 * K, device=self.device)
            first = torch.full((B + 1,), 2 * K, dtype=torch.long,
                               device=self.device).scatter_reduce(
                0, torch.where(is_best, bodies, B), kidx, "amin"
            )[:B]
            sel = torch.clamp(first, max=2 * K - 1)
            push = torch.where(
                ((first < 2 * K) & self.dynamic_mask)[:, None],
                best[:, None] * norms[sel],
                0.0,
            )
            rs = rs._replace(trans=rs.trans + push)
        return rs

    def _integrate_dev(self, rs, dt):
        dyn = self.dynamic_mask
        trans = torch.where(dyn[:, None], rs.trans + rs.linvel * dt, rs.trans)
        if self.dim == 2:
            dR = _rot2(rs.angvel * dt)
            rot = torch.where(dyn[:, None, None], dR @ rs.rot, rs.rot)
        else:
            rot = torch.where(
                dyn[:, None, None],
                _orthonormalize(rs.rot + dt * _skew3(rs.angvel) @ rs.rot),
                rs.rot,
            )
        return rs._replace(trans=trans, rot=rot)

    def _rigid_step_dev(self, rs, dt, gravity):
        """Device port of ``RigidBodyWorld.step``. Without a dynamic body
        every stage leaves the state as it is, so none runs."""
        if not self.any_dynamic:
            return rs
        linvel = torch.where(
            self.dynamic_mask[:, None], rs.linvel + gravity[None, :] * dt,
            rs.linvel,
        )
        rs = rs._replace(linvel=linvel)
        con = self._find_contacts_dev(rs, 0.0)
        if con is not None:
            rs = self._solve_velocities_dev(rs, con)
        rs = self._integrate_dev(rs, dt)
        if con is not None:
            rs = self._project_positions_dev(rs)
        return rs

    # -- boundary resampling / force transmit -------------------------------

    def _pre(self, rs, fl, bd, dt, gravity):
        rs = self._rigid_step_dev(rs, dt, gravity)
        bpos, bvel, balive = bd.positions, bd.velocities, bd.alive
        dropped = rs.sampling_dropped
        Rc, tc = self._collider_poses(rs)
        if self.static_points is not None:
            cid = self.static_cid
            pts = (Rc[cid] @ self.static_points[..., None])[..., 0] + tc[cid]
            vels = self._point_vels(rs, self.static_body, pts)
            slots = self.static_slots
            bpos = set_rows(bpos, slots, pts)
            bvel = set_rows(bvel, slots, vels)
            balive = set_rows(balive, slots, True)
        M = bpos.shape[0]
        for entry in self.dynamic_entries:
            meta = self.colliders[entry["collider"]]
            cid = entry["collider"]
            cap, slots = entry["cap"], entry["slots"]
            predicted = fl.positions + fl.velocities * dt
            _, dist, nrm = shp.project_point(meta.shape, predicted, Rc[cid],
                                             tc[cid])
            margin = self.particle_radius * 0.1
            new_pos, new_vel, emit, proj = dynamic_sample(
                fl.positions, fl.velocities, fl.alive, dist, nrm, dt,
                self.h, margin,
            )
            fl = fl.replace(positions=new_pos, velocities=new_vel)
            # On-device compaction of emitted projections into the
            # reserved slot block (no host fetch).
            rank = torch.cumsum(emit.to(torch.int32), 0) - 1
            keep = emit & (rank < cap)
            tgt = torch.where(keep, slots[torch.clamp(rank, 0, cap - 1)], M)
            n_emit = torch.sum(emit.to(torch.int64))
            count = torch.clamp(n_emit, max=cap)
            dropped = dropped + torch.clamp(n_emit - cap, min=0)
            vels = self._point_vels(rs, meta.body, proj)
            bpos = set_rows_drop(bpos, tgt, proj)
            bvel = set_rows_drop(bvel, tgt, vels)
            balive = set_rows(
                balive, slots,
                torch.arange(cap, device=self.device) < count,
            )
        bd = bd.replace(positions=bpos, velocities=bvel, alive=balive)
        rs = rs._replace(sampling_dropped=dropped)
        return rs, fl, bd

    def _post(self, rs, bd, dt):
        linvel, angvel = rs.linvel, rs.angvel
        if not self.transmit_entries:
            return rs
        linvel, angvel = linvel.clone(), angvel.clone()
        for entry in self.transmit_entries:
            body, slots = entry["body"], entry["slots"]
            f = bd.forces[slots] * dt  # [S, d] impulses
            p = bd.positions[slots]
            f = f * bd.alive[slots].to(f.dtype)[:, None]
            linvel[body] += torch.sum(f, dim=0) * self.inv_mass[body]
            r = p - rs.trans[body]
            if self.dim == 2:
                tau = torch.sum(r[:, 0] * f[:, 1] - r[:, 1] * f[:, 0])
            else:
                tau = torch.sum(_cross(r, f), dim=0)
            angvel[body] += self._inv_inertia_world(rs, body, tau)
        return rs._replace(linvel=linvel, angvel=angvel)

    # -- CouplingManager protocol -------------------------------------------

    def set_gravity(self, gravity):
        key = tuple(float(g) for g in gravity)
        if key != self._gravity_key:
            self._gravity_key = key
            self._gravity = self._tensor(key)

    def update_boundaries(self, world, dt: float):
        self.rigid_state, world.fluids_state, world.boundaries_state = (
            self._pre(self.rigid_state, world.fluids_state,
                      world.boundaries_state, dt, self._gravity)
        )

    def transmit_forces(self, world, dt: float):
        self.rigid_state = self._post(self.rigid_state,
                                      world.boundaries_state, dt)

    # -- host sync -----------------------------------------------------------

    def sync_to_host(self):
        """Copy device poses/velocities back into the host RigidBody
        objects (one fetch; for rendering / user reads)."""
        rs = DeviceRigidState(*(t.cpu().numpy() for t in self.rigid_state))
        for i, b in enumerate(self.rigid_world.bodies):
            b.translation = np.asarray(rs.trans[i], np.float32)
            b.rotation = np.asarray(rs.rot[i], np.float32)
            b.linvel = np.asarray(rs.linvel[i], np.float32)
            if self.dim == 2:
                b.angvel = float(rs.angvel[i])
            else:
                b.angvel = np.asarray(rs.angvel[i], np.float32)
        dropped = int(rs.sampling_dropped)
        if dropped > 0:
            warnings.warn(
                f"DynamicContactSampling dropped {dropped} emitted contact "
                "samples (max_samples capacity); raise "
                "DynamicContactSampling.max_samples."
            )
        return self.rigid_world
