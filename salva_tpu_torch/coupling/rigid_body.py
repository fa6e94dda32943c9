"""A minimal rigid-body engine playing rapier's role in the coupling.

The reference delegates rigid-body dynamics to the external rapier crate;
the coupling only needs a small surface of it: body poses, point
velocities, impulse application and a fixed-step integrator
(``fluids_pipeline.rs:180-191`` uses ``velocity_at_point``, ``:263-287``
uses ``apply_impulse_at_point``). This module implements exactly that
surface for 2D and 3D so the coupling and all example scenes are
self-contained.

Port of ``salva_tpu.coupling.rigid_body``, which is numpy apart from its
shape queries: bodies are host-side numpy objects (there are few of them
and their math is tiny), and the contact queries go through
``shapes.project_point`` on CPU tensors. All per-particle work stays on
the world's device in ``collider_coupling``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import shapes as shp


def _rot2(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]], np.float32)


def _skew3(w: np.ndarray) -> np.ndarray:
    return np.array(
        [
            [0.0, -w[2], w[1]],
            [w[2], 0.0, -w[0]],
            [-w[1], w[0], 0.0],
        ],
        np.float32,
    )


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(R)
    return (u @ vt).astype(np.float32)


def shape_mass_properties(shape, density: float, dim: int):
    """(mass, angular inertia) of a shape at the given density.

    3D inertia is returned as the diagonal of the body-frame inertia
    tensor; 2D as a scalar. Exact for balls and cuboids; capsules use the
    cylinder + hemisphere decomposition.
    """
    if isinstance(shape, shp.Ball):
        r = shape.radius
        if dim == 2:
            m = density * np.pi * r**2
            return m, 0.5 * m * r**2
        m = density * 4.0 / 3.0 * np.pi * r**3
        i = 0.4 * m * r**2
        return m, np.array([i, i, i], np.float32)
    if isinstance(shape, shp.Cuboid):
        he = np.asarray(shape.half_extents, np.float64)
        sides = 2.0 * he
        vol = float(np.prod(sides))
        m = density * vol
        if dim == 2:
            return m, m * (sides[0] ** 2 + sides[1] ** 2) / 12.0
        ix = m * (sides[1] ** 2 + sides[2] ** 2) / 12.0
        iy = m * (sides[0] ** 2 + sides[2] ** 2) / 12.0
        iz = m * (sides[0] ** 2 + sides[1] ** 2) / 12.0
        return m, np.array([ix, iy, iz], np.float32)
    if isinstance(shape, shp.Capsule):
        r, hh = shape.radius, shape.half_height
        if dim == 2:
            # rectangle + two half discs
            m_rect = density * (2 * r) * (2 * hh)
            m_disc = density * np.pi * r**2
            m = m_rect + m_disc
            i = (
                m_rect * ((2 * r) ** 2 + (2 * hh) ** 2) / 12.0
                + m_disc * (0.5 * r**2 + hh**2)
            )
            return m, i
        m_cyl = density * np.pi * r**2 * (2 * hh)
        m_sph = density * 4.0 / 3.0 * np.pi * r**3
        m = m_cyl + m_sph
        # Axis = local y.
        iy = 0.5 * m_cyl * r**2 + 0.4 * m_sph * r**2
        ix = (
            m_cyl * (3 * r**2 + (2 * hh) ** 2) / 12.0
            + m_sph * (0.4 * r**2 + hh**2 + 0.375 * 2 * r * hh)
        )
        return m, np.array([ix, iy, ix], np.float32)
    # Heightfields / half-spaces: only sensible as fixed bodies.
    return 0.0, (0.0 if dim == 2 else np.zeros(3, np.float32))


@dataclasses.dataclass
class Collider:
    shape: object
    body: int
    local_translation: np.ndarray
    local_rotation: np.ndarray  # [dim, dim]
    density: float = 1000.0
    # Lazily-cached local-frame surface samples used as contact points
    # against static geometry (None until first contact pass).
    _contact_samples: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False
    )


class RigidBody:
    """One rigid body: pose, velocity, mass properties."""

    def __init__(self, kind: str, dim: int, translation=None, rotation=None):
        assert kind in ("fixed", "dynamic")
        self.kind = kind
        self.dim = dim
        self.translation = (
            np.asarray(translation, np.float32)
            if translation is not None
            else np.zeros(dim, np.float32)
        )
        if rotation is None:
            self.rotation = np.eye(dim, dtype=np.float32)
        elif np.isscalar(rotation):
            self.rotation = _rot2(float(rotation))
        else:
            self.rotation = np.asarray(rotation, np.float32)
        self.linvel = np.zeros(dim, np.float32)
        # 2D: scalar angular velocity; 3D: vec3.
        self.angvel = 0.0 if dim == 2 else np.zeros(3, np.float32)
        self.mass = 0.0
        # 2D: scalar; 3D: world-frame inverse inertia approximated as
        # body-diagonal (colliders added through add_collider refresh this).
        self.inertia = 0.0 if dim == 2 else np.zeros(3, np.float32)

    @property
    def is_dynamic(self) -> bool:
        return self.kind == "dynamic"

    @property
    def inv_mass(self) -> float:
        return 1.0 / self.mass if (self.is_dynamic and self.mass > 0) else 0.0

    def _inv_inertia(self):
        if self.dim == 2:
            return 1.0 / self.inertia if (self.is_dynamic and self.inertia > 0) else 0.0
        inv = np.zeros(3, np.float32)
        if self.is_dynamic:
            nz = self.inertia > 0
            inv[nz] = 1.0 / self.inertia[nz]
        return inv

    def velocity_at_point(self, p_world: np.ndarray) -> np.ndarray:
        """v + omega x r (`fluids_pipeline.rs:186-188` semantics, evaluated
        at the world-space point)."""
        r = np.asarray(p_world, np.float32) - self.translation
        if self.dim == 2:
            return self.linvel + self.angvel * np.array([-r[1], r[0]], np.float32)
        return self.linvel + np.cross(self.angvel, r)

    def velocities_at_points(self, pts: np.ndarray) -> np.ndarray:
        r = np.asarray(pts, np.float32) - self.translation
        if self.dim == 2:
            perp = np.stack([-r[:, 1], r[:, 0]], axis=-1)
            return self.linvel[None, :] + self.angvel * perp
        return self.linvel[None, :] + np.cross(
            np.broadcast_to(self.angvel, r.shape), r
        )

    def apply_impulse_at_point(self, impulse: np.ndarray, p_world: np.ndarray):
        """`RigidBody::apply_impulse_at_point` (the rapier call used at
        `fluids_pipeline.rs:283`)."""
        if not self.is_dynamic:
            return
        impulse = np.asarray(impulse, np.float32)
        r = np.asarray(p_world, np.float32) - self.translation
        self.linvel = self.linvel + impulse * self.inv_mass
        if self.dim == 2:
            torque = r[0] * impulse[1] - r[1] * impulse[0]
            self.angvel = self.angvel + torque * self._inv_inertia()
        else:
            torque = np.cross(r, impulse)
            # World-frame approximation: I_world ~ R diag(I) R^T.
            R = self.rotation
            inv_body = self._inv_inertia()
            dw = R @ (inv_body * (R.T @ torque))
            self.angvel = self.angvel + dw.astype(np.float32)

    def apply_impulses_at_points(self, impulses: np.ndarray, pts: np.ndarray):
        """Vectorized sum of per-point impulses (one pass per coupling)."""
        if not self.is_dynamic or len(pts) == 0:
            return
        impulses = np.asarray(impulses, np.float32)
        pts = np.asarray(pts, np.float32)
        r = pts - self.translation
        self.linvel = self.linvel + impulses.sum(axis=0) * self.inv_mass
        if self.dim == 2:
            torque = float(np.sum(r[:, 0] * impulses[:, 1] - r[:, 1] * impulses[:, 0]))
            self.angvel = self.angvel + torque * self._inv_inertia()
        else:
            torque = np.cross(r, impulses).sum(axis=0)
            R = self.rotation
            dw = R @ (self._inv_inertia() * (R.T @ torque))
            self.angvel = self.angvel + dw.astype(np.float32)


class RigidBodyWorld:
    """A set of rigid bodies + colliders with a symplectic-Euler stepper.

    The subset of rapier the fluids pipeline needs; scenes build bodies
    here and register couplings against collider ids.
    """

    def __init__(self, dim: int = 3):
        self.dim = dim
        self.bodies: List[RigidBody] = []
        self.colliders: List[Collider] = []

    def add_body(self, kind: str = "dynamic", translation=None, rotation=None) -> int:
        self.bodies.append(RigidBody(kind, self.dim, translation, rotation))
        return len(self.bodies) - 1

    def add_collider(
        self,
        body: int,
        shape,
        local_translation=None,
        local_rotation=None,
        density: float = 1000.0,
    ) -> int:
        lt = (
            np.asarray(local_translation, np.float32)
            if local_translation is not None
            else np.zeros(self.dim, np.float32)
        )
        if local_rotation is None:
            lr = np.eye(self.dim, dtype=np.float32)
        elif np.isscalar(local_rotation):
            lr = _rot2(float(local_rotation))
        else:
            lr = np.asarray(local_rotation, np.float32)
        self.colliders.append(Collider(shape, body, lt, lr, density))
        b = self.bodies[body]
        if b.is_dynamic:
            m, i = shape_mass_properties(shape, density, self.dim)
            b.mass += m
            # Rotate the collider inertia into the body frame and add the
            # parallel-axis term for its local offset (diagonal
            # approximation; the body origin stands in for the center of
            # mass, exact for symmetric collider sets).
            if self.dim == 2:
                b.inertia = b.inertia + i + m * float(np.dot(lt, lt))
            else:
                i_rot = np.diag(lr @ np.diag(i) @ lr.T).astype(np.float32)
                d2 = float(np.dot(lt, lt))
                pa = m * (d2 - lt * lt)
                b.inertia = b.inertia + i_rot + pa.astype(np.float32)
        return len(self.colliders) - 1

    def collider_pose(self, collider_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rotation, translation) of the collider in world space."""
        c = self.colliders[collider_id]
        b = self.bodies[c.body]
        R = b.rotation @ c.local_rotation
        t = b.rotation @ c.local_translation + b.translation
        return R.astype(np.float32), t.astype(np.float32)

    def body_of_collider(self, collider_id: int) -> RigidBody:
        return self.bodies[self.colliders[collider_id].body]

    # Contact resolution parameters (rapier-role defaults): zero
    # restitution, Coulomb friction, Baumgarte-style position projection.
    contacts_enabled: bool = True
    friction: float = 0.5
    restitution: float = 0.0
    contact_iterations: int = 8
    contact_slop: float = 1.0e-4

    def step(self, dt: float, gravity):
        """Integrate body motion with contact resolution.

        In the reference, rapier resolves body<->body and body<->static
        contacts around the fluid step (e.g. `examples3d/basic3.rs:43-116`:
        dropped cuboids/balls rest on the ground and walls;
        `examples2d/basic2.rs:105-131` drops three dynamic bodies that
        stack). This plays that role: impulse-based contacts of each
        *dynamic* collider against all *fixed-body* colliders AND against
        every other dynamic collider (sample-vs-SDF both ways, sequential
        impulses on both bodies + friction, then position projection).
        """
        gravity = np.asarray(gravity, np.float32)
        for b in self.bodies:
            if not b.is_dynamic:
                continue
            b.linvel = b.linvel + gravity * dt
        if self.contacts_enabled:
            contacts = self._find_contacts()
            self._solve_contact_velocities(contacts)
        for b in self.bodies:
            if not b.is_dynamic:
                continue
            b.translation = b.translation + b.linvel * dt
            if self.dim == 2:
                angle = np.arctan2(b.rotation[1, 0], b.rotation[0, 0])
                b.rotation = _rot2(angle + float(b.angvel) * dt)
            else:
                b.rotation = _orthonormalize(
                    b.rotation + dt * _skew3(b.angvel) @ b.rotation
                )
        if self.contacts_enabled:
            self._project_positions()

    # -- contact resolution (dynamic collider vs static geometry) ----------

    def _collider_samples(self, c: Collider) -> np.ndarray:
        """Local-frame surface contact samples of a collider (cached)."""
        if c._contact_samples is None:
            from ..sampling.shape_sampling import (
                _shape_aabb,
                shape_surface_sample,
            )

            mins, maxs = _shape_aabb(c.shape, self.dim)
            extent = float(np.max(np.asarray(maxs) - np.asarray(mins)))
            # ~dozens of samples: spacing = extent / 6 (2x sample radius).
            r = max(extent / 12.0, 1.0e-4)
            pts = np.asarray(
                shape_surface_sample(c.shape, r, self.dim), np.float32
            )
            if len(pts) == 0:
                pts = np.zeros((1, self.dim), np.float32)
            c._contact_samples = (
                pts @ c.local_rotation.T + c.local_translation[None, :]
            ).astype(np.float32)
        return c._contact_samples

    def _find_contacts(self, margin: float = 0.0):
        """(body_a, body_b, point, normal, depth) of every penetrating
        sample of a dynamic collider against another collider's shape.
        ``body_b`` is None for fixed-body colliders. Normals point out of
        the OTHER shape (the direction that pushes ``body_a`` free).
        Dynamic pairs are tested sample-vs-SDF both ways (rapier's role
        in `examples2d/basic2.rs:105-131`: dropped bodies stack)."""
        static_ids = [
            i
            for i, c in enumerate(self.colliders)
            if not self.bodies[c.body].is_dynamic
        ]
        dynamic_ids = [
            i
            for i, c in enumerate(self.colliders)
            if self.bodies[c.body].is_dynamic
        ]
        if not dynamic_ids:
            return []
        # Concatenate every dynamic collider's samples so each target
        # collider costs one vectorized query.
        pts_parts, owner_parts, cid_parts = [], [], []
        for cd_id in dynamic_ids:
            cd = self.colliders[cd_id]
            body = self.bodies[cd.body]
            local = self._collider_samples(cd)
            pts_parts.append(
                (local @ body.rotation.T + body.translation[None, :])
                .astype(np.float32)
            )
            owner_parts.append(np.full(len(local), cd.body, np.int64))
            cid_parts.append(np.full(len(local), cd_id, np.int64))
        all_pts = np.concatenate(pts_parts)
        owners = np.concatenate(owner_parts)
        sample_cid = np.concatenate(cid_parts)

        contacts = []
        for ct_id in static_ids + dynamic_ids:
            ct = self.colliders[ct_id]
            target_body = self.bodies[ct.body]
            R, t = self.collider_pose(ct_id)
            _, d, n = shp.project_point(
                ct.shape, torch.from_numpy(all_pts), torch.from_numpy(R),
                torch.from_numpy(t),
            )
            d = d.numpy()
            n = n.numpy()
            hit = d < margin
            if target_body.is_dynamic:
                # Skip the collider's own samples and same-body pairs.
                hit = hit & (owners != ct.body) & (sample_cid != ct_id)
            for i in np.where(hit)[0]:
                contacts.append(
                    (
                        self.bodies[owners[i]],
                        target_body if target_body.is_dynamic else None,
                        all_pts[i],
                        n[i].astype(np.float32),
                        float(-d[i]),
                    )
                )
        return contacts

    def _effective_mass(self, b: RigidBody, r: np.ndarray, axis: np.ndarray
                        ) -> float:
        if self.dim == 2:
            rn = r[0] * axis[1] - r[1] * axis[0]
            return b.inv_mass + rn * rn * b._inv_inertia()
        rn = np.cross(r, axis)
        R = b.rotation
        iw = R @ (b._inv_inertia() * (R.T @ rn))
        return b.inv_mass + float(np.dot(np.cross(iw, r), axis))

    def _rel_velocity(self, a, b, p):
        v = a.velocity_at_point(p)
        if b is not None:
            v = v - b.velocity_at_point(p)
        return v

    def _pair_effective_mass(self, a, b, p, axis):
        k = self._effective_mass(a, p - a.translation, axis)
        if b is not None:
            k += self._effective_mass(b, p - b.translation, axis)
        return k

    def _apply_pair_impulse(self, a, b, imp, p):
        a.apply_impulse_at_point(imp, p)
        if b is not None:
            b.apply_impulse_at_point(-imp, p)

    def _solve_contact_velocities(self, contacts):
        """Sequential impulses with accumulated-impulse clamping and a
        Coulomb friction cone; two-body contacts apply equal/opposite
        impulses."""
        if not contacts:
            return
        acc_n = [0.0] * len(contacts)
        for _ in range(self.contact_iterations):
            for ci, (a, b, p, n, _depth) in enumerate(contacts):
                v = self._rel_velocity(a, b, p)
                vn = float(np.dot(v, n))
                kn = self._pair_effective_mass(a, b, p, n)
                if kn <= 0.0:
                    continue
                j = -(1.0 + self.restitution) * vn / kn
                new_acc = max(acc_n[ci] + j, 0.0)
                dj = new_acc - acc_n[ci]
                acc_n[ci] = new_acc
                if dj != 0.0:
                    self._apply_pair_impulse(a, b, dj * n, p)
                # Friction: oppose the tangential relative velocity,
                # clamped to mu * normal impulse per iteration (no tangent
                # accumulator — adequate for resting stacks).
                if self.friction > 0.0 and acc_n[ci] > 0.0:
                    v = self._rel_velocity(a, b, p)
                    vt = v - float(np.dot(v, n)) * n
                    vt_norm = float(np.linalg.norm(vt))
                    if vt_norm > 1.0e-6:
                        t = vt / vt_norm
                        kt = self._pair_effective_mass(a, b, p, t)
                        if kt > 0.0:
                            jt = -vt_norm / kt
                            jt = float(
                                np.clip(
                                    jt,
                                    -self.friction * acc_n[ci],
                                    self.friction * acc_n[ci],
                                )
                            )
                            self._apply_pair_impulse(a, b, jt * t, p)

    def _project_positions(self, beta: float = 0.8, passes: int = 2):
        """Translate bodies out of residual penetration (depth beyond the
        slop), a position-level Baumgarte correction. Two-body contacts
        split the correction by inverse mass."""
        for _ in range(passes):
            contacts = self._find_contacts(margin=-self.contact_slop)
            if not contacts:
                return
            push: dict = {}

            def consider(body, corr, n):
                if corr <= 0.0 or not body.is_dynamic:
                    return
                key = id(body)
                best = push.get(key)
                if best is None or corr > best[1]:
                    push[key] = (body, corr, n)

            for a, b, _p, n, depth in contacts:
                corr = (depth - self.contact_slop) * beta
                if b is None:
                    consider(a, corr, n)
                else:
                    wa, wb = a.inv_mass, b.inv_mass
                    wsum = wa + wb
                    if wsum <= 0.0:
                        continue
                    consider(a, corr * wa / wsum, n)
                    consider(b, corr * wb / wsum, -n)
            for body, corr, n in push.values():
                body.translation = (
                    body.translation + corr * n
                ).astype(np.float32)
