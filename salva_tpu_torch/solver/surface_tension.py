"""Surface tension models: Akinci 2013, He 2014 and WCSPH cohesion.

Port of ``salva_tpu.solver.surface_tension``: the merged per-type
configurations (one coefficient per fluid, 0 for fluids that do not carry
the force) and their gather-layout ``apply(ctx)``. The dense layout runs
the same forces as ``solver/forces_dense.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..kernels import sph
from .common import StepContext, scatter_boundary_forces
from .nonpressure import per_particle, same_fluid_mask

_EPS = sph.EPSILON


def _unit_and_dist(dpos):
    """(direction, distance), the direction zero below f32 epsilon
    (`Unit::try_new_and_get` in the reference)."""
    dist = torch.sqrt(torch.sum(dpos * dpos, dim=-1))
    far = dist > _EPS
    safe = torch.where(far, dist, 1.0)
    return torch.where(far[..., None], dpos / safe[..., None], 0.0), dist


@dataclasses.dataclass(frozen=True)
class Akinci2013SurfaceTensionForce:
    """Cohesion + curvature + boundary adhesion
    (`akinci2013_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_adhesion_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="akinci2013_surface_tension",
                                  init=False)

    def apply(self, ctx: StepContext):
        fl = ctx.fluids
        bd = ctx.boundaries
        h, dim = ctx.h, ctx.dim
        j, jb = ctx.ff.j, ctx.fb.j
        coeff_i = per_particle(self.fluid_tension_coefficients, ctx)
        badh_i = per_particle(self.boundary_adhesion_coefficients, ctx)
        mask = same_fluid_mask(ctx).to(torch.float32)

        # Normals n_i = h * sum_j m_j / rho_j grad W (`:43-68`).
        normals = h * torch.sum(
            ctx.ff.grad * (fl.masses[j] / ctx.densities[j] * mask)[..., None],
            dim=1)

        # Cohesion + curvature (`:137-165`).
        dirv, dist = _unit_and_dist(fl.positions[:, None, :]
                                    - fl.positions[j])
        cohesion_acc = (dirv * sph.cohesion_kernel(dist, h, dim)[..., None]
                        * (-coeff_i[:, None] * fl.volumes[j]
                           * fl.density0[:, None])[..., None])
        curvature_acc = (normals[:, None, :] - normals[j]) * (
            -coeff_i[:, None, None])
        kij = 2.0 * fl.density0[:, None] / (ctx.densities[:, None]
                                           + ctx.densities[j])
        accel = torch.sum((curvature_acc + cohesion_acc)
                          * (kij * mask)[..., None], dim=1)

        # Boundary adhesion (`:167-190`).
        dirb, distb = _unit_and_dist(fl.positions[:, None, :]
                                     - bd.positions[jb])
        m_bj = bd.volumes[jb] * fl.density0[:, None]
        adhesion_acc = (dirb * sph.adhesion_kernel(distb, h, dim)[..., None]
                        * (badh_i[:, None] * m_bj * ctx.fb.mask)[..., None])
        accel = accel - torch.sum(adhesion_acc, dim=1)
        bforces = scatter_boundary_forces(
            torch.zeros_like(bd.forces), ctx.fb,
            adhesion_acc * fl.masses[:, None, None])
        return accel, bforces


@dataclasses.dataclass(frozen=True)
class He2014SurfaceTensionForce:
    """Color-field surface tension (`he2014_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_tension_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="he2014_surface_tension",
                                  init=False)

    def apply(self, ctx: StepContext):
        fl = ctx.fluids
        bd = ctx.boundaries
        j, jb = ctx.ff.j, ctx.fb.j
        coeff_i = per_particle(self.fluid_tension_coefficients, ctx)
        bcoeff_i = per_particle(self.boundary_tension_coefficients, ctx)
        mask = same_fluid_mask(ctx).to(torch.float32)
        m_j = fl.masses[j]
        rho_j = ctx.densities[j]
        rho_i = ctx.densities

        # Colors c_i = sum W m_j / rho_j + sum_b W V_b (`:40-75`).
        colors = (torch.sum(ctx.ff.w * m_j / rho_j * mask, dim=1)
                  + torch.sum(ctx.fb.w * bd.volumes[jb], dim=1))

        # gradc_i = |sum grad c_j m_j / rho_j / c_i|^2 (`:77-105`).
        safe_colors = torch.where(torch.abs(colors) > 0.0, colors, 1.0)
        gradc_vec = torch.sum(
            ctx.ff.grad * (colors[j] * m_j / rho_j * mask)[..., None], dim=1
        ) / safe_colors[:, None]
        gradcs = torch.sum(gradc_vec * gradc_vec, dim=-1)

        # Fluid force (`:138-158`).
        m_i = fl.masses
        gradsum = gradcs[:, None] + gradcs[j]
        f = ctx.ff.grad * ((m_i[:, None] / rho_i[:, None]) * (m_j / rho_j)
                           * gradsum * 0.5 * mask)[..., None]
        safe_m_i = torch.where(m_i > 0.0, m_i, 1.0)
        accel = torch.sum(f, dim=1) * (coeff_i / (2.0 * safe_m_i))[:, None]

        # Boundary force (`:160-178`).
        m_bj = bd.volumes[jb] * fl.density0[:, None]
        fb_f = ctx.fb.grad * (
            (m_i[:, None] / rho_i[:, None])
            * (m_bj / fl.density0[:, None])
            * gradcs[:, None]
            * bcoeff_i[:, None]
            * 0.25
            * ctx.fb.mask
        )[..., None]
        accel = accel + torch.sum(fb_f, dim=1) / safe_m_i[:, None]
        bforces = scatter_boundary_forces(torch.zeros_like(bd.forces),
                                          ctx.fb, -fb_f)
        return accel, bforces


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

    def apply(self, ctx: StepContext):
        fl = ctx.fluids
        bd = ctx.boundaries
        j, jb = ctx.ff.j, ctx.fb.j
        coeff_i = per_particle(self.fluid_tension_coefficients, ctx)
        bcoeff_i = per_particle(self.boundary_tension_coefficients, ctx)
        mask = same_fluid_mask(ctx).to(torch.float32)

        dpos = fl.positions[:, None, :] - fl.positions[j]
        vol_i = fl.volumes
        safe_vol = torch.where(vol_i > 0.0, vol_i, 1.0)
        scale = (-coeff_i[:, None] * ctx.ff.w * fl.volumes[j]
                 / safe_vol[:, None])
        accel = torch.sum(dpos * (scale * mask)[..., None], dim=1)

        dposb = fl.positions[:, None, :] - bd.positions[jb]
        m_i = vol_i * fl.density0
        safe_m_i = torch.where(m_i > 0.0, m_i, 1.0)
        forceb = dposb * (
            bcoeff_i[:, None]
            * ctx.fb.w
            * bd.volumes[jb]
            * fl.density0[:, None]
            * ctx.fb.mask
        )[..., None]
        accel = accel - torch.sum(forceb, dim=1) / safe_m_i[:, None]
        bforces = scatter_boundary_forces(torch.zeros_like(bd.forces),
                                          ctx.fb, forceb)
        return accel, bforces
