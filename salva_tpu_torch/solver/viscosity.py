"""Viscosity models: XSPH, artificial (Monaghan) and DFSPH (implicit
strain-rate projection) viscosity.

Port of ``salva_tpu.solver.viscosity``: the merged per-type
configurations (one coefficient per fluid, 0 for fluids that do not carry
the force) and their gather-layout ``apply(ctx)``, vectorized [N, K]
contact reductions. The dense layout runs the same forces as
``solver/forces_dense.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import counters
from .common import StepContext, scatter_boundary_forces
from .nonpressure import per_particle, same_fluid_mask


@dataclasses.dataclass(frozen=True)
class XSPHViscosityForce:
    """Velocity-smoothing XSPH viscosity (`xsph_viscosity.rs:30-97`)."""

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]
    kind: str = dataclasses.field(default="xsph_viscosity", init=False)

    def apply(self, ctx: StepContext):
        coeff_i = per_particle(self.fluid_coefficients, ctx)
        bcoeff_i = per_particle(self.boundary_coefficients, ctx)
        fl = ctx.fluids
        vel = fl.velocities
        j, jb = ctx.ff.j, ctx.fb.j

        # Fluid part: dv_i = sum_j coeff W V_j rho0 / rho_j (v_j - v_i),
        # same fluid only (`xsph_viscosity.rs:55-71`).
        mask = same_fluid_mask(ctx).to(torch.float32)
        factor = (coeff_i[:, None] * ctx.ff.w * fl.volumes[j]
                  * fl.density0[:, None] / ctx.densities[j] * mask)
        dvel_f = torch.sum(factor[..., None] * (vel[j] - vel[:, None, :]),
                           dim=1)

        # Boundary part (`xsph_viscosity.rs:73-91`): smooth towards the
        # boundary velocities, push back on the boundary.
        bfactor = (bcoeff_i[:, None] * ctx.fb.w * ctx.boundaries.volumes[jb]
                   * fl.density0[:, None] / ctx.densities[:, None])
        delta = bfactor[..., None] * (ctx.boundaries.velocities[jb]
                                      - vel[:, None, :])
        dvel_b = torch.sum(delta, dim=1)
        bforces = scatter_boundary_forces(
            torch.zeros_like(ctx.boundaries.forces), ctx.fb,
            delta * (-fl.masses[:, None, None] * ctx.inv_dt))
        return (dvel_f + dvel_b) * ctx.inv_dt, bforces


@dataclasses.dataclass(frozen=True)
class ArtificialViscosityForce:
    """Monaghan artificial viscosity (`artificial_viscosity.rs:40-125`).

    Defaults alpha=1, beta=0, speed_of_sound=10 (`:30-36`).

    Deviation from the reference, as in ``salva_tpu``: the boundary force
    feedback applies each contact's own contribution; the reference
    accumulates the running per-particle sum into every subsequent
    contact (`artificial_viscosity.rs:113-116`), an upstream bug fixed
    consciously (``DESIGN.md``).
    """

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]
    alphas: Tuple[float, ...]
    betas: Tuple[float, ...]
    speeds_of_sound: Tuple[float, ...]
    kind: str = dataclasses.field(default="artificial_viscosity", init=False)

    def apply(self, ctx: StepContext):
        fl = ctx.fluids
        bd = ctx.boundaries
        h = ctx.h
        j, jb = ctx.ff.j, ctx.fb.j
        coeff_i = per_particle(self.fluid_coefficients, ctx)[:, None]
        bcoeff_i = per_particle(self.boundary_coefficients, ctx)[:, None]
        alpha_i = per_particle(self.alphas, ctx)[:, None]
        beta_i = per_particle(self.betas, ctx)[:, None]
        sos_i = per_particle(self.speeds_of_sound, ctx)[:, None]
        eta2 = h * h * 0.01

        # Fluid-fluid, same fluid, approaching pairs only (v.r < 0).
        mask = same_fluid_mask(ctx).to(torch.float32)
        r_ij = fl.positions[:, None, :] - fl.positions[j]
        v_ij = fl.velocities[:, None, :] - fl.velocities[j]
        vr = torch.sum(r_ij * v_ij, dim=-1)
        rho_avg = (ctx.densities[:, None] + ctx.densities[j]) * 0.5
        mu = h * vr / (torch.sum(r_ij * r_ij, dim=-1) + eta2)
        visc = sos_i * alpha_i * mu - beta_i * mu * mu
        scale = torch.where(
            vr < 0.0,
            coeff_i * visc * fl.volumes[j] * fl.density0[:, None] / rho_avg,
            0.0,
        ) * mask
        accel = torch.sum(ctx.ff.grad * scale[..., None], dim=1)

        # Fluid-boundary (`artificial_viscosity.rs:95-119`).
        rb = fl.positions[:, None, :] - bd.positions[jb]
        vb = fl.velocities[:, None, :] - bd.velocities[jb]
        vrb = torch.sum(rb * vb, dim=-1)
        mub = h * vrb / (torch.sum(rb * rb, dim=-1) + eta2)
        viscb = sos_i * alpha_i * mub - beta_i * mub * mub
        scaleb = torch.where(
            vrb < 0.0,
            bcoeff_i * viscb * bd.volumes[jb] * fl.density0[:, None]
            / ctx.densities[:, None],
            0.0,
        ) * ctx.fb.mask
        delta_b = ctx.fb.grad * scaleb[..., None]
        accel = accel + torch.sum(delta_b, dim=1)
        bforces = scatter_boundary_forces(
            torch.zeros_like(bd.forces), ctx.fb,
            delta_b * (-fl.masses[:, None, None]))
        return accel, bforces


def _spatial_dim(dim: int) -> int:
    """Size of the symmetric strain/stress vector: 3 in 2D, 6 in 3D."""
    return 3 if dim == 2 else 6


def _strain_rate(grad, v_ji, dim: int):
    """Symmetric strain-rate vector (`dfsph_viscosity.rs:38-57`):
    grad, v_ji [..., dim] -> [..., S]."""
    g, v = grad, v_ji
    if dim == 2:
        return torch.stack([
            2.0 * v[..., 0] * g[..., 0],
            2.0 * v[..., 1] * g[..., 1],
            v[..., 0] * g[..., 1] + v[..., 1] * g[..., 0],
        ], dim=-1)
    return torch.stack([
        2.0 * v[..., 0] * g[..., 0],
        2.0 * v[..., 1] * g[..., 1],
        2.0 * v[..., 2] * g[..., 2],
        v[..., 0] * g[..., 1] + v[..., 1] * g[..., 0],
        v[..., 0] * g[..., 2] + v[..., 2] * g[..., 0],
        v[..., 1] * g[..., 2] + v[..., 2] * g[..., 1],
    ], dim=-1)


def _gradient_matrix(grad, dim: int):
    """[..., S, dim] gradient matrix G (`dfsph_viscosity.rs:59-82`)."""
    z = torch.zeros_like(grad[..., 0])
    gx, gy = grad[..., 0], grad[..., 1]
    if dim == 2:
        rows = [[2.0 * gx, z], [z, 2.0 * gy], [gy, gx]]
    else:
        gz = grad[..., 2]
        rows = [
            [2.0 * gx, z, z],
            [z, 2.0 * gy, z],
            [z, z, 2.0 * gz],
            [gy, gx, z],
            [gz, z, gx],
            [z, gz, gy],
        ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


@dataclasses.dataclass(frozen=True)
class DFSPHViscosityForce:
    """Implicit strain-rate projection viscosity (`dfsph_viscosity.rs`).

    Per-fluid viscosity coefficients in [0, 1]; fluids with
    ``participating = 0`` are excluded from both the solve and the error
    mean (one joint loop whose termination uses the max over the
    participating fluids' mean errors, as in ``salva_tpu``).
    Fluid-internal only: no boundary term (`dfsph_viscosity.rs:82-86`).

    As ``salva_tpu`` documents, the reference's iteration diverges at its
    own gain on free blobs (`dfsph_viscosity.rs:308-313`); the port is
    faithful to that behavior.
    """

    viscosity_coefficients: Tuple[float, ...]
    participating: Tuple[int, ...]
    min_viscosity_iter: int = 1
    max_viscosity_iter: int = 50
    max_viscosity_error: float = 0.01
    kind: str = dataclasses.field(default="dfsph_viscosity", init=False)

    def apply(self, ctx: StepContext):
        dim = ctx.dim
        S = _spatial_dim(dim)
        fl = ctx.fluids
        j = ctx.ff.j
        rho = ctx.densities
        part_i = per_particle(self.participating, ctx)  # [N] 0/1
        nu_i = per_particle(self.viscosity_coefficients, ctx)
        mask = same_fluid_mask(ctx).to(torch.float32) * part_i[:, None]
        m_j = fl.masses[j]
        G = _gradient_matrix(ctx.ff.grad, dim)  # [N, K, S, dim]
        w_ij = m_j / (2.0 * rho[:, None]) * mask

        # Betas (`dfsph_viscosity.rs:130-197`).
        grad_i = G * w_ij[..., None, None]
        sq = torch.einsum("nksd,nktd->nst", grad_i, grad_i) / rho[:, None, None]
        gsum = torch.sum(grad_i, dim=1)  # [N, S, dim]
        denom = sq + torch.einsum("nsd,ntd->nst", gsum, gsum) / rho[:, None,
                                                                    None]
        diag = torch.diagonal(denom, dim1=-2, dim2=-1)
        inv_diag = torch.where(torch.abs(diag) < 1.0e-6, 1.0,
                               1.0 / torch.where(diag == 0, 1.0, diag))
        # D' = diag(p) @ D (`dfsph_viscosity.rs:171-175`).
        denom_p = denom * inv_diag[:, :, None]
        singular = torch.abs(torch.linalg.det(denom_p)) < 1.0e-6
        eye = torch.eye(S, dtype=denom_p.dtype, device=denom_p.device)
        safe = torch.where(singular[:, None, None], eye[None], denom_p)
        beta = torch.where(singular[:, None, None], 0.0,
                           torch.linalg.inv(safe))
        # beta = beta @ diag(p) (`dfsph_viscosity.rs:192-196`).
        beta = beta * inv_diag[:, None, :]

        def strain_rate(accel):
            v = fl.velocities + accel * ctx.dt
            rate = _strain_rate(ctx.ff.grad, v[j] - v[:, None, :], dim)
            return torch.sum(rate * w_ij[..., None], dim=1)

        target = strain_rate(torch.zeros_like(fl.positions)) * (
            1.0 - nu_i[:, None])
        live_part = fl.alive & (part_i > 0)
        sel = [live_part & (fl.fluid_id == f) for f in range(ctx.num_fluids)]
        counts = [torch.sum(m.to(torch.float32)) for m in sel]

        def mean_err(err_vec):
            contrib = torch.sum(torch.abs(err_vec), dim=-1) / 6.0
            err = torch.zeros((), dtype=torch.float32, device=rho.device)
            for m, cnt in zip(sel, counts):
                s = torch.sum(torch.where(m, contrib, 0.0))
                err = torch.maximum(
                    err,
                    torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0))
            return err

        vol_j = fl.volumes[j] * fl.density0[:, None] * 0.5 * mask

        def update(accel, err_vec):
            u = torch.einsum("nst,nt->ns", beta, err_vec) / (rho * rho)[:, None]
            coeff = (u[:, None, :] + u[j]) * vol_j[..., None]
            # accel += G^T coeff * (V_i rho0_i / dt)
            contrib = torch.einsum("nksd,nks->nd", G, coeff)
            return accel + contrib * (fl.volumes * fl.density0)[:, None] * (
                ctx.inv_dt)

        accel = torch.zeros_like(fl.positions)
        i = 0
        while i < self.max_viscosity_iter:
            err_vec = strain_rate(accel) - target
            err = mean_err(err_vec)
            counters.FORCE_ITERATIONS["dfsph_viscosity"] += 1
            done = (i >= self.min_viscosity_iter
                    and bool(counters.fetch("viscosity_converged",
                                            err <= self.max_viscosity_error)))
            i += 1
            if done:
                break
            accel = update(accel, err_vec)
        return accel, torch.zeros_like(ctx.boundaries.forces)
