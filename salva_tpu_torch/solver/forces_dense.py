"""Dense-layout non-pressure forces.

Port of ``salva_tpu.solver.forces_dense`` for the viscosity pair: XSPH
(`xsph_viscosity.rs:30-97`) and Monaghan artificial viscosity
(`artificial_viscosity.rs:40-125`), each computed as dense pair passes
over the shifted cell views, once per substep inside the dense solvers'
predict-advection stage. They run as plain PyTorch on every device: the
JAX package has no Pallas kernel for them.

Interface: ``apply(f: DenseFields) -> (accel [D, capf, C],
boundary_forces [D, capb, C] | None)``.

Not ported (``to_dense_force`` raises): Akinci 2013, WCSPH and He 2014
surface tension, DFSPH viscosity and the particle-wise elasticity force.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..kernels import get_kernel, w_dwr

EPSILON = float(torch.finfo(torch.float32).eps)


class DenseFields(NamedTuple):
    """Everything a dense force can read (positions frozen, velocities =
    post-divergence committed velocities under DFSPH, exactly like the
    gather path's StepContext at predict_advection time).

    ``jff``/``jfb``/``jbf``: neighbor-view functions (fluid-fluid,
    fluid-owner/boundary-j, boundary-owner/fluid-j) — flat rolls of the
    cell axis (see ``dense_common``), one per offset: the 3^dim cell
    stencil of a grid, or the ``brute_cells`` cyclic offsets of the brute
    tier (``n_offsets``)."""

    jff: object
    jfb: object
    jbf: object
    n_offsets: int
    P: torch.Tensor  # [D, capf, C]
    V: torch.Tensor  # [D, capf, C]
    M: torch.Tensor  # [capf, C]
    VOL: torch.Tensor  # [capf, C] particle volumes
    R0: torch.Tensor  # [capf, C]
    RHO: torch.Tensor  # [capf, C] densities
    FID: torch.Tensor  # [capf, C] int32
    maskf: torch.Tensor  # [capf, C]
    Pb: torch.Tensor  # [D, capb, C]
    Vbvel: torch.Tensor  # [D, capb, C]
    Volb: torch.Tensor  # [capb, C]
    maskb: torch.Tensor  # [capb, C]
    h: float
    dim: int
    dt: torch.Tensor
    inv_dt: torch.Tensor
    kernel_density: str
    kernel_gradient: str


def per_slot(values: Tuple[float, ...], FID):
    """Per-fluid coefficient tuple -> per-slot grid (static unrolled)."""
    out = torch.zeros(FID.shape, dtype=torch.float32, device=FID.device)
    for fid, v in enumerate(values):
        if v != 0.0:
            out = torch.where(
                FID == fid,
                torch.tensor(v, dtype=torch.float32, device=FID.device),
                out,
            )
    return out


def _pairs(f: DenseFields, which: str, j_arrays):
    """Yield (dpos, r2, within, j_views) for each neighbor view.

    ``which``: "ff" (fluid owner, fluid j), "fb" (fluid owner, boundary
    j), "bf" (boundary owner, fluid j).
    """
    dim, h = f.dim, f.h
    h2 = h * h
    if which == "ff":
        pos_i, mask_i, pos_j, mask_j, jview = f.P, f.maskf, f.P, f.maskf, f.jff
    elif which == "fb":
        pos_i, mask_i, pos_j, mask_j, jview = f.P, f.maskf, f.Pb, f.maskb, f.jfb
    else:
        pos_i, mask_i, pos_j, mask_j, jview = f.Pb, f.maskb, f.P, f.maskf, f.jbf
    for o in range(f.n_offsets):
        pj = jview(pos_j, o)
        mj = jview(mask_j, o)
        j = {k: jview(v, o) for k, v in j_arrays.items()}
        dpos = [pos_i[d][:, None, :] - pj[d][None, :, :] for d in range(dim)]
        r2 = dpos[0] * dpos[0]
        for d in range(1, dim):
            r2 = r2 + dpos[d] * dpos[d]
        within = (r2 <= h2) & (mask_i[:, None, :] > 0) & (mj[None, :, :] > 0)
        yield dpos, r2, within, j


@dataclasses.dataclass(frozen=True)
class XSPHViscosityDense:
    """Dense XSPH velocity smoothing (`xsph_viscosity.rs:30-97`)."""

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]

    def apply(self, f: DenseFields):
        kd_w, _ = get_kernel(f.kernel_density)
        coeff = per_slot(self.fluid_coefficients, f.FID)
        bcoeff = per_slot(self.boundary_coefficients, f.FID)
        dvel = torch.zeros_like(f.P)

        # Fluid part: same-fluid smoothing toward neighbor velocities.
        for dpos, r2, within, j in _pairs(
            f, "ff",
            {"v": f.V, "vol": f.VOL, "rho": f.RHO, "fid": f.FID},
        ):
            w = kd_w(torch.sqrt(r2), f.h, f.dim)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            factor = torch.where(
                ok,
                coeff[:, None, :] * w * j["vol"][None, :, :]
                * f.R0[:, None, :]
                / torch.clamp(j["rho"][None, :, :], min=EPSILON),
                0.0,
            )
            dvel = dvel + torch.stack(
                [
                    torch.sum(factor * (j["v"][d][None, :, :]
                                        - f.V[d][:, None, :]), dim=1)
                    for d in range(f.dim)
                ]
            )

        # Boundary part: smooth toward boundary velocities.
        any_b = any(v != 0.0 for v in self.boundary_coefficients)
        if any_b:
            for dpos, r2, within, j in _pairs(
                f, "fb", {"vb": f.Vbvel, "vol": f.Volb},
            ):
                w = kd_w(torch.sqrt(r2), f.h, f.dim)
                factor = torch.where(
                    within,
                    bcoeff[:, None, :] * w * j["vol"][None, :, :]
                    * f.R0[:, None, :]
                    / torch.clamp(f.RHO[:, None, :], min=EPSILON),
                    0.0,
                )
                dvel = dvel + torch.stack(
                    [
                        torch.sum(factor * (j["vb"][d][None, :, :]
                                            - f.V[d][:, None, :]), dim=1)
                        for d in range(f.dim)
                    ]
                )
            # Equal-and-opposite boundary feedback (owner = boundary).
            ci = (bcoeff * f.R0 / torch.clamp(f.RHO, min=EPSILON) * f.M
                  * f.inv_dt)
            Fb = torch.zeros_like(f.Pb)
            for dpos, r2, within, j in _pairs(
                f, "bf", {"ci": ci, "v": f.V},
            ):
                w = kd_w(torch.sqrt(r2), f.h, f.dim)
                factor = torch.where(within, w * j["ci"][None, :, :], 0.0)
                Fb = Fb - torch.stack(
                    [
                        torch.sum(factor * f.Volb[:, None, :]
                                  * (f.Vbvel[d][:, None, :]
                                     - j["v"][d][None, :, :]), dim=1)
                        for d in range(f.dim)
                    ]
                )
        else:
            Fb = None

        return dvel * f.inv_dt, Fb


@dataclasses.dataclass(frozen=True)
class ArtificialViscosityDense:
    """Dense Monaghan artificial viscosity
    (`artificial_viscosity.rs:40-125`; approaching pairs only)."""

    fluid_coefficients: Tuple[float, ...]
    boundary_coefficients: Tuple[float, ...]
    alphas: Tuple[float, ...]
    betas: Tuple[float, ...]
    speeds_of_sound: Tuple[float, ...]

    def apply(self, f: DenseFields):
        kg_w, kg_dw = get_kernel(f.kernel_gradient)
        coeff = per_slot(self.fluid_coefficients, f.FID)
        bcoeff = per_slot(self.boundary_coefficients, f.FID)
        alpha = per_slot(self.alphas, f.FID)
        beta = per_slot(self.betas, f.FID)
        sos = per_slot(self.speeds_of_sound, f.FID)
        eta2 = f.h * f.h * 0.01
        accel = torch.zeros_like(f.P)

        def grad_scale(r2):
            return w_dwr(r2, f.h, f.dim, kg_w, kg_dw)[1]

        # Fluid-fluid (same fluid, v.r < 0).
        for dpos, r2, within, j in _pairs(
            f, "ff",
            {"v": f.V, "vol": f.VOL, "rho": f.RHO, "fid": f.FID},
        ):
            dwr = grad_scale(r2)
            vr = torch.zeros_like(r2)
            for d in range(f.dim):
                vr = vr + dpos[d] * (f.V[d][:, None, :]
                                     - j["v"][d][None, :, :])
            rho_avg = (f.RHO[:, None, :] + j["rho"][None, :, :]) * 0.5
            mu = f.h * vr / (r2 + eta2)
            visc = sos[:, None, :] * alpha[:, None, :] * mu \
                - beta[:, None, :] * mu * mu
            ok = within & (vr < 0.0) \
                & (f.FID[:, None, :] == j["fid"][None, :, :])
            scale = torch.where(
                ok,
                coeff[:, None, :] * visc * j["vol"][None, :, :]
                * f.R0[:, None, :] / torch.clamp(rho_avg, min=EPSILON),
                0.0,
            )
            accel = accel + torch.stack(
                [torch.sum(dpos[d] * dwr * scale, dim=1)
                 for d in range(f.dim)]
            )

        any_b = any(v != 0.0 for v in self.boundary_coefficients)
        Fb = None
        if any_b:
            # Fluid-boundary term.
            for dpos, r2, within, j in _pairs(
                f, "fb", {"vb": f.Vbvel, "vol": f.Volb},
            ):
                dwr = grad_scale(r2)
                vr = torch.zeros_like(r2)
                for d in range(f.dim):
                    vr = vr + dpos[d] * (
                        f.V[d][:, None, :] - j["vb"][d][None, :, :]
                    )
                mu = f.h * vr / (r2 + eta2)
                visc = sos[:, None, :] * alpha[:, None, :] * mu \
                    - beta[:, None, :] * mu * mu
                scale = torch.where(
                    within & (vr < 0.0),
                    bcoeff[:, None, :] * visc * j["vol"][None, :, :]
                    * f.R0[:, None, :]
                    / torch.clamp(f.RHO[:, None, :], min=EPSILON),
                    0.0,
                )
                accel = accel + torch.stack(
                    [torch.sum(dpos[d] * dwr * scale, dim=1)
                     for d in range(f.dim)]
                )
            # Feedback (owner = boundary): contrib = -m_i * delta.
            ci_common = bcoeff * f.R0 / torch.clamp(f.RHO, min=EPSILON) * f.M
            ci_visc_a = sos * alpha
            Fb = torch.zeros_like(f.Pb)
            for dpos, r2, within, j in _pairs(
                f, "bf",
                {"c": ci_common, "sa": ci_visc_a, "b": beta, "v": f.V},
            ):
                dwr = grad_scale(r2)
                # dpos = p_b - p_i; fluid-frame r_ib = -dpos, v_ib = v_i - vb.
                vr = torch.zeros_like(r2)
                for d in range(f.dim):
                    vr = vr + (-dpos[d]) * (
                        j["v"][d][None, :, :] - f.Vbvel[d][:, None, :]
                    )
                mu = f.h * vr / (r2 + eta2)
                visc = j["sa"][None, :, :] * mu - j["b"][None, :, :] * mu * mu
                scale = torch.where(
                    within & (vr < 0.0),
                    j["c"][None, :, :] * visc * f.Volb[:, None, :],
                    0.0,
                )
                # grad_ij (w.r.t. fluid i) = -dpos * dwr; the contribution
                # to b is -m_i grad scale.
                Fb = Fb + torch.stack(
                    [torch.sum(dpos[d] * dwr * scale, dim=1)
                     for d in range(f.dim)]
                )
        return accel, Fb


def to_dense_force(force):
    """Dense counterpart of a merged force configuration; raises for the
    forces the port does not run yet."""
    from .viscosity import ArtificialViscosityForce, XSPHViscosityForce

    if isinstance(force, XSPHViscosityForce):
        return XSPHViscosityDense(
            force.fluid_coefficients, force.boundary_coefficients
        )
    if isinstance(force, ArtificialViscosityForce):
        return ArtificialViscosityDense(
            force.fluid_coefficients,
            force.boundary_coefficients,
            force.alphas,
            force.betas,
            force.speeds_of_sound,
        )
    raise NotImplementedError(
        f"{type(force).__name__} is not ported to salva_tpu_torch: the "
        "dense layout runs XSPH and artificial viscosity"
    )


def to_dense_forces(force_set) -> Tuple:
    """Convert a whole ForceSet (the empty set converts to ``()``)."""
    return tuple(to_dense_force(force) for force in force_set)
