"""Dense-layout non-pressure forces.

Port of ``salva_tpu.solver.forces_dense``: XSPH
(`xsph_viscosity.rs:30-97`), Monaghan artificial viscosity
(`artificial_viscosity.rs:40-125`), Akinci 2013, WCSPH and He 2014
surface tension and the DFSPH implicit viscosity, each computed as dense
pair passes over the shifted cell views, once per substep inside the
dense solvers' predict-advection stage. They run as plain PyTorch on
every device: the JAX package has no Pallas kernel for them.

Interface: ``apply(f: DenseFields) -> (accel [D, capf, C],
boundary_forces [D, capb, C] | None)``.

The Becker 2009 elasticity runs inside the dense substeps as
``ParticleWiseForce``: it reads only positions and its static rest
contact table, so the solvers evaluate it in particle layout and bin its
acceleration into the grid once. ``CustomForce`` has no dense form
(``to_dense_force`` returns None), so a world carrying one runs the
gather layout. On the slab path (``parallel/domain.py``)
``DenseFields.halo`` exchanges the ghost layers of the intermediates a
later pass reads at j (Akinci's normals, He 2014's colours and squared
colour gradients, the DFSPH viscosity's iterate), and ``interior``
restricts the viscosity's mean error to the owned slots.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..kernels import get_kernel, sph, w_dwr

EPSILON = float(torch.finfo(torch.float32).eps)


class DenseFields(NamedTuple):
    """Everything a dense force can read (positions frozen, velocities =
    post-divergence committed velocities under DFSPH, exactly like the
    gather path's StepContext at predict_advection time).

    ``jff``/``jfb``/``jbf``: neighbor-view functions (fluid-fluid,
    fluid-owner/boundary-j, boundary-owner/fluid-j) — flat rolls of the
    cell axis, or neighbour-table gathers on the compact layout (see
    ``dense_common``), one per offset: the 3^dim cell stencil of a grid,
    or the ``brute_cells`` cyclic offsets of the brute tier
    (``n_offsets``)."""

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
    # The slab path (parallel/domain.py): one slab's ghost-layer exchange,
    # for per-force intermediates computed on owned cells but read at j.
    # None on one device.
    halo: object = None
    # Slot ownership on the slab path ([1, C] bool, owned layers True), for
    # the global mean-error rule of the iterative forces.
    interior: object = None


def _exchange(f: "DenseFields", arr):
    """``arr`` with its ghost layers refreshed on the slab path."""
    return arr if f.halo is None else f.halo.exchange(arr)


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


@dataclasses.dataclass(frozen=True)
class Akinci2013SurfaceTensionDense:
    """Dense Akinci 2013 cohesion + curvature + boundary adhesion
    (`akinci2013_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_adhesion_coefficients: Tuple[float, ...]

    def apply(self, f: DenseFields):
        kg_w, kg_dw = get_kernel(f.kernel_gradient)
        coeff = per_slot(self.fluid_tension_coefficients, f.FID)
        badh = per_slot(self.boundary_adhesion_coefficients, f.FID)

        def dwr_of(r2):
            return w_dwr(r2, f.h, f.dim, kg_w, kg_dw)[1]

        # Pass 1: normals n_i = h sum m_j / rho_j grad (`:43-68`).
        N = torch.zeros_like(f.P)
        for dpos, r2, within, j in _pairs(
            f, "ff", {"m": f.M, "rho": f.RHO, "fid": f.FID},
        ):
            dwr = dwr_of(r2)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            s = torch.where(
                ok, j["m"][None, :, :]
                / torch.clamp(j["rho"][None, :, :], min=EPSILON), 0.0
            ) * dwr
            N = N + torch.stack(
                [f.h * torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
            )
        # Normals at ghost columns saw half a neighbourhood; pass 2 reads
        # n_j.
        N = _exchange(f, N)

        # Pass 2: cohesion + curvature (`:137-165`).
        accel = torch.zeros_like(f.P)
        for dpos, r2, within, j in _pairs(
            f, "ff", {"vol": f.VOL, "rho": f.RHO, "fid": f.FID, "n": N},
        ):
            r = torch.sqrt(r2)
            safe = torch.where(r > EPSILON, r, 1.0)
            coh_w = sph.cohesion_kernel(r, f.h, f.dim)
            coh_s = torch.where(
                r > EPSILON,
                -coeff[:, None, :] * j["vol"][None, :, :]
                * f.R0[:, None, :] * coh_w / safe,
                0.0,
            )
            kij = 2.0 * f.R0[:, None, :] / torch.clamp(
                f.RHO[:, None, :] + j["rho"][None, :, :], min=EPSILON
            )
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            w_all = torch.where(ok, kij, 0.0)
            accel = accel + torch.stack(
                [
                    torch.sum(
                        (dpos[d] * coh_s
                         - coeff[:, None, :]
                         * (N[d][:, None, :] - j["n"][d][None, :, :]))
                        * w_all,
                        dim=1,
                    )
                    for d in range(f.dim)
                ]
            )

        # Pass 3: boundary adhesion (`:167-190`).
        any_b = any(v != 0.0 for v in self.boundary_adhesion_coefficients)
        Fb = None
        if any_b:
            for dpos, r2, within, j in _pairs(f, "fb", {"vol": f.Volb}):
                r = torch.sqrt(r2)
                safe = torch.where(r > EPSILON, r, 1.0)
                adh = sph.adhesion_kernel(r, f.h, f.dim)
                s = torch.where(
                    within & (r > EPSILON),
                    badh[:, None, :] * j["vol"][None, :, :]
                    * f.R0[:, None, :] * adh / safe,
                    0.0,
                )
                accel = accel - torch.stack(
                    [torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
                )
            # Feedback (owner = boundary): F_b += sum_i adh_acc_i * m_i.
            ci = badh * f.R0 * f.M
            Fb = torch.zeros_like(f.Pb)
            for dpos, r2, within, j in _pairs(f, "bf", {"c": ci}):
                r = torch.sqrt(r2)
                safe = torch.where(r > EPSILON, r, 1.0)
                adh = sph.adhesion_kernel(r, f.h, f.dim)
                s = torch.where(
                    within & (r > EPSILON),
                    j["c"][None, :, :] * f.Volb[:, None, :] * adh / safe,
                    0.0,
                )
                # The direction from i to b as the owner b sees it: -dpos
                # (dpos = p_b - p_i).
                Fb = Fb - torch.stack(
                    [torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
                )
        return accel, Fb


@dataclasses.dataclass(frozen=True)
class WCSPHSurfaceTensionDense:
    """Dense WCSPH position-difference cohesion
    (`wcsph_surface_tension.rs`; boundary loop fixed as in the gather
    implementation, ``DESIGN.md``)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_tension_coefficients: Tuple[float, ...]

    def apply(self, f: DenseFields):
        kd_w, _ = get_kernel(f.kernel_density)
        coeff = per_slot(self.fluid_tension_coefficients, f.FID)
        bcoeff = per_slot(self.boundary_tension_coefficients, f.FID)
        safe_vol = torch.where(f.VOL > 0, f.VOL, 1.0)
        accel = torch.zeros_like(f.P)

        for dpos, r2, within, j in _pairs(
            f, "ff", {"vol": f.VOL, "fid": f.FID},
        ):
            w = kd_w(torch.sqrt(r2), f.h, f.dim)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            scale = torch.where(
                ok,
                -coeff[:, None, :] * w * j["vol"][None, :, :]
                / safe_vol[:, None, :],
                0.0,
            )
            accel = accel + torch.stack(
                [torch.sum(dpos[d] * scale, dim=1) for d in range(f.dim)]
            )

        any_b = any(v != 0.0 for v in self.boundary_tension_coefficients)
        Fb = None
        if any_b:
            safe_m = torch.where(f.M > 0, f.M, 1.0)
            for dpos, r2, within, j in _pairs(f, "fb", {"vol": f.Volb}):
                w = kd_w(torch.sqrt(r2), f.h, f.dim)
                scale = torch.where(
                    within,
                    bcoeff[:, None, :] * w * j["vol"][None, :, :]
                    * f.R0[:, None, :],
                    0.0,
                )
                accel = accel - torch.stack(
                    [torch.sum(dpos[d] * scale, dim=1) / safe_m
                     for d in range(f.dim)]
                )
            ci = bcoeff * f.R0
            Fb = torch.zeros_like(f.Pb)
            for dpos, r2, within, j in _pairs(f, "bf", {"c": ci}):
                w = kd_w(torch.sqrt(r2), f.h, f.dim)
                scale = torch.where(
                    within, j["c"][None, :, :] * f.Volb[:, None, :] * w, 0.0
                )
                # The fluid frame's force used dposb = p_i - p_b = -dpos.
                Fb = Fb - torch.stack(
                    [torch.sum(dpos[d] * scale, dim=1) for d in range(f.dim)]
                )
        return accel, Fb


@dataclasses.dataclass(frozen=True)
class He2014SurfaceTensionDense:
    """Dense He 2014 color-field surface tension
    (`he2014_surface_tension.rs`)."""

    fluid_tension_coefficients: Tuple[float, ...]
    boundary_tension_coefficients: Tuple[float, ...]

    def apply(self, f: DenseFields):
        kd_w, _ = get_kernel(f.kernel_density)
        kg_w, kg_dw = get_kernel(f.kernel_gradient)
        coeff = per_slot(self.fluid_tension_coefficients, f.FID)
        bcoeff = per_slot(self.boundary_tension_coefficients, f.FID)

        def dwr_of(r2):
            return w_dwr(r2, f.h, f.dim, kg_w, kg_dw)[1]

        vol_over_rho = f.M / torch.clamp(f.RHO, min=EPSILON)

        # Pass 1: colors (`:40-75`).
        colors = torch.zeros_like(f.maskf)
        for dpos, r2, within, j in _pairs(
            f, "ff", {"vr": vol_over_rho, "fid": f.FID},
        ):
            w = kd_w(torch.sqrt(r2), f.h, f.dim)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            colors = colors + torch.sum(
                torch.where(ok, w * j["vr"][None, :, :], 0.0), dim=1
            )
        for dpos, r2, within, j in _pairs(f, "fb", {"vol": f.Volb}):
            w = kd_w(torch.sqrt(r2), f.h, f.dim)
            colors = colors + torch.sum(
                torch.where(within, w * j["vol"][None, :, :], 0.0), dim=1
            )
        colors = _exchange(f, colors)

        # Pass 2: |grad c|^2 (`:77-105`).
        safe_colors = torch.where(torch.abs(colors) > 0, colors, 1.0)
        gradc = torch.zeros_like(f.P)
        for dpos, r2, within, j in _pairs(
            f, "ff", {"vr": vol_over_rho, "c": colors, "fid": f.FID},
        ):
            dwr = dwr_of(r2)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            s = torch.where(
                ok, j["c"][None, :, :] * j["vr"][None, :, :], 0.0
            ) * dwr
            gradc = gradc + torch.stack(
                [torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
            )
        gradc = gradc / safe_colors[None]
        gradcs = _exchange(f, torch.sum(gradc * gradc, dim=0))

        # Pass 3: fluid force (`:138-158`).
        m_over_rho = f.M / torch.clamp(f.RHO, min=EPSILON)
        safe_m = torch.where(f.M > 0, f.M, 1.0)
        accel = torch.zeros_like(f.P)
        for dpos, r2, within, j in _pairs(
            f, "ff", {"mr": m_over_rho, "g": gradcs, "fid": f.FID},
        ):
            dwr = dwr_of(r2)
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            s = torch.where(
                ok,
                m_over_rho[:, None, :] * j["mr"][None, :, :]
                * (gradcs[:, None, :] + j["g"][None, :, :]) * 0.5,
                0.0,
            ) * dwr
            accel = accel + torch.stack(
                [torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
            )
        accel = accel * (coeff / (2.0 * safe_m))[None]

        # Pass 4: boundary force (`:160-178`) and its feedback.
        any_b = any(v != 0.0 for v in self.boundary_tension_coefficients)
        Fb = None
        if any_b:
            for dpos, r2, within, j in _pairs(f, "fb", {"vol": f.Volb}):
                dwr = dwr_of(r2)
                s = torch.where(
                    within,
                    (f.M / torch.clamp(f.RHO, min=EPSILON))[:, None, :]
                    * j["vol"][None, :, :] * gradcs[:, None, :]
                    * bcoeff[:, None, :] * 0.25,
                    0.0,
                ) * dwr
                accel = accel + torch.stack(
                    [torch.sum(dpos[d] * s, dim=1) / safe_m
                     for d in range(f.dim)]
                )
            ci = ((f.M / torch.clamp(f.RHO, min=EPSILON)) * gradcs * bcoeff
                  * 0.25)
            Fb = torch.zeros_like(f.Pb)
            for dpos, r2, within, j in _pairs(f, "bf", {"c": ci}):
                dwr = dwr_of(r2)
                s = torch.where(
                    within, j["c"][None, :, :] * f.Volb[:, None, :], 0.0
                ) * dwr
                # The fluid frame's force is grad_i s = -dpos dwr s (dpos
                # here is p_b - p_i); the feedback is its opposite.
                Fb = Fb + torch.stack(
                    [torch.sum(dpos[d] * s, dim=1) for d in range(f.dim)]
                )
        return accel, Fb


def _strain_entries(dim):
    """The nonzero entries of the [S, dim] strain operator G(g), S(g, v) =
    G(g) . v (`dfsph_viscosity.rs:59-82`), as (s, d, factor, k): G[s][d] =
    factor * g[k]."""
    if dim == 2:
        return ((0, 0, 2.0, 0), (1, 1, 2.0, 1), (2, 0, 1.0, 1),
                (2, 1, 1.0, 0))
    return ((0, 0, 2.0, 0), (1, 1, 2.0, 1), (2, 2, 2.0, 2),
            (3, 0, 1.0, 1), (3, 1, 1.0, 0), (4, 0, 1.0, 2), (4, 2, 1.0, 0),
            (5, 1, 1.0, 2), (5, 2, 1.0, 1))


@dataclasses.dataclass(frozen=True)
class DFSPHViscosityDense:
    """Dense implicit strain-rate projection viscosity
    (`dfsph_viscosity.rs`; fluid-internal only, `:82-86`).

    Hoisting (positions frozen, w_ij = m_j / (2 rho_i) restricted to
    same-fluid participating pairs; G(g) is the [S, dim] strain operator
    with S(g, v) = G(g) . v):

    - per substep: ``Msum_i = sum_j w G_ij`` [S, dim], ``sq_i = sum_j
      (w G)(w G)^T / rho_i`` [S, S] and ``Nsum_i = sum_j vol_j G_ij^T``
      [dim, S];
    - per iteration: one S-channel pass ``TS_i = sum_j w G_ij v_j'`` for
      the strain rate and one dim-channel pass ``U_i = sum_j vol_j G_ij^T
      u_j`` for the update.

    The JAX package's ``lax.while_loop`` is a host loop here, with one
    sync an iteration (the convergence test), as in the port's pressure
    solvers; each iteration adds one to
    ``counters.FORCE_ITERATIONS["dfsph_viscosity"]``. Only the nonzero
    entries of G enter the sums (the zero ones add exact zeros). The
    batched [cap, C, S, S] determinant and inverse are library calls, as
    the JAX package leaves them to XLA.
    """

    viscosity_coefficients: Tuple[float, ...]
    participating: Tuple[int, ...]
    min_viscosity_iter: int = 1
    max_viscosity_iter: int = 50
    max_viscosity_error: float = 0.01

    def apply(self, f: DenseFields):
        from .. import counters

        dim = f.dim
        S = 3 if dim == 2 else 6
        entries = _strain_entries(dim)
        kg_w, kg_dw = get_kernel(f.kernel_gradient)
        nu = per_slot(self.viscosity_coefficients, f.FID)
        part = per_slot(tuple(float(v) for v in self.participating), f.FID)
        rho = torch.clamp(f.RHO, min=EPSILON)
        shape = tuple(f.maskf.shape)
        zero = torch.zeros(shape, dtype=torch.float32, device=f.P.device)

        def dwr_of(r2):
            return w_dwr(r2, f.h, f.dim, kg_w, kg_dw)[1]

        def g_rows(dpos, r2):
            """{(s, d): G[s][d]} of each pair, nonzero entries only."""
            dwr = dwr_of(r2)
            g = [dpos[d] * dwr for d in range(dim)]
            return {(s, d): g[k] * c if c != 1.0 else g[k]
                    for s, d, c, k in entries}

        def same(j):
            return torch.where(
                f.FID[:, None, :] == j["fid"][None, :, :], 1.0, 0.0)

        # --- per-substep hoists ------------------------------------------
        Msum = {(s, d): zero for s, d, _, _ in entries}
        Sq = {}
        Nsum = {(s, d): zero for s, d, _, _ in entries}
        for dpos, r2, within, j in _pairs(
            f, "ff", {"m": f.M, "vol": f.VOL, "fid": f.FID}
        ):
            ok = within & (f.FID[:, None, :] == j["fid"][None, :, :])
            okf = torch.where(ok, 1.0, 0.0) * part[:, None, :]
            rows = g_rows(dpos, r2)
            w_pair = j["m"][None, :, :] / (2.0 * rho[:, None, :]) * okf
            vol_pair = j["vol"][None, :, :] * okf
            wG = {e: v * w_pair for e, v in rows.items()}
            for e in wG:
                Msum[e] = Msum[e] + torch.sum(wG[e], dim=1)
                Nsum[e] = Nsum[e] + torch.sum(rows[e] * vol_pair, dim=1)
            # (wG)(wG)^T / rho_i, reduced over j: symmetric, so s <= t.
            for s in range(S):
                for t in range(s, S):
                    terms = [wG[(s, d)] * wG[(t, d)] for d in range(dim)
                             if (s, d) in wG and (t, d) in wG]
                    if terms:
                        acc = terms[0]
                        for term in terms[1:]:
                            acc = acc + term
                        Sq[(s, t)] = (Sq.get((s, t), zero)
                                      + torch.sum(acc, dim=1) / rho)

        # Beta: diag-preconditioned inverse of (Sq + Msum Msum^T / rho)
        # (`dfsph_viscosity.rs:130-197`).
        rows_D = []
        for s in range(S):
            row = []
            for t in range(S):
                mm = [Msum[(s, d)] * Msum[(t, d)] for d in range(dim)
                      if (s, d) in Msum and (t, d) in Msum]
                mmt = zero
                for term in mm:
                    mmt = mmt + term
                row.append(Sq.get((min(s, t), max(s, t)), zero) + mmt / rho)
            rows_D.append(torch.stack(row, dim=-1))
        D = torch.stack(rows_D, dim=-2)  # [cap, C, S, S]
        diag = torch.diagonal(D, dim1=-2, dim2=-1)
        inv_diag = torch.where(
            torch.abs(diag) < 1.0e-6, 1.0,
            1.0 / torch.where(diag == 0, 1.0, diag),
        )
        Dp = D * inv_diag[..., :, None]
        det = torch.linalg.det(Dp)
        singular = torch.abs(det) < 1.0e-6
        eye = torch.eye(S, dtype=Dp.dtype, device=Dp.device)
        safe = torch.where(singular[..., None, None], eye, Dp)
        beta = torch.where(singular[..., None, None], 0.0,
                           torch.linalg.inv(safe))
        beta = beta * inv_diag[..., None, :]  # [cap, C, S, S]

        # --- per-iteration passes ----------------------------------------
        def ts_pass(Vp):
            """TS_i = sum_j w G_ij v_j' [S]."""
            acc = [zero] * S
            for dpos, r2, within, j in _pairs(
                f, "ff", {"m": f.M, "v": Vp, "fid": f.FID}
            ):
                w_pair = (
                    torch.where(within, same(j), 0.0) * part[:, None, :]
                    * j["m"][None, :, :] / (2.0 * rho[:, None, :])
                )
                rows = g_rows(dpos, r2)
                for s in range(S):
                    gv = None
                    for d in range(dim):
                        if (s, d) in rows:
                            t = rows[(s, d)] * j["v"][d][None, :, :]
                            gv = t if gv is None else gv + t
                    acc[s] = acc[s] + torch.sum(gv * w_pair, dim=1)
            return torch.stack(acc)

        def u_pass(U):
            """U_i = sum_j vol_j G_ij^T u_j [dim]."""
            acc = [zero] * dim
            for dpos, r2, within, j in _pairs(
                f, "ff", {"vol": f.VOL, "u": U, "fid": f.FID}
            ):
                vol_pair = (
                    torch.where(within, same(j), 0.0) * part[:, None, :]
                    * j["vol"][None, :, :]
                )
                rows = g_rows(dpos, r2)
                for d in range(dim):
                    gu = None
                    for s in range(S):
                        if (s, d) in rows:
                            t = rows[(s, d)] * j["u"][s][None, :, :]
                            gu = t if gu is None else gu + t
                    acc[d] = acc[d] + torch.sum(gu * vol_pair, dim=1)
            return torch.stack(acc)

        def strain_rate(accel):
            vp = f.V + accel * f.dt
            ts = ts_pass(vp)
            own = []
            for s in range(S):
                o = zero
                for d in range(dim):
                    if (s, d) in Msum:
                        o = o + Msum[(s, d)] * vp[d]
                own.append(o)
            return ts - torch.stack(own)

        target = strain_rate(torch.zeros_like(f.P)) * (1.0 - nu)[None]

        live_part = (f.maskf > 0) & (part > 0)
        if f.interior is not None:
            # The slab path: reduce over owned slots, summed over the
            # slabs for the reference's global mean-error rule.
            live_part = live_part & f.interior
        sel = [live_part & (f.FID == fl)
               for fl in range(len(self.viscosity_coefficients))]
        counts = [torch.sum(torch.where(m, 1.0, 0.0)) for m in sel]
        if f.halo is not None:
            counts = [f.halo.psum(c) for c in counts]

        def mean_err(err_vec):
            contrib = torch.sum(torch.abs(err_vec), dim=0) / 6.0
            err = torch.zeros((), dtype=torch.float32, device=f.P.device)
            for m, cnt in zip(sel, counts):
                s = torch.sum(torch.where(m, contrib, 0.0))
                if f.halo is not None:
                    s = f.halo.psum(s)
                err = torch.maximum(
                    err,
                    torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0))
            return err

        def update(a, err_vec):
            ev = torch.movedim(err_vec, 0, -1)  # [cap, C, S]
            u = torch.einsum("...st,...t->...s", beta, ev)
            u = torch.movedim(u, -1, 0) / (rho * rho)[None]  # [S, cap, C]
            # u is valid on owned cells; u_pass reads u at j.
            u = _exchange(f, u)
            upass = u_pass(u)
            own = []
            for d in range(dim):
                o = zero
                for s in range(S):
                    if (s, d) in Nsum:
                        o = o + Nsum[(s, d)] * u[s]
                own.append(o)
            contrib = (torch.stack(own) + upass) * (f.R0 * 0.5)[None]
            return a + contrib * (f.VOL * f.R0)[None] * f.inv_dt

        accel = torch.zeros_like(f.P)
        i = 0
        while i < self.max_viscosity_iter:
            # ts_pass reads (V + accel dt) at j.
            accel = _exchange(f, accel)
            err_vec = strain_rate(accel) - target
            err = mean_err(err_vec)
            counters.FORCE_ITERATIONS["dfsph_viscosity"] += 1
            done = (i >= self.min_viscosity_iter
                    and bool(err <= self.max_viscosity_error))
            i += 1
            if done:
                break
            accel = update(accel, err_vec)
        return accel, None


@dataclasses.dataclass(frozen=True)
class ParticleWiseForce:
    """Dense-substep adapter for forces evaluated in particle layout.

    The Becker elasticity reads only positions and its static rest
    contact table (`becker2009_elasticity.rs:268-334`), no spatial
    search, so the dense substeps run ``force.apply_particles(fluids, es,
    dim)`` on the particle arrays and bin its acceleration into the grid
    once; elastic fluids stay on the dense layout."""

    force: object


def to_dense_force(force):
    """Dense counterpart of a merged force configuration, or None (a
    custom force)."""
    from .elasticity import Becker2009ElasticityForce
    from .surface_tension import (
        Akinci2013SurfaceTensionForce,
        He2014SurfaceTensionForce,
        WCSPHSurfaceTensionForce,
    )
    from .viscosity import (
        ArtificialViscosityForce,
        DFSPHViscosityForce,
        XSPHViscosityForce,
    )

    if isinstance(force, Becker2009ElasticityForce):
        return ParticleWiseForce(force)
    if isinstance(force, DFSPHViscosityForce):
        return DFSPHViscosityDense(
            force.viscosity_coefficients,
            force.participating,
            force.min_viscosity_iter,
            force.max_viscosity_iter,
            force.max_viscosity_error,
        )
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
    if isinstance(force, Akinci2013SurfaceTensionForce):
        return Akinci2013SurfaceTensionDense(
            force.fluid_tension_coefficients,
            force.boundary_adhesion_coefficients,
        )
    if isinstance(force, WCSPHSurfaceTensionForce):
        return WCSPHSurfaceTensionDense(
            force.fluid_tension_coefficients,
            force.boundary_tension_coefficients,
        )
    if isinstance(force, He2014SurfaceTensionForce):
        return He2014SurfaceTensionDense(
            force.fluid_tension_coefficients,
            force.boundary_tension_coefficients,
        )
    return None


def to_dense_forces(force_set) -> Optional[Tuple]:
    """Convert a whole ForceSet (the empty set converts to ``()``), or
    None if a member has no dense form."""
    out = []
    for force in force_set:
        dense = to_dense_force(force)
        if dense is None:
            return None
        out.append(dense)
    return tuple(out)
