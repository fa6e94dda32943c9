"""Implicit Incompressible SPH on the gather layout (Ihmsen et al.).

Port of ``salva_tpu.solver.iisph`` (``src/solver/pressure/
iisph_solver.rs``): relaxed-Jacobi pressure iteration (omega = 0.5) as a
host loop over masked [N, K] contact reductions (one host sync per
iteration, the convergence test; the count follows the JAX loop: it
increments on every iteration, including the one that finds convergence,
whose pressures are kept), with warm-started pressures halved at every
step start (`iisph_solver.rs:673-677`).

Step order matches `iisph_solver.rs:643-711`: non-pressure forces ->
fold accelerations -> d_ii -> warm start -> rho* -> a_ii -> pressure loop
-> velocity changes -> integrate.
"""

from __future__ import annotations

import torch

from .. import counters
from ..config import IISPHConfig
from .common import (
    SolverDiagnostics,
    StepContext,
    per_fluid_mean_max,
    scatter_boundary_forces,
)
from .dfsph import _dot
from .dfsph_dense import _converged


def compute_dii(ctx: StepContext):
    """d_ii = -dt^2 / rho_i^2 * sum m_j grad (`iisph_solver.rs:144-186`)."""
    rho = ctx.densities
    factor = -(ctx.dt * ctx.dt) / (rho * rho)
    ff_sum = torch.sum(ctx.ff.grad * ctx.ff_mass_j()[..., None], dim=1)
    fb_sum = torch.sum(ctx.fb.grad * ctx.fb_mass_j()[..., None], dim=1)
    return (ff_sum + fb_sum) * factor[:, None]


def compute_aii(ctx: StepContext, dii):
    """a_ii = sum m_j (d_ii - d_ji) . grad (`iisph_solver.rs:188-233`),
    d_ji = grad * dt^2 m_i / rho_i^2."""
    rho = ctx.densities
    factor = (ctx.dt * ctx.dt) * ctx.masses / (rho * rho)
    term_ff = torch.sum(ctx.ff_mass_j() * _dot(
        dii[:, None, :] - ctx.ff.grad * factor[:, None, None], ctx.ff.grad),
        dim=1)
    term_fb = torch.sum(ctx.fb_mass_j() * _dot(
        dii[:, None, :] - ctx.fb.grad * factor[:, None, None], ctx.fb.grad),
        dim=1)
    return term_ff + term_fb


def compute_predicted_densities(ctx: StepContext, velocity_changes):
    """rho* = rho + dt * sum m_j (v_i + dv_i - v_j - dv_j) . grad
    (`iisph_solver.rs:92-142`, no clamping)."""
    v = ctx.fluids.velocities + velocity_changes
    ff_term = torch.sum(
        ctx.ff_mass_j() * _dot(v[:, None, :] - v[ctx.ff.j], ctx.ff.grad),
        dim=1)
    dv_fb = v[:, None, :] - ctx.boundaries.velocities[ctx.fb.j]
    fb_term = torch.sum(ctx.fb_mass_j() * _dot(dv_fb, ctx.fb.grad), dim=1)
    return ctx.densities + (ff_term + fb_term) * ctx.dt


def compute_dij_pjl(ctx: StepContext, pressures):
    """dt^2 * sum_ff grad * (-m_j p_j / rho_j^2)
    (`iisph_solver.rs:235-268`; fluid-fluid only)."""
    rho_j = ctx.densities[ctx.ff.j]
    coeff = -ctx.ff_mass_j() * pressures[ctx.ff.j] / (rho_j * rho_j)
    return (torch.sum(ctx.ff.grad * coeff[..., None], dim=1)
            * (ctx.dt * ctx.dt))


def compute_next_pressures(cfg: IISPHConfig, ctx: StepContext, pressures,
                           dij_pjl, dii, aii, predicted_densities):
    """Relaxed Jacobi update and per-particle compressibility error
    (`iisph_solver.rs:270-353`)."""
    rho = ctx.densities
    factor_i = (ctx.dt * ctx.dt) * ctx.masses / (rho * rho)
    j = ctx.ff.j
    dji = ctx.ff.grad * factor_i[:, None, None]
    inner = (
        dij_pjl[:, None, :]
        - dii[j] * pressures[j][..., None]
        - (dij_pjl[j] - dji * pressures[:, None, None])
    )
    sum_ff = torch.sum(ctx.ff_mass_j() * _dot(inner, ctx.ff.grad), dim=1)
    sum_fb = torch.sum(
        ctx.fb_mass_j() * _dot(dij_pjl[:, None, :], ctx.fb.grad), dim=1)
    s = sum_ff + sum_fb

    rho0 = ctx.fluids.density0
    derr = rho0 - predicted_densities
    usable = torch.abs(aii) > 1.0e-9
    safe_aii = torch.where(usable, aii, 1.0)
    candidate = ((1.0 - cfg.omega) * pressures
                 + cfg.omega * (derr - s) / safe_aii)
    positive = candidate > 0.0
    next_p = torch.where(usable & positive, torch.clamp(candidate, min=0.0),
                         0.0)
    err_i = torch.where(usable & positive, (-s - aii * next_p) / rho0, 0.0)
    err = per_fluid_mean_max(err_i, ctx.fluids.fluid_id, ctx.fluids.alive,
                             ctx.num_fluids)
    return next_p, err


def pressure_solve(cfg: IISPHConfig, ctx: StepContext, pressures, dii, aii,
                   predicted_densities):
    """The Jacobi loop (`iisph_solver.rs:422-456`), in one
    ``solver.jacobi`` span: the pressure swap comes before the convergence
    check."""
    iters = 0
    err = torch.zeros((), dtype=torch.float32, device=pressures.device)
    with counters.span("solver.jacobi"):
        while iters < cfg.max_pressure_iter:
            dij_pjl = compute_dij_pjl(ctx, pressures)
            pressures, err = compute_next_pressures(
                cfg, ctx, pressures, dij_pjl, dii, aii, predicted_densities)
            done = _converged(err, cfg.max_density_error, iters,
                              cfg.min_pressure_iter)
            iters += 1
            if done:
                break
    return pressures, iters, err


def velocity_changes_from_pressures(ctx: StepContext, pressures, bforces):
    """dv_i -= dt * sum m_j (p_i/rho_i^2 + p_j/rho_j^2) grad, the
    boundary mirror-pressure term and its force feedback
    (`iisph_solver.rs:355-404`)."""
    rho = ctx.densities
    p_over_rho2 = pressures / (rho * rho)
    coeff_ff = ctx.ff_mass_j() * (p_over_rho2[:, None]
                                  + p_over_rho2[ctx.ff.j])
    dv = -torch.sum(ctx.ff.grad * (coeff_ff * ctx.dt)[..., None], dim=1)
    acc_fb = ctx.fb.grad * (ctx.fb_mass_j()
                            * p_over_rho2[:, None])[..., None]
    dv = dv - torch.sum(acc_fb, dim=1) * ctx.dt
    bforces = scatter_boundary_forces(
        bforces, ctx.fb, acc_fb * ctx.masses[:, None, None])
    return dv, bforces


def step(cfg: IISPHConfig, ctx: StepContext, pressures, gravity,
         apply_nonpressure_forces):
    """Full IISPH substep (`iisph_solver.rs:643-711`). Returns (fluids',
    boundary_forces, pressures', diagnostics)."""
    fl = ctx.fluids
    alive = fl.alive[:, None]
    bforces = torch.zeros_like(ctx.boundaries.forces)

    # predict_advection (gravity + non-pressure forces), folded into the
    # velocity-change buffer.
    accel = torch.where(alive, gravity.expand(fl.positions.shape), 0.0)
    np_accel, np_bforces = apply_nonpressure_forces(ctx)
    accel = accel + np_accel
    bforces = bforces + np_bforces
    dv = torch.where(alive, accel * ctx.dt, 0.0)

    dii = compute_dii(ctx)
    pressures = pressures * 0.5  # warm start (`:673-677`)
    predicted = compute_predicted_densities(ctx, dv)
    aii = compute_aii(ctx, dii)
    pressures, iters, err = pressure_solve(cfg, ctx, pressures, dii, aii,
                                           predicted)
    dvp, bforces = velocity_changes_from_pressures(ctx, pressures, bforces)
    dv = dv + dvp

    velocities = fl.velocities + torch.where(alive, dv, 0.0)
    positions = fl.positions + torch.where(alive, velocities * ctx.dt, 0.0)
    fl = fl.replace(velocities=velocities, positions=positions)
    diag = SolverDiagnostics(
        pressure_iters=iters,
        pressure_error=err,
        divergence_iters=0,
        divergence_error=torch.zeros((), dtype=torch.float32,
                                     device=pressures.device),
    )
    return fl, bforces, pressures, diag
