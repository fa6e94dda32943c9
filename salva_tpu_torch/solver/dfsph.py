"""Divergence-Free SPH on the gather layout.

Port of ``salva_tpu.solver.dfsph`` (``src/solver/pressure/
dfsph_solver.rs``): every per-particle loop is a masked [N, K] contact
reduction; the pressure and divergence iterations are host loops in
place of ``lax.while_loop`` (one host sync per iteration, the
convergence test) whose counts follow the JAX loops exactly; the
boundary-force feedback is one deferred scatter per solve.

Stage order inside ``step`` matches `dfsph_solver.rs:667-708`: alphas ->
divergence solve -> commit velocity changes -> non-pressure forces ->
fold accelerations -> pressure solve -> integrate positions. The
``velocity_changes`` buffer persists across steps like the reference's
solver scratch.
"""

from __future__ import annotations

import torch

from ..config import DFSPHConfig
from .common import (
    SolverDiagnostics,
    StepContext,
    per_fluid_mean_max,
    scatter_boundary_forces,
)
from .dfsph_dense import _converged


def _dot(a, b):
    """Sum over the last (spatial) axis of ``a * b``."""
    return torch.sum(a * b, dim=-1)


def compute_alphas(ctx: StepContext) -> torch.Tensor:
    """alpha_i / rho_i = 1 / (sum |grad m|^2 + |sum grad m|^2)
    (`dfsph_solver.rs:165-216`), with the 1e-5 epsilon guard."""
    g_ff = ctx.ff.grad * ctx.ff_mass_j()[..., None]
    g_fb = ctx.fb.grad * ctx.fb_mass_j()[..., None]
    sq = (torch.sum(g_ff * g_ff, dim=(1, 2))
          + torch.sum(g_fb * g_fb, dim=(1, 2)))
    gsum = torch.sum(g_ff, dim=1) + torch.sum(g_fb, dim=1)
    denom = sq + _dot(gsum, gsum)
    return torch.where(denom <= 1.0e-5, 0.0,
                       1.0 / torch.where(denom == 0, 1.0, denom))


def _relative_velocity_divergence(ctx: StepContext, velocity_changes):
    """sum m_j (v_i + dv_i - v_j - dv_j) . grad over ff contacts plus the
    boundary term (predicted densities and divergences share it)."""
    v = ctx.fluids.velocities + velocity_changes
    ff_term = torch.sum(
        ctx.ff_mass_j() * _dot(v[:, None, :] - v[ctx.ff.j], ctx.ff.grad),
        dim=1)
    dv_fb = v[:, None, :] - ctx.boundaries.velocities[ctx.fb.j]
    fb_term = torch.sum(ctx.fb_mass_j() * _dot(dv_fb, ctx.fb.grad), dim=1)
    return ff_term + fb_term


def compute_predicted_densities(ctx: StepContext, velocity_changes):
    """rho*_i and the mean density error (`dfsph_solver.rs:98-162`):
    0 where rho* < rho0, else rho*/rho0 - 1."""
    delta = _relative_velocity_divergence(ctx, velocity_changes)
    predicted = ctx.densities + delta * ctx.dt
    rho0 = ctx.fluids.density0
    err_i = torch.where(predicted < rho0, 0.0, predicted / rho0 - 1.0)
    err = per_fluid_mean_max(err_i, ctx.fluids.fluid_id, ctx.fluids.alive,
                             ctx.num_fluids)
    return predicted, err


def compute_divergences(ctx: StepContext, velocity_changes,
                        min_neighbors: int):
    """Velocity divergences and mean divergence error
    (`dfsph_solver.rs:279-356`): zero below ``min_neighbors`` contacts,
    clamped >= 0. The boundary term uses the relative velocity (the
    reference's FIXME at `:330`), as ``salva_tpu`` does."""
    div = _relative_velocity_divergence(ctx, velocity_changes)
    enough = (ctx.ff.count + ctx.fb.count) >= min_neighbors
    div = torch.where(enough, torch.clamp(div, min=0.0), 0.0)
    err = per_fluid_mean_max(div / ctx.fluids.density0, ctx.fluids.fluid_id,
                             ctx.fluids.alive, ctx.num_fluids)
    return div, err


def _apply_pressure_kappa(ctx: StepContext, velocity_changes, ki_plus):
    """Velocity update of a clamped pressure stiffness field
    (`dfsph_solver.rs:218-277`), shared by the iteration and the warm
    start."""
    kij = ki_plus[:, None] + ki_plus[ctx.ff.j]
    coeff = torch.where(kij > 0.0, kij * ctx.ff_mass_j(), 0.0)
    dv = -torch.sum(ctx.ff.grad * (coeff * ctx.inv_dt)[..., None], dim=1)
    coeff_b = ki_plus[:, None] * ctx.fb_mass_j()
    dv = dv - torch.sum(ctx.fb.grad * (coeff_b * ctx.inv_dt)[..., None],
                        dim=1)
    return velocity_changes + dv


def _apply_divergence_kappa(ctx: StepContext, velocity_changes, ki):
    """Divergence twin of :func:`_apply_pressure_kappa`
    (`dfsph_solver.rs:358-409`; no inv_dt scaling)."""
    coeff = -(ki[:, None] + ki[ctx.ff.j]) * ctx.ff_mass_j()
    dv = torch.sum(ctx.ff.grad * coeff[..., None], dim=1)
    coeff_b = -ki[:, None] * ctx.fb_mass_j()
    dv = dv + torch.sum(ctx.fb.grad * coeff_b[..., None], dim=1)
    return velocity_changes + dv


def _scatter_ksum_forces(ctx: StepContext, bforces, ksum,
                         extra_inv_dt: bool):
    """One deferred boundary-force scatter for an accumulated stiffness
    sum: the per-iteration contributions (`dfsph_solver.rs:262-271`,
    `:393-400`) are linear in the stiffness with frozen gradients, so one
    scatter of the sum is exact."""
    scale = ctx.masses * ctx.inv_dt
    if extra_inv_dt:
        scale = scale * ctx.inv_dt
    coeff = ksum[:, None] * ctx.fb_mass_j() * scale[:, None]
    return scatter_boundary_forces(bforces, ctx.fb,
                                   ctx.fb.grad * coeff[..., None])


def _warm_kappa(warm_sum, warm: float, alive):
    return torch.where(alive, torch.clamp(warm_sum * warm, min=0.0), 0.0)


def pressure_solve(cfg: DFSPHConfig, ctx: StepContext, velocity_changes,
                   bforces, alphas, kp_warm=None):
    """The constant-density loop (`dfsph_solver.rs:432-464`), optionally
    warm-started from the previous step's stiffness sum."""
    ksum = torch.zeros_like(alphas)
    warm = float(getattr(cfg, "warm_start", 0.0))
    dv = velocity_changes
    if kp_warm is not None and warm > 0.0:
        ksum = _warm_kappa(kp_warm, warm, ctx.fluids.alive)
        dv = _apply_pressure_kappa(ctx, dv, ksum)
    rho0 = ctx.fluids.density0
    iters = 0
    err = torch.zeros((), dtype=torch.float32, device=alphas.device)
    while iters < cfg.max_pressure_iter:
        predicted, err = compute_predicted_densities(ctx, dv)
        done = _converged(err, cfg.max_density_error, iters,
                          cfg.min_pressure_iter)
        iters += 1
        if done:
            break
        ki_plus = torch.clamp((predicted - rho0) * alphas, min=0.0)
        dv = _apply_pressure_kappa(ctx, dv, ki_plus)
        ksum = ksum + ki_plus
    bforces = _scatter_ksum_forces(ctx, bforces, ksum, extra_inv_dt=True)
    return dv, bforces, iters, err, ksum


def divergence_solve(cfg: DFSPHConfig, ctx: StepContext, velocity_changes,
                     bforces, alphas, min_neighbors: int, kd_warm=None):
    """The divergence-free loop (`dfsph_solver.rs:466-503`), tolerance
    ``max_divergence_error * inv_dt * 0.01``; optionally warm-started."""
    max_err = cfg.max_divergence_error * ctx.inv_dt * 0.01
    ksum = torch.zeros_like(alphas)
    warm = float(getattr(cfg, "warm_start", 0.0))
    dv = velocity_changes
    if kd_warm is not None and warm > 0.0:
        ksum = _warm_kappa(kd_warm, warm, ctx.fluids.alive)
        dv = _apply_divergence_kappa(ctx, dv, ksum)
    iters = 0
    err = torch.zeros((), dtype=torch.float32, device=alphas.device)
    while iters < cfg.max_divergence_iter:
        div, err = compute_divergences(ctx, dv, min_neighbors)
        done = _converged(err, max_err, iters, cfg.min_divergence_iter)
        iters += 1
        if done:
            break
        ki = div * alphas
        dv = _apply_divergence_kappa(ctx, dv, ki)
        ksum = ksum + ki
    bforces = _scatter_ksum_forces(ctx, bforces, ksum, extra_inv_dt=False)
    return dv, bforces, iters, err, ksum


def step(cfg: DFSPHConfig, ctx: StepContext, solver_state, gravity,
         apply_nonpressure_forces):
    """Full DFSPH substep (`dfsph_solver.rs:667-708`).

    ``apply_nonpressure_forces(ctx) -> (accelerations, boundary_forces)``
    closes over the force set. ``solver_state``: [capacity, dim + 2],
    the velocity changes plus the previous step's divergence / pressure
    stiffness sums. Returns (fluids', boundary_forces, solver_state',
    diagnostics)."""
    fl = ctx.fluids
    dim = ctx.dim
    alive = fl.alive[:, None]
    velocity_changes = solver_state[:, :dim]
    kd_warm = solver_state[:, dim]
    kp_warm = solver_state[:, dim + 1]
    bforces = torch.zeros_like(ctx.boundaries.forces)

    alphas = compute_alphas(ctx)
    dv, bforces, div_iters, div_err, ksum_d = divergence_solve(
        cfg, ctx, velocity_changes, bforces, alphas,
        cfg.min_neighbors(dim), kd_warm)

    # Commit the divergence-corrected velocities (`:688-691`).
    fl = fl.replace(velocities=fl.velocities + torch.where(alive, dv, 0.0))
    ctx = ctx.replace(fluids=fl)

    # predict_advection: gravity + non-pressure forces (`:565-604`).
    accel = torch.where(alive, gravity.expand(fl.positions.shape), 0.0)
    np_accel, np_bforces = apply_nonpressure_forces(ctx)
    accel = accel + np_accel
    bforces = bforces + np_bforces
    # integrate_and_clear_accelerations (`:505-518`).
    dv = torch.where(alive, accel * ctx.dt, 0.0)

    dv, bforces, p_iters, p_err, ksum_p = pressure_solve(
        cfg, ctx, dv, bforces, alphas, kp_warm)

    # update_positions (`:411-420`): x += (v + dv) * dt; dv carries into
    # the next step's divergence solve.
    fl = fl.replace(positions=fl.positions
                    + torch.where(alive, (fl.velocities + dv) * ctx.dt, 0.0))
    diag = SolverDiagnostics(
        pressure_iters=p_iters,
        pressure_error=p_err,
        divergence_iters=div_iters,
        divergence_error=div_err,
    )
    new_state = torch.cat([dv, ksum_d[:, None], ksum_p[:, None]], dim=1)
    return fl, bforces, new_state, diag
