"""Monaghan's artificial viscosity between the particles of one fluid,
written from salva's `artificial_viscosity.rs` (alpha 1, beta 0, speed of
sound 10 by default): for each pair approaching each other
(v_ij . x_ij < 0), mu = h v_ij . x_ij / (r^2 + 0.01 h^2) and

    a_i += coefficient (c alpha mu - beta mu^2) (m / rho0) rho0 / rho_avg
           grad_i W_ij.

Torch only."""

from __future__ import annotations

import torch

F32_EPS = float(torch.finfo(torch.float32).eps)


def accel(ctx, fluid_coefficient, boundary_coefficient=0.0, alpha=1.0,
          beta=0.0, speed_of_sound=10.0):
    """Each fluid particle's acceleration [n, 3] in ``ctx.acc_dtype``."""
    if boundary_coefficient != 0.0:
        raise NotImplementedError(
            "the reference has no viscosity against the boundary")
    if fluid_coefficient == 0.0:
        return torch.zeros((ctx.n, 3), dtype=ctx.acc_dtype,
                           device=ctx.velocities.device)
    v = ctx.velocities.to(ctx.pair_dtype)
    h = ctx.h
    vr = (ctx.d * (v[ctx.i] - v[ctx.j])).sum(1)
    mu = h * vr / (ctx.r2 + h * h * 0.01)
    visc = speed_of_sound * alpha * mu - beta * mu * mu
    rho = ctx.densities.to(ctx.pair_dtype)
    rho_avg = torch.clamp((rho[ctx.i] + rho[ctx.j]) * 0.5, min=F32_EPS)
    scale = torch.where(
        vr < 0, fluid_coefficient * visc * (ctx.mass / ctx.density0)
        * ctx.density0 / rho_avg, torch.zeros_like(vr))
    return ctx.sum_i(ctx.i, ctx.grad * scale[:, None])
