"""DFSPH on the dense binned cell grid.

Port of ``salva_tpu.solver.dfsph_dense``: same physics, stage order and
termination rules as the reference (``dfsph_solver.rs:667-708``), with
the per-substep hoisting of ``DenseCtx`` — only ``T_i = sum_j m_j v_j' .
grad_ij`` (``t_pass``) and the stiffness pass (``k_pass``) run per
iteration.

The divergence and pressure solves are Python loops in place of
``lax.while_loop`` / ``lax.cond``; each iteration syncs with the host
once (the convergence test). The iteration count follows the JAX loop
exactly: the counter increments on the iteration that finds
convergence, and that iteration applies no update.

With a ``halo`` (``parallel/domain.py``) the substep runs on one slab of
the grid: the stiffness is exchanged before each ``k_pass`` and the
velocity changes after each update, the errors and diagnostics are
summed over the slabs, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import counters
from ..config import DFSPHConfig, SimConfig
from ..geometry import dense_grid as dg
from ..object.state import BoundariesState, FluidsState
from .common import SolverDiagnostics
from .dense_common import DenseCtx, per_fluid_mean_max_grid


def _converged(err, tol, i: int, min_iter: int) -> bool:
    """The loop's one host sync: ``err <= tol`` once ``i >= min_iter``
    (counted in ``counters.HOST_SYNCS["converged"]``)."""
    return i >= min_iter and bool(counters.fetch("converged", err <= tol))


def build_dense_substep(sim: SimConfig, cfg: DFSPHConfig, num_fluids: int,
                        spec_f: dg.DenseGridSpec, spec_b: dg.DenseGridSpec,
                        dense_forces=(), halo=None):
    """Build the dense-layout DFSPH substep
    ``substep(fluids, boundaries, solver_state, es, dt, gravity,
    a_pw=None)``.

    ``dense_forces``: tuple of dense non-pressure forces
    (``forces_dense.py``), each ``apply(fields) -> (accel, bforces|None)``,
    or a ``ParticleWiseForce`` run on the elasticity state ``es``,
    applied in predict_advection. ``halo``: one slab's
    ``parallel.domain.Halo`` (the slab path), or None. ``a_pw``: the
    particle-wise forces' acceleration [N, dim], computed by the caller
    (the sharded-binning path evaluates the elasticity on its home rows
    before the migration, since its rest topology is fixed in row space,
    and routes the result here with the particle arrays); the
    ``ParticleWiseForce`` is then skipped."""
    dim = sim.dim
    min_nb = cfg.min_neighbors(dim)
    warm = float(getattr(cfg, "warm_start", 0.0))

    def substep(fluids: FluidsState, boundaries: BoundariesState,
                solver_state, es, dt, gravity, a_pw=None):
        dev = fluids.positions.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        inv_dt = torch.where(dt > 0, 1.0 / dt, 0.0)
        boundaries = boundaries.clear_forces()

        ctx = DenseCtx(sim, spec_f, spec_b, fluids, boundaries, halo=halo,
                       need_s2=False)  # s2_ff / s2_m are IISPH-only sums

        def exchange(arr):
            return arr if halo is None else halo.exchange(arr)

        def mean_max(values):
            return per_fluid_mean_max_grid(values, ctx.FID, maskf,
                                           num_fluids, halo=halo,
                                           interior=ctx.interior)

        maskf, live, R0 = ctx.maskf, ctx.live, ctx.R0
        # solver_state: [:, :dim] velocity changes, [:, dim] / [:, dim+1]
        # the previous step's divergence / pressure stiffness sums.
        (SG,) = dg.to_grid_multi(ctx.sf, ctx.binf, [(solver_state, 0.0)])
        DV = SG[:dim]
        kd_prev, kp_prev = SG[dim], SG[dim + 1]

        # alpha_i (`dfsph_solver.rs:165-216`): 1 / (sum|m grad|^2 +
        # |sum m grad|^2), eps-guarded.
        denom = ctx.sq_mm + torch.sum(ctx.Gsum * ctx.Gsum, dim=0)
        alpha = torch.where(denom <= 1.0e-5, 0.0,
                            1.0 / torch.where(denom == 0, 1.0, denom))

        # --- divergence solve (`dfsph_solver.rs:466-503`)
        with counters.span("solver.divergence"):
            max_div_err = cfg.max_divergence_error * inv_dt * 0.01
            ksum_d = torch.zeros_like(maskf)
            if warm > 0.0:
                k0 = exchange(torch.clamp(kd_prev * warm, min=0.0) * maskf)
                DV = exchange(DV - (k0[None] * ctx.Gsum + ctx.k_pass(k0)))
                ksum_d = k0
            enough = (ctx.count >= min_nb) & live
            div_iters = 0
            div_err = torch.zeros((), dtype=torch.float32, device=dev)
            while div_iters < cfg.max_divergence_iter:
                delta = ctx.delta_density(ctx.V + DV)
                div = torch.where(enough, torch.clamp(delta, min=0.0), 0.0)
                div_err = mean_max(div / R0)
                done = _converged(div_err, max_div_err, div_iters,
                                  cfg.min_divergence_iter)
                div_iters += 1
                if done:
                    break
                # On a slab ki is valid on owned cells only (delta at a
                # ghost cell sees half its neighbourhood); k_pass reads ki
                # at j.
                ki = exchange(div * alpha)
                DV = exchange(DV - (ki[None] * ctx.Gsum + ctx.k_pass(ki)))
                ksum_d = ksum_d + ki

        # Commit velocities; reset velocity changes (`:688-691`).
        V2 = ctx.V + DV * maskf[None]

        # predict_advection: gravity + non-pressure forces (`:565-604`).
        with counters.span("solver.forces"):
            A = gravity.reshape(dim, 1, 1) * maskf[None]
            np_Fb = None
            if dense_forces:
                A, np_Fb = ctx.apply_forces(dense_forces, fluids, V2, dt,
                                            inv_dt, A, es,
                                            particle_wise=a_pw is None)
            if a_pw is not None:
                A = A + ctx.to_f(a_pw) * maskf[None]
            # The force passes are valid on owned cells only.
            DV = exchange(A * dt)

        # --- pressure solve (`dfsph_solver.rs:432-464`)
        with counters.span("solver.pressure"):
            ksum_p = torch.zeros_like(maskf)
            if warm > 0.0:
                kp0 = exchange(torch.clamp(kp_prev * warm, min=0.0) * maskf)
                DV = exchange(
                    DV - (kp0[None] * ctx.Gsum + ctx.k_pass(kp0)) * inv_dt)
                ksum_p = kp0
            p_iters = 0
            p_err = torch.zeros((), dtype=torch.float32, device=dev)
            while p_iters < cfg.max_pressure_iter:
                predicted = ctx.rho + ctx.delta_density(V2 + DV) * dt
                err_i = torch.where(predicted < R0, 0.0,
                                    predicted / R0 - 1.0)
                p_err = mean_max(err_i)
                done = _converged(p_err, cfg.max_density_error, p_iters,
                                  cfg.min_pressure_iter)
                p_iters += 1
                if done:
                    break
                ki_p = exchange(torch.clamp((predicted - R0) * alpha,
                                            min=0.0))
                DV = exchange(
                    DV - (ki_p[None] * ctx.Gsum + ctx.k_pass(ki_p)) * inv_dt)
                ksum_p = ksum_p + ki_p

        # --- positions (`:411-420`)
        P2 = ctx.P + (V2 + DV) * (dt * maskf[None])

        # --- boundary force feedback: one boundary-owner pair pass.
        # Per-contact force = grad_ij * Volb_j * rho0_i * m_i * inv_dt *
        # (ksum_div + inv_dt * ksum_p).
        with counters.span("solver.boundary_forces"):
            coef = R0 * ctx.M * inv_dt * (ksum_d + inv_dt * ksum_p)
            Fb = ctx.boundary_forces(coef)
            if np_Fb is not None:
                Fb = Fb + np_Fb

        # --- unbin back to particle arrays (one packed row gather), and
        # the binning's and hoist's diagnostics
        with counters.span("solver.unbin"):
            new_pos, new_vel, new_dv, new_kd, new_kp = ctx.unbin_f_multi([
                (P2, fluids.positions),
                (V2, fluids.velocities),
                (DV, solver_state[:, :dim]),
                (ksum_d, solver_state[:, dim]),
                (ksum_p, solver_state[:, dim + 1]),
            ])
            new_state = torch.cat(
                [new_dv, new_kd[:, None], new_kp[:, None]], dim=1
            )
            fluids = fluids.replace(positions=new_pos, velocities=new_vel)
            b_forces, b_volumes = ctx.unbin_b_multi([
                (Fb, boundaries.forces * 0.0),
                (ctx.Volb, boundaries.volumes),
            ])
            boundaries = boundaries.replace(forces=b_forces,
                                            volumes=b_volumes)
            contacts = ctx.contact_diagnostics()

        from ..step import StepDiagnostics  # local import avoids a cycle

        diag = StepDiagnostics(
            solver=SolverDiagnostics(
                pressure_iters=p_iters,
                pressure_error=p_err,
                divergence_iters=div_iters,
                divergence_error=div_err,
            ),
            **contacts,
        )
        return fluids, boundaries, new_state, diag

    return substep
