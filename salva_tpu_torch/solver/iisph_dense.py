"""IISPH on the dense binned cell grid.

Port of ``salva_tpu.solver.iisph_dense``: same physics and termination as
the reference (``src/solver/pressure/iisph_solver.rs:643-711``), on the
hoisted sums of ``DenseCtx`` (with the IISPH-only ``s2`` channels):

- ``d_ii = -dt^2 / rho_i^2 (Gf_i + Gb_i)`` — iteration-invariant
  (`iisph_solver.rs:144-186`);
- ``a_ii = d_ii . (Gf + Gb) - factor_i * s2_m`` with
  ``factor_i = dt^2 m_i / rho_i^2`` and ``s2_m = sum m_j |grad|^2``
  (`:188-233`);
- per Jacobi iteration (`:235-353`): two pair passes —
  ``D_i = dij_pjl = -dt^2 K(p_j / rho_j^2)`` (a ``k_pass``), then
  ``sum_ff = D_i . Gf_i - T(q) + p_i factor_i s2_ff`` with the per-slot
  vector ``q_j = d_jj p_j + D_j`` (a ``t_pass``); the boundary part is
  ``D_i . Gb_i``.

The Jacobi loop is a Python loop in place of ``lax.while_loop``; each
iteration syncs with the host once (the convergence test). The
iteration count follows the JAX loop exactly: the counter increments on
every iteration, including the one that finds convergence, and that
iteration's pressures are kept. The loop runs in one ``solver.jacobi``
span a substep, inside ``solver.pressure``.

The dense non-pressure forces (``dense_forces``: the viscosity and
surface-tension pair forces, and the elasticity as a
``ParticleWiseForce``) act in predict_advection on the substep's start
velocities.

With a ``halo`` (``parallel/domain.py``, the slab path) the velocity
changes of the forces, the pressures before each ``k_pass`` and the
vector ``q`` before each ``t_pass`` are exchanged, and the error and
diagnostics are summed over the slabs, as in the JAX package. The
sharded-binning path hands the substep its particle-wise accelerations
(``a_pw``), as for DFSPH (``dfsph_dense.build_dense_substep``).
"""

from __future__ import annotations

import torch

from .. import counters
from ..config import IISPHConfig, SimConfig
from ..geometry import dense_grid as dg
from ..object.state import BoundariesState, FluidsState
from .common import SolverDiagnostics
from .dense_common import DenseCtx, per_fluid_mean_max_grid
from .dfsph_dense import _converged


def build_dense_substep(sim: SimConfig, cfg: IISPHConfig, num_fluids: int,
                        spec_f: dg.DenseGridSpec, spec_b: dg.DenseGridSpec,
                        dense_forces=(), halo=None):
    """Build the dense-layout IISPH substep
    ``substep(fluids, boundaries, pressures, es, dt, gravity, a_pw=None)``
    (``es``: the elasticity state a ``ParticleWiseForce`` reads; ``halo``:
    one slab's ``parallel.domain.Halo``, or None; ``a_pw``: the
    particle-wise forces' precomputed acceleration [N, dim], in place of
    the ``ParticleWiseForce``)."""
    dim = sim.dim

    def substep(fluids: FluidsState, boundaries: BoundariesState,
                pressures, es, dt, gravity, a_pw=None):
        dev = fluids.positions.device
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        inv_dt = torch.where(dt > 0, 1.0 / dt, 0.0)
        dt2 = dt * dt
        boundaries = boundaries.clear_forces()

        ctx = DenseCtx(sim, spec_f, spec_b, fluids, boundaries, halo=halo)
        maskf, live, R0 = ctx.maskf, ctx.live, ctx.R0

        def exchange(arr):
            return arr if halo is None else halo.exchange(arr)

        P_grid = ctx.to_f(pressures)

        # predict_advection: gravity + non-pressure forces.
        with counters.span("solver.forces"):
            A = gravity.reshape(dim, 1, 1) * maskf[None]
            np_Fb = None
            if dense_forces:
                A, np_Fb = ctx.apply_forces(dense_forces, fluids, ctx.V, dt,
                                            inv_dt, A, es,
                                            particle_wise=a_pw is None)
            if a_pw is not None:
                A = A + ctx.to_f(a_pw) * maskf[None]
            # The force passes are valid on owned cells only; the predicted
            # densities read (V + DV) at j.
            DV = exchange(A * dt)

        with counters.span("solver.pressure"):
            rho_safe = torch.clamp(ctx.rho, min=1e-12)
            inv_rho2 = 1.0 / (rho_safe * rho_safe)

            # d_ii and a_ii (`iisph_solver.rs:144-233`).
            dii = -(dt2 * inv_rho2)[None] * ctx.Gsum
            factor_i = dt2 * ctx.M * inv_rho2
            aii = torch.sum(dii * ctx.Gsum, dim=0) - factor_i * ctx.s2_m

            # Warm start (`:673-677`) and predicted densities (`:92-142`).
            P_grid = P_grid * 0.5
            predicted = ctx.rho + ctx.delta_density(ctx.V + DV) * dt

            derr = R0 - predicted
            usable = torch.abs(aii) > 1.0e-9
            safe_aii = torch.where(usable, aii, 1.0)

            iters = 0
            err = torch.zeros((), dtype=torch.float32, device=dev)
            # The relaxed-Jacobi loop, one span a substep (each iteration's
            # ``sync.converged`` nests in it).
            with counters.span("solver.jacobi"):
                while iters < cfg.max_pressure_iter:
                    # On a slab the ghost pressures are one iteration stale
                    # (the update is valid on owned cells only); pass 1 reads
                    # p at j.
                    P_grid = exchange(P_grid)
                    # Pass 1: D = dij_pjl (`:235-268`).
                    D = -dt2 * ctx.k_pass(P_grid * inv_rho2)
                    # Pass 2: q_j = d_jj p_j + D_j reduction (`:270-353`);
                    # dii and D are ghost-incomplete on a slab, and t_pass
                    # reads q at j.
                    q = exchange(dii * P_grid[None] + D)
                    t_q = ctx.t_pass(q)
                    sum_all = (
                        torch.sum(D * ctx.Gsum, dim=0)  # D_i . (Gf + Gb)
                        - t_q
                        + P_grid * factor_i * ctx.s2_ff
                    )
                    candidate = ((1.0 - cfg.omega) * P_grid
                                 + cfg.omega * (derr - sum_all) / safe_aii)
                    positive = candidate > 0.0
                    next_p = torch.where(usable & positive & live,
                                         torch.clamp(candidate, min=0.0),
                                         0.0)
                    err_i = torch.where(
                        usable & positive, (-sum_all - aii * next_p) / R0,
                        0.0)
                    err = per_fluid_mean_max_grid(err_i, ctx.FID, maskf,
                                                  num_fluids, halo=halo,
                                                  interior=ctx.interior)
                    done = _converged(err, cfg.max_density_error, iters,
                                      cfg.min_pressure_iter)
                    iters += 1
                    P_grid = next_p
                    if done:
                        break

            # Velocity changes from final pressures (`:355-404`); the final
            # k_pass and the boundary pass read p at j.
            P_grid = exchange(P_grid)
            p_over_rho2 = P_grid * inv_rho2
            K = ctx.k_pass(p_over_rho2)
            DV = DV - dt * (p_over_rho2[None] * ctx.Gf + K)
            DV = DV - dt * p_over_rho2[None] * ctx.Gb

        # Boundary feedback: per-contact force = grad * fbm * p/rho_i^2 *
        # m_i (`:393-400`).
        with counters.span("solver.boundary_forces"):
            coef = R0 * ctx.M * p_over_rho2
            Fb = ctx.boundary_forces(coef)
            if np_Fb is not None:
                Fb = Fb + np_Fb

        # Semi-implicit integration (`:406-420`).
        V2 = ctx.V + DV * maskf[None]
        P2 = ctx.P + V2 * (dt * maskf[None])

        with counters.span("solver.unbin"):
            new_pos, new_vel, new_pressures = ctx.unbin_f_multi([
                (P2, fluids.positions),
                (V2, fluids.velocities),
                (P_grid, pressures),
            ])
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
                pressure_iters=iters,
                pressure_error=err,
                divergence_iters=0,
                divergence_error=torch.zeros((), dtype=torch.float32,
                                             device=dev),
            ),
            **contacts,
        )
        return fluids, boundaries, new_pressures, diag

    return substep
