"""A plain IISPH step with static boundary particles, written from the method.

One step of Implicit Incompressible SPH (Ihmsen et al. 2014, as salva
runs it: `src/solver/pressure/iisph_solver.rs`, ``IISPHSolver::step`` at
`:643-711`) with static boundary particles (Akinci et al. 2012 volumes)
and the configuration's non-pressure forces, over explicit pair lists.
Stage order, as in salva:

1. the non-pressure forces on the step's start velocities, then gravity,
   folded into the velocity changes ``dv = (g + a) dt`` (`:653-662`);
2. ``d_ii = -dt^2 / rho_i^2 sum_j m_j grad_ij`` over fluid and boundary
   neighbours (`:144-186`);
3. the warm start: the pressures carried from the previous step, halved
   (`:673-677`);
4. the predicted densities ``rho*_i = rho_i + dt sum_j m_j (v_i + dv_i -
   v_j - dv_j) . grad_ij`` (`:92-142`);
5. ``a_ii = sum_j m_j (d_ii - d_ji) . grad_ij`` with ``d_ji = dt^2 m_i /
   rho_i^2 grad_ij`` (`:188-233`);
6. the relaxed-Jacobi loop (`:235-353`, `:422-456`): ``dij_pjl_i = -dt^2
   sum_ff m_j p_j / rho_j^2 grad_ij``, then per particle the sum ``s_i =
   sum_ff m_j (dij_pjl_i - d_jj p_j - (dij_pjl_j - d_ji p_i)) . grad_ij +
   sum_fb m_b dij_pjl_i . grad_ib`` and the update ``p_i <- (1 - w) p_i +
   w (rho0 - rho*_i - s_i) / a_ii``, kept where ``|a_ii| > 1e-9`` and the
   update is positive, else 0; the particle's error ``(-s_i - a_ii p_i) /
   rho0`` where kept, else 0; the fluid's mean error against the
   tolerance once at least ``min_iter`` iterations came before, at most
   ``max_iter`` iterations, the pressures swapped before the test
   (`:430-455`);
7. the velocity change of the final pressures, ``-dt sum_ff m_j (p_i /
   rho_i^2 + p_j / rho_j^2) grad_ij`` and the boundary's mirrored
   pressure ``-dt sum_fb m_b p_i / rho_i^2 grad_ib``, and its reaction on
   each boundary particle, ``sum_i m_i m_b p_i / rho_i^2 grad_ib``
   (`:355-404`);
8. the semi-implicit integration ``v += dv``, ``x += v dt`` (`:406-420`).

Here ``m_b = rho0 V_b`` is a boundary particle's mass. Where this departs
from the Rust source, and why:

- the neighbours come from a cell search over pair lists (``Pairs``),
  decided in float32 with r^2 rounded as (dx^2 + dy^2) + dz^2, the rule
  the configuration states, so that both sides count the same contacts;
  salva keeps per-particle contact lists from its hash grid;
- every pair term is in ``pair_dtype`` and every sum in ``acc_dtype``
  (float64 both by default: the reference is more exact than the float32
  program it judges); salva sums in its scalar type in list order;
- the boundary particles are at rest and their volumes are worked out
  again at every step from all wall samples: the configurations' walls
  are static cuboids; salva reads its boundary velocities;
- one step of ``dt``, one fluid: the configurations run neither the CFL
  substeps nor a second fluid, so the fluids' mean error is the one
  fluid's mean;
- the iteration count includes the iteration whose test passes, as the
  program's diagnostics count it.

Imports torch and the DFSPH reference's pair search, pair terms, sums,
boundary volumes and constants only.
"""

from __future__ import annotations

import dataclasses

import torch

from . import dfsph
from .dfsph import Forces, Pairs, _sum_i, _terms, boundary_volumes


@dataclasses.dataclass(frozen=True)
class Params:
    """Physical constants and solver settings of one configuration (SI
    units); the solver's at salva's defaults (`iisph_solver.rs:48-64`)."""

    h: float
    mass: float
    density0: float
    gravity: tuple
    dt: float
    max_density_error: float = 0.05
    min_iter: int = 1
    max_iter: int = 50
    omega: float = 0.5

    @staticmethod
    def from_config(cfg):
        """The constants as the DFSPH reference derives them (h, the
        particle mass), the solver at its defaults."""
        c = dfsph.Params.from_config(cfg)
        return Params(h=c.h, mass=c.mass, density0=c.density0,
                      gravity=c.gravity, dt=c.dt)


def _dot(a, b):
    return (a * b).sum(1)


def step(prm: Params, pos, vel, pressures, pb, forces=(),
         pair_dtype=torch.float64, acc_dtype=torch.float64):
    """One IISPH step of the live fluid particles.

    ``pos``, ``vel`` [n, 3] float32: positions and velocities;
    ``pressures`` [n] float32: the pressures carried from the previous
    step (zero before the first); ``pb`` [nb, 3] float32: the boundary
    particles (at rest); ``forces``: callables that take a ``Forces``
    context and return each particle's acceleration [n, 3] in its
    ``acc_dtype``. Returns a dict of float32 ``positions``, ``velocities``,
    ``pressures`` and ``boundary_forces`` [nb, 3], ``dii`` and ``aii`` in
    ``acc_dtype``, the iteration count, the last iteration's mean error
    and the contact counts.

    TF32 is off in matrix products and convolutions meanwhile (on the card
    a float32 product may otherwise run in TF32); the process's settings
    are restored after the step."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _step(prm, pos, vel, pressures, pb, forces, pair_dtype,
                     acc_dtype)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _step(prm, pos, vel, pressures, pb, forces, pair_dtype, acc_dtype):
    """``step``'s body."""
    n, nb = pos.shape[0], pb.shape[0]
    h, m, rho0, dt = prm.h, prm.mass, prm.density0, prm.dt
    acc, pd = acc_dtype, pair_dtype
    dev = pos.device
    ff = Pairs(pos, pos, h)
    fb = Pairs(pos, pb, h)
    vol_b, n_bb = boundary_volumes(pb, h, pd, acc)
    i_ff, j_ff, i_fb = ff.i, ff.j, fb.i

    d_ff, r2_ff, w_ff, dwr_ff = _terms(ff, h, pd)
    d_fb, _, w_fb, dwr_fb = _terms(fb, h, pd)
    g_ff = d_ff * dwr_ff[:, None]                 # grad_i W_ij
    g_fb = d_fb * dwr_fb[:, None]
    m_b = (rho0 * vol_b).to(pd)[fb.j]             # a boundary pair's mass

    def fold(pair_ff, pair_fb=None):
        """sum_ff m_j x_ij + sum_fb m_b y_ib per particle, of pair terms
        [P] or [P, 3]."""
        out = _sum_i(n, i_ff, pair_ff * m, acc)
        if pair_fb is not None:
            mb = m_b if pair_fb.dim() == 1 else m_b[:, None]
            out = out + _sum_i(n, i_fb, pair_fb * mb, acc)
        return out

    rho = fold(w_ff, w_fb)
    v0 = vel.to(acc)

    # 1. Non-pressure forces and gravity on the start velocities.
    accel = torch.tensor(prm.gravity, dtype=acc,
                         device=dev).expand(n, 3).clone()
    ctx = Forces(n=n, h=h, mass=m, density0=rho0, i=i_ff, j=j_ff, d=d_ff,
                 r2=r2_ff, grad=g_ff, i_fb=i_fb, j_fb=fb.j, d_fb=d_fb,
                 grad_fb=g_fb, vol_b=vol_b.to(pd)[fb.j], velocities=v0,
                 densities=rho, pair_dtype=pd, acc_dtype=acc)
    for force in forces:
        accel = accel + force(ctx)
    dv = accel * dt

    dt2 = dt * dt
    inv_rho2 = 1.0 / (rho * rho)
    # 2. d_ii.
    gsum = fold(g_ff, g_fb)
    dii = -dt2 * inv_rho2[:, None] * gsum
    # 3. The warm start.
    p = pressures.to(acc) * 0.5
    # 4. The predicted densities (the boundary at rest).
    v = (v0 + dv).to(pd)
    rho_star = rho + dt * fold(_dot(v[i_ff] - v[j_ff], g_ff),
                               _dot(v[i_fb], g_fb))
    # 5. a_ii, with d_ji = dt^2 m_i / rho_i^2 grad_ij.
    fac = dt2 * m * inv_rho2
    dii_p, fac_p = dii.to(pd), fac.to(pd)
    aii = fold(_dot(dii_p[i_ff] - g_ff * fac_p[i_ff, None], g_ff),
               _dot(dii_p[i_fb] - g_fb * fac_p[i_fb, None], g_fb))

    # 6. The relaxed-Jacobi loop.
    usable = aii.abs() > 1.0e-9
    safe_aii = torch.where(usable, aii, torch.ones_like(aii))
    rho_err = rho0 - rho_star
    iters = 0
    err = 0.0
    while iters < prm.max_iter:
        pp = (p * inv_rho2).to(pd)
        dij_pjl = -dt2 * fold(g_ff * pp[j_ff, None])
        dp = dij_pjl.to(pd)
        djj_pj = (dii * p[:, None]).to(pd)
        p_p = p.to(pd)
        inner = (dp[i_ff] - djj_pj[j_ff]
                 - (dp[j_ff] - g_ff * (fac_p * p_p)[i_ff, None]))
        s = fold(_dot(inner, g_ff), _dot(dp[i_fb], g_fb))
        cand = (1.0 - prm.omega) * p + prm.omega * (rho_err - s) / safe_aii
        kept = usable & (cand > 0.0)
        nxt = torch.where(kept, cand, torch.zeros_like(cand))
        err_i = torch.where(kept, (-s - aii * nxt) / rho0,
                            torch.zeros_like(cand))
        err = float(err_i.sum() / n)
        done = iters >= prm.min_iter and err <= prm.max_density_error
        iters += 1
        p = nxt
        if done:
            break

    # 7. The velocity change of the final pressures and the walls'
    # reaction.
    pr_p = (p * inv_rho2).to(pd)
    dv_p = -dt * fold(g_ff * (pr_p[i_ff] + pr_p[j_ff])[:, None],
                      g_fb * pr_p[i_fb, None])
    fb_force = _sum_i(nb, fb.j,
                      g_fb * (m_b * (m * pr_p)[i_fb])[:, None], acc)

    # 8. Integration.
    v2 = v0 + dv + dv_p
    new_pos = pos.to(acc) + v2 * dt
    return dict(
        positions=new_pos.float(), velocities=v2.float(),
        pressures=p.float(), boundary_forces=fb_force.float(),
        boundary_volumes=vol_b.float(), dii=dii, aii=aii,
        pressure_iters=iters,
        pressure_error=err, ncontacts_ff=len(ff), ncontacts_fb=len(fb),
        ncontacts_bb=n_bb,
    )

