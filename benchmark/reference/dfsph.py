"""A plain DFSPH step with static boundary particles, written from the method.

One step of Divergence-Free SPH (Bender and Koschier 2015, as salva runs
it: `src/solver/pressure/dfsph_solver.rs`) with static boundary
particles (Akinci et al. 2012 volumes) and the configuration's
non-pressure forces (each a module of ``reference/forces/``, handed in as
callables of a ``Forces`` context), over explicit pair lists found by a
cell search. Stage order, as in salva: boundary volumes, densities and
the alpha factors; the divergence solve on the velocities plus the
velocity changes carried from the previous step; commit; gravity and the
non-pressure forces; the density solve; x += (v + dv) dt, with dv carried to the
next step; the boundary particles' forces from the summed stiffnesses.

Every sum runs over pair lists with ``index_add_`` in ``acc_dtype`` and
every pair term in ``pair_dtype`` (float64 both, by default: the
reference is more exact than the float32 program it judges). Which pairs
lie within the support radius is decided in float32 with r^2 rounded as
(dx^2 + dy^2) + dz^2, the rule the configuration states, so that both
sides count the same contacts. Imports torch only.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# The cubic spline's derivative cutoff (`cubic_spline_kernel.rs:71`).
CUBIC_DIFF_EPS = 1.0e-5


@dataclasses.dataclass(frozen=True)
class Params:
    """Physical constants of one configuration (SI units)."""

    h: float
    mass: float
    density0: float
    gravity: tuple
    dt: float
    max_density_error: float = 0.05
    max_divergence_error: float = 0.1
    min_iter: int = 1
    max_iter: int = 50
    min_neighbors: int = 20

    @staticmethod
    def from_config(cfg):
        r = float(cfg["particle_radius"])
        rho0 = float(cfg["density0"])
        # h = 2 r x smoothing factor; mass = 0.8 (2r)^3 rho0
        # (`liquid_world.rs:47`, `fluid.rs:110-120`).
        return Params(
            h=r * float(cfg["smoothing_factor"]) * 2.0,
            mass=r * r * r * 8.0 * 0.8 * rho0,
            density0=rho0,
            gravity=tuple(float(g) for g in cfg["gravity"]),
            dt=float(cfg["dt"]),
        )


def cubic_w_dwr(r2, h: float):
    """(W, dW/dr / r) of the 3D cubic spline from squared distances."""
    norm = 8.0 / (math.pi * h ** 3)
    q2 = r2 / (h * h)
    q = torch.sqrt(q2)
    one_q = 1.0 - q
    w = torch.where(q <= 0.5, 1.0 + (q2 * q - q2) * 6.0,
                    torch.where(q <= 1.0, 2.0 * one_q ** 3,
                                torch.zeros_like(q)))
    # dW/dr = norm / h * [6q(3q - 2) near, -6(1 - q)^2 far]; / r = / (q h).
    near = 18.0 * q - 12.0
    far = -6.0 * one_q * one_q / torch.where(q > 0, q, torch.ones_like(q))
    dwr = torch.where((q > 1.0) | (q <= CUBIC_DIFF_EPS), torch.zeros_like(q),
                      torch.where(q <= 0.5, near, far))
    return norm * w, dwr * (norm / (h * h))


class Pairs:
    """Directed pairs (i, j) with |x_i - y_j| <= h, i over ``x``, j over
    ``y``: index lists and the float32 displacement x_i - y_j."""

    def __init__(self, x, y, h: float, block: int = 16384):
        dev = x.device
        h2 = torch.tensor(h * h, dtype=torch.float32)
        side = h * (1.0 + 1e-6)
        lo = torch.minimum(x.amin(0), y.amin(0)).double() - side
        cx = torch.floor((x.double() - lo) / side).long()
        cy = torch.floor((y.double() - lo) / side).long()
        dims = torch.maximum(cx.amax(0), cy.amax(0)) + 2
        lin_y = (cy[:, 0] * dims[1] + cy[:, 1]) * dims[2] + cy[:, 2]
        order = torch.argsort(lin_y)
        ncell = int(dims.prod())
        count = torch.bincount(lin_y, minlength=ncell)
        start = torch.cumsum(count, 0) - count
        width = max(int(count.max()) if len(y) else 0, 1)
        offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                             for c in (-1, 0, 1)], device=dev)
        rank = torch.arange(width, device=dev)
        ii, jj = [], []
        for b0 in range(0, len(x), block):
            c = cx[b0:b0 + block, None, :] + offs[None]        # [B, 27, 3]
            ok = ((c >= 0) & (c < dims)).all(-1)
            lin = (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
            lin = torch.where(ok, lin, 0)
            st = start[lin]
            cnt = torch.where(ok, count[lin], 0)
            valid = rank[None, None] < cnt[..., None]           # [B, 27, W]
            slot = torch.clamp(st[..., None] + rank, max=max(len(y) - 1, 0))
            j = order[slot]
            i = torch.arange(b0, b0 + c.shape[0], device=dev)
            i = i[:, None, None].expand_as(j)
            i, j = i[valid], j[valid]
            d = x[i] - y[j]
            r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
            r2 = r2 + d[:, 2] * d[:, 2]
            keep = r2 <= h2.to(dev)
            ii.append(i[keep])
            jj.append(j[keep])
        self.i = torch.cat(ii) if ii else torch.zeros(0, dtype=torch.long)
        self.j = torch.cat(jj) if jj else torch.zeros(0, dtype=torch.long)
        self.dpos32 = x[self.i] - y[self.j]

    def __len__(self):
        return int(self.i.shape[0])


def _terms(pairs: Pairs, h: float, dtype):
    """(dpos, r2, W, dW/dr / r) of every pair, in ``dtype``."""
    d = pairs.dpos32.to(dtype)
    r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    w, dwr = cubic_w_dwr(r2, h)
    return d, r2, w, dwr


@dataclasses.dataclass
class Forces:
    """What a non-pressure force reads, at the committed velocities: the
    fluid-fluid pairs (owners ``i``, partners ``j``, displacement ``d``,
    squared distance ``r2``, gradient ``grad`` of W_ij, in ``pair_dtype``),
    the fluid-boundary pairs (``i_fb``, ``j_fb``, ``d_fb``, ``grad_fb``,
    the boundary volumes ``vol_b`` of each pair), the velocities and
    densities (``acc_dtype``)."""

    n: int
    h: float
    mass: float
    density0: float
    i: torch.Tensor
    j: torch.Tensor
    d: torch.Tensor
    r2: torch.Tensor
    grad: torch.Tensor
    i_fb: torch.Tensor
    j_fb: torch.Tensor
    d_fb: torch.Tensor
    grad_fb: torch.Tensor
    vol_b: torch.Tensor
    velocities: torch.Tensor
    densities: torch.Tensor
    pair_dtype: torch.dtype
    acc_dtype: torch.dtype

    def sum_i(self, idx, values):
        """Per-particle sums of pair ``values`` over owners ``idx``."""
        return _sum_i(self.n, idx, values, self.acc_dtype)


def _sum_i(n, idx, values, acc):
    """Per-i sums of ``values`` [P] or [P, 3] over pair owners ``idx``."""
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=acc,
                      device=values.device)
    return out.index_add_(0, idx, values.to(acc))


def boundary_volumes(pb, h: float, pair_dtype=torch.float64,
                     acc_dtype=torch.float64):
    """V_b = 1 / sum_k W(|p_b - p_k|) over boundary particles within h,
    the particle itself included (Akinci et al. 2012)."""
    bb = Pairs(pb, pb, h)
    _, _, w, _ = _terms(bb, h, pair_dtype)
    wsum = _sum_i(len(pb), bb.i, w, acc_dtype)
    return torch.where(wsum > 0, 1.0 / torch.where(wsum > 0, wsum, 1.0),
                       torch.zeros_like(wsum)), len(bb)


def step(prm: Params, pos, vel, dv, pb, forces=(), pair_dtype=torch.float64,
         acc_dtype=torch.float64):
    """One DFSPH step of the live fluid particles.

    ``pos``, ``vel``, ``dv`` [n, 3] float32: positions, velocities and the
    velocity changes carried from the previous step; ``pb`` [nb, 3]
    float32: the boundary particles (at rest); ``forces``: callables that
    take a ``Forces`` context and return each particle's acceleration
    [n, 3] in its ``acc_dtype``. Returns a dict of float32
    ``positions``, ``velocities``, ``dv`` and ``boundary_forces`` [nb, 3],
    the iteration counts and the contact counts."""
    n, nb = pos.shape[0], pb.shape[0]
    h, m, rho0, dt = prm.h, prm.mass, prm.density0, prm.dt
    inv_dt = 1.0 / dt
    acc = acc_dtype
    ff = Pairs(pos, pos, h)
    fb = Pairs(pos, pb, h)
    vol_b, n_bb = boundary_volumes(pb, h, pair_dtype, acc)

    d_ff, r2_ff, w_ff, dwr_ff = _terms(ff, h, pair_dtype)
    d_fb, _, w_fb, dwr_fb = _terms(fb, h, pair_dtype)
    g_ff = d_ff * dwr_ff[:, None]                    # grad_i W_ij
    g_fb = d_fb * dwr_fb[:, None]
    vb = vol_b.to(pair_dtype)[fb.j]
    i_ff, j_ff, i_fb = ff.i, ff.j, fb.i

    rho = (_sum_i(n, i_ff, w_ff * m, acc)
           + rho0 * _sum_i(n, i_fb, w_fb * vb, acc))
    gsum = (_sum_i(n, i_ff, g_ff * m, acc)
            + rho0 * _sum_i(n, i_fb, g_fb * vb[:, None], acc))
    sq = (_sum_i(n, i_ff, (g_ff * m).pow(2).sum(1), acc)
          + rho0 * rho0 * _sum_i(n, i_fb, (g_fb * vb[:, None]).pow(2).sum(1),
                                 acc))
    count = (torch.bincount(i_ff, minlength=n)
             + torch.bincount(i_fb, minlength=n))
    denom = sq + (gsum * gsum).sum(1)
    alpha = torch.where(denom <= 1.0e-5, torch.zeros_like(denom),
                        1.0 / torch.where(denom == 0, 1.0, denom))
    enough = count >= prm.min_neighbors

    def delta_density(v):
        """sum_j m (v_i - v_j) . grad_ij + rho0 sum_b V_b v_i . grad_ib
        (the boundary particles are at rest)."""
        vp = v.to(pair_dtype)
        t = _sum_i(n, i_ff, (vp[j_ff] * g_ff).sum(1) * m, acc)
        return (v.to(acc) * gsum).sum(1) - t

    def kappa_dv(k):
        """-(k_i gsum_i + sum_j k_j m grad_ij): the velocity change of a
        stiffness field (pair coefficient k_i + k_j with the fluid,
        k_i with the boundary)."""
        kp = k.to(pair_dtype)
        kj = _sum_i(n, i_ff, g_ff * (kp[j_ff] * m)[:, None], acc)
        return -(k[:, None] * gsum + kj)

    def mean(values):
        return values.sum() / n

    v0 = vel.to(acc)
    dv_div = dv.to(acc)
    tol = prm.max_divergence_error * inv_dt * 0.01
    ksum_d = torch.zeros(n, dtype=acc, device=pos.device)
    div_iters = 0
    while div_iters < prm.max_iter:
        div = torch.where(enough, torch.clamp(delta_density(v0 + dv_div),
                                              min=0.0),
                          torch.zeros(n, dtype=acc, device=pos.device))
        err = float(mean(div / rho0))
        done = div_iters >= prm.min_iter and err <= tol
        div_iters += 1
        if done:
            break
        ki = div * alpha
        dv_div = dv_div + kappa_dv(ki)
        ksum_d = ksum_d + ki
    v2 = v0 + dv_div

    # Gravity and the non-pressure forces on the committed velocities.
    accel = torch.tensor(prm.gravity, dtype=acc,
                         device=pos.device).expand(n, 3).clone()
    ctx = Forces(n=n, h=h, mass=m, density0=rho0, i=i_ff, j=j_ff, d=d_ff,
                 r2=r2_ff, grad=g_ff, i_fb=i_fb, j_fb=fb.j, d_fb=d_fb,
                 grad_fb=g_fb, vol_b=vb, velocities=v2, densities=rho,
                 pair_dtype=pair_dtype, acc_dtype=acc)
    for force in forces:
        accel = accel + force(ctx)
    dv_p = accel * dt

    ksum_p = torch.zeros(n, dtype=acc, device=pos.device)
    p_iters = 0
    while p_iters < prm.max_iter:
        predicted = rho + delta_density(v2 + dv_p) * dt
        err_i = torch.where(predicted < rho0, torch.zeros_like(predicted),
                            predicted / rho0 - 1.0)
        err = float(mean(err_i))
        done = p_iters >= prm.min_iter and err <= prm.max_density_error
        p_iters += 1
        if done:
            break
        ki = torch.clamp((predicted - rho0) * alpha, min=0.0)
        dv_p = dv_p + kappa_dv(ki) * inv_dt
        ksum_p = ksum_p + ki

    new_pos = pos.to(acc) + (v2 + dv_p) * dt
    # Force on each boundary particle: V_b sum_i grad_i W_ib c_i with
    # c_i = rho0 m (ksum_div + ksum_p / dt) / dt.
    coef = rho0 * m * inv_dt * (ksum_d + inv_dt * ksum_p)
    fb_force = _sum_i(nb, fb.j, g_fb * (vb * coef.to(pair_dtype)[i_fb])[:, None],
                      acc)
    return dict(
        positions=new_pos.float(), velocities=v2.float(), dv=dv_p.float(),
        boundary_forces=fb_force.float(), boundary_volumes=vol_b.float(),
        pressure_iters=p_iters, divergence_iters=div_iters,
        ncontacts_ff=len(ff), ncontacts_fb=len(fb), ncontacts_bb=n_bb,
    )
