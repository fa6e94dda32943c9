"""Shared machinery of the dense-layout pressure solver (main-path subset).

Port of ``salva_tpu.solver.dense_common``: binning, the per-substep
hoisted sums (density, gradient sums, gradient norms, boundary terms,
contact counts) and the per-iteration pair passes of dense DFSPH, on the
full-grid layout (one column per window cell, ``[cap, C]``; neighbor
views are flat rolls of the cell axis) with the sparse boundary binning
(boundary-owner passes over occupied boundary cells only) and the sparse
fluid-boundary hoist.

The three hot fluid-fluid passes (``k_pass``, ``t_pass`` and the ff
hoist) go through ``ops.pair``: hand kernels for CUDA tensors, the
half-stencil folds for CPU tensors. Everything else is plain torch.

Not ported (each raises ``NotImplementedError`` naming its flag): the
dense+spill structure (``dense_spill_columns``), the compact layout
(``dense_compact``), frozen pair coefficients (``dense_frozen_pairs``),
the full-grid boundary binning (``dense_sparse_boundary=False``) and the
full-stencil plain folds (``dense_half_stencil=False``); the multi-device
halo path has no counterpart yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import SimConfig
from ..geometry import dense_grid as dg
from ..kernels import get_kernel, w_dwr
from ..ops import pair


def per_fluid_mean_max_grid(values, fid, mask, num_fluids: int):
    """`per_fluid_mean_max` on grid layout: the mean over each fluid's
    live slots, then the max over fluids (`dfsph_solver.rs:150-160`)."""
    err = torch.zeros((), dtype=torch.float32, device=values.device)
    live = mask > 0
    for f in range(num_fluids):
        sel = live & (fid == f)
        s = torch.sum(torch.where(sel, values, 0.0))
        cnt = torch.sum(sel.to(torch.float32))
        err = torch.maximum(
            err, torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
        )
    return err


def fold_pairs(offsets, h, dim, pos_i, mask_i, pos_j, mask_j, jview,
               j_arrays: Dict, body, init):
    """Fold ``body(acc, dpos, r2, within, j) -> acc`` over all 3^dim
    neighbor views produced by ``jview(arr, o)``."""
    acc = init
    h2 = h * h
    for o in range(len(offsets)):
        pj = jview(pos_j, o)
        mj = jview(mask_j, o)
        j = {k: jview(v, o) for k, v in j_arrays.items()}
        dpos = [pos_i[d][:, None, :] - pj[d][None, :, :] for d in range(dim)]
        r2 = dpos[0] * dpos[0]
        for d in range(1, dim):
            r2 = r2 + dpos[d] * dpos[d]
        within = (r2 <= h2) & (mask_i[:, None, :] > 0) & (mj[None, :, :] > 0)
        acc = body(acc, dpos, r2, within, j)
    return acc


def _unsupported(sim: SimConfig):
    """The config flag of the first non-ported branch this configuration
    would take, or None."""
    if not sim.dense_sparse_boundary:
        return "dense_sparse_boundary=False (the full-grid boundary binning)"
    for flag in ("dense_compact", "dense_frozen_pairs", "dense_spill_columns"):
        if getattr(sim, flag, None):
            return flag
    if not sim.dense_half_stencil:
        return "dense_half_stencil=False (the full-stencil plain folds)"
    return None


class DenseCtx:
    """Per-substep binned state + hoisted sums (positions frozen).

    Hoisted quantities (per fluid slot):
    - ``rho``: density (`dfsph_solver.rs:628-665`);
    - ``Gf`` = sum_ff m_j grad; ``Gb`` = rho0_i sum_fb Volb_j grad;
      ``Gsum`` = Gf + Gb;
    - ``Sb`` = rho0_i sum_fb Volb_j (vb_j . grad);
    - ``sq_mm`` = sum |m_j grad|^2 (ff + fb)   [DFSPH alpha];
    - ``s2_m`` = sum m_j |grad|^2 (ff + fb), ``s2_ff`` ff-only [IISPH];
    - ``count``: pairs within h (incl. self).
    """

    def __init__(self, sim: SimConfig, spec_f, spec_b, fluids, boundaries,
                 need_s2: bool = True):
        flag = _unsupported(sim)
        if flag is not None:
            raise NotImplementedError(
                f"{flag} is not ported to salva_tpu_torch"
            )
        # ``need_s2``: accumulate the IISPH-only sums (s2_ff / s2_m).
        self.need_s2 = need_s2
        self._boundaries_volumes = boundaries.volumes
        self.sim = sim
        self.spec_f = spec_f
        self.spec_b = spec_b
        self.dim = sim.dim
        self.h = sim.h
        self.kd = get_kernel(sim.kernel_density)
        self.kg = get_kernel(sim.kernel_gradient)
        self.offsets = dg.neighbor_offsets(self.dim)
        dev = fluids.positions.device
        self.device = dev
        # Fluid-tracking grid window (config.fitted_dims): static dims,
        # origin recomputed here from the live fluid extent each substep.
        # Boundary particles outside the window are dropped from binning
        # (> h from any fluid by the margin) rather than clamped into the
        # border ring.
        self.fitted = getattr(sim, "fitted_dims", None) is not None
        self.drop_b = self.fitted
        self.origin_dyn = None
        if self.fitted:
            h = sim.h
            mins = np.asarray(sim.domain[0], np.float64)
            maxs = np.asarray(sim.domain[1], np.float64)
            o0 = mins - 2 * h
            full_dims = np.maximum(
                np.ceil((maxs - o0) / h).astype(int) + 2, 3
            )
            max_shift = np.maximum(
                full_dims - np.asarray(spec_f.dims), 0
            ).astype(np.float32)
            lo = torch.amin(
                torch.where(fluids.alive[:, None], fluids.positions, 1.0e30),
                dim=0,
            )
            anchor = torch.tensor(spec_f.origin, dtype=torch.float32,
                                  device=dev)
            shift = torch.floor((lo - 2.0 * h - anchor) / h)
            shift = torch.minimum(
                torch.clamp(shift, min=0.0),
                torch.from_numpy(max_shift).to(dev),
            )
            self.origin_dyn = anchor + shift * torch.tensor(
                h, dtype=torch.float32, device=dev
            )

        self.binf = dg.bin_particles(
            spec_f, fluids.positions, fluids.alive, origin=self.origin_dyn,
        )
        self.sf = spec_f
        offs = self.offsets
        self.jff = lambda arr, o: dg.shift_j(spec_f, arr, offs[o])
        # Boundary side compact (walls/floors occupy few cells):
        # boundary-owner passes run over A_b occupied columns; the compact
        # boundary arrays are rematerialized onto the full grid once
        # (below) so fluid-owner fb reads are roll views.
        a_b = max(
            64,
            min(
                spec_b.num_cells,
                int(boundaries.capacity
                    * sim.dense_active_ratio_boundary),
            ),
        )
        self.binb = dg.bin_particles_active(
            spec_b, a_b, boundaries.positions, boundaries.alive,
            cap=spec_b.cap, drop_clamped=self.drop_b,
            origin=self.origin_dyn,
        )
        self.sb = dg.ActiveSpec(a_b + 1, spec_b.cap)
        nbb = dg.neighbor_table(
            spec_f, self.binb.active_cells, self.binb.cell_to_active
        ).long()
        self.jbb = lambda arr, o: arr[..., nbb[:, o]]
        C = spec_f.num_cells
        shifts = torch.tensor(dg.flat_shifts(spec_f), dtype=torch.int64,
                              device=dev)
        active = self.binb.active_cells.long()  # [A_b + 1], void = C
        is_void = active >= C
        self._b_active = active
        self._b_is_void = is_void

        def jbf(arr, o):
            """Full-grid fluid column of each boundary active cell at
            offset o (void columns read column 0; their boundary
            slots are sentinel-masked)."""
            cols = torch.where(is_void, 0, active + shifts[o])
            return arr[..., torch.clamp(cols, 0, C - 1)]

        self.jbf = jbf
        self.maskf = self.binf.mask
        self.live = self.maskf > 0
        # Per-cell live counts [C] (ranks fill from 0): what the hand
        # kernels loop over instead of the cap padding.
        self.counts = self.live.sum(dim=0, dtype=torch.int32)
        self.uniform = getattr(sim, "uniform_particles", None)
        f_items = [
            (fluids.positions, dg.POS_SENTINEL),
            (fluids.velocities, 0.0),
        ]
        if self.uniform is None:
            f_items += [(fluids.masses, 0.0), (fluids.density0, 1.0)]
        f_grids = dg.to_grid_multi(self.sf, self.binf, f_items)
        self.P, self.V = f_grids[0], f_grids[1]
        if self.uniform is not None:
            # Constant channels derived from the mask — no shuffle at all.
            fid, m0, rho0 = self.uniform
            self.M = self.maskf * torch.tensor(m0, dtype=torch.float32,
                                               device=dev)
            self.R0 = torch.where(
                self.live, torch.tensor(rho0, dtype=torch.float32,
                                        device=dev), 1.0
            )
            self.FID = torch.where(self.live, int(fid), -1).to(torch.int32)
        else:
            self.M, self.R0 = f_grids[2], f_grids[3]
            self.FID = dg.to_grid(self.sf, self.binf, fluids.fluid_id,
                                  fill=-1)
        self.Pb, self.Vbvel = dg.to_grid_multi(
            self.sb, self.binb,
            [(boundaries.positions, dg.POS_SENTINEL),
             (boundaries.velocities, 0.0)],
        )
        self.maskb = self.binb.mask

        self._fb_adj_overflow = 0
        self._compute_boundary_volumes()
        self._hoist()

    @property
    def bin_overflow(self):
        return (self.binf.overflow + self.binb.overflow
                + self.binb.active_overflow + self._fb_adj_overflow)

    # -- per-substep passes -------------------------------------------------

    def _compute_boundary_volumes(self):
        """V_b = 1 / sum W_bb (`dfsph_solver.rs:72-96`), or the volumes a
        previous step stored when the world marks the boundaries unchanged
        (``sim.recompute_boundary_volumes = False``)."""
        if not getattr(self.sim, "recompute_boundary_volumes", True):
            self.Volb = dg.to_grid(
                self.sb, self.binb, self._boundaries_volumes
            )
            return
        kd_w, kd_dw = self.kd

        def body(acc, dpos, r2, within, j):
            w, _ = w_dwr(r2, self.h, self.dim, kd_w, kd_dw)
            return acc + torch.sum(torch.where(within, w, 0.0), dim=1)

        wsum = fold_pairs(
            self.offsets, self.h, self.dim, self.Pb, self.maskb,
            self.Pb, self.maskb, self.jbb, {}, body,
            torch.zeros_like(self.maskb),
        )
        self.Volb = torch.where(
            (wsum > 0) & (self.maskb > 0),
            1.0 / torch.where(wsum > 0, wsum, 1.0),
            0.0,
        )

    def _fb_body(self):
        kd_w, kd_dw = self.kd
        kg_w, kg_dw = self.kg
        dim, h, need_s2 = self.dim, self.h, self.need_s2

        def fb_body(acc, dpos, r2, within, j):
            rho, gb, sq, s2, sb, cnt = acc
            _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
            wd, _ = w_dwr(r2, h, dim, kd_w, kd_dw)
            vj = torch.where(within, j["vol"][None, :, :], 0.0)
            rho = rho + torch.sum(vj * wd, dim=1)
            gsq = torch.zeros_like(r2)
            vdotg = torch.zeros_like(r2)
            gb_new = []
            for d in range(dim):
                g_d = dpos[d] * dwr
                gb_new.append(gb[d] + torch.sum(g_d * vj, dim=1))
                gsq = gsq + g_d * g_d
                vdotg = vdotg + j["vb"][d][None, :, :] * g_d * vj
            sq = sq + torch.sum(gsq * vj * vj, dim=1)
            if need_s2:
                s2 = s2 + torch.sum(gsq * vj, dim=1)
            sb = sb + torch.sum(vdotg, dim=1)
            cnt = cnt + torch.sum(within, dim=1, dtype=torch.int32)
            return rho, torch.stack(gb_new), sq, s2, sb, cnt

        return fb_body

    def _hoist(self):
        dim, h = self.dim, self.h
        rho_ff, Gf, sq_ff, s2_ff, cnt_ff = pair.hoist_ff(
            self.spec_f, h, dim, self.sim.kernel_density,
            self.sim.kernel_gradient, self.P, self.M, self.counts,
            need_s2=self.need_s2,
        )

        fb_body = self._fb_body()
        if self._fb_cols():
            rho_fb, Gb_raw, sq_fb, s2_fb, Sb_raw, cnt_fb = (
                self._hoist_fb_sparse(fb_body)
            )
        else:
            # Roll-view fold over the compact boundary arrays
            # rematerialized onto the full grid.
            pb = self._to_full(self.Pb, dg.POS_SENTINEL)
            maskb, volb = self._to_full(self.maskb), self._to_full(self.Volb)
            vbvel = self._to_full(self.Vbvel)
            z = torch.zeros_like(self.maskf)
            rho_fb, Gb_raw, sq_fb, s2_fb, Sb_raw, cnt_fb = fold_pairs(
                self.offsets, h, dim, self.P, self.maskf, pb, maskb,
                self.jff, {"vol": volb, "vb": vbvel}, fb_body,
                (z, torch.zeros_like(self.P), z, z, z,
                 torch.zeros_like(self.maskf, dtype=torch.int32)),
            )

        R0 = self.R0
        self.rho = torch.where(self.live, rho_ff + R0 * rho_fb, R0)
        self.Gf = Gf
        self.Gb = R0[None] * Gb_raw
        self.Gsum = self.Gf + self.Gb
        self.Sb = R0 * Sb_raw
        self.sq_mm = sq_ff + R0 * R0 * sq_fb
        self.s2_ff = s2_ff
        self.s2_m = s2_ff + R0 * s2_fb
        self.count = cnt_ff + cnt_fb
        self.cnt_ff = cnt_ff
        self.cnt_fb = cnt_fb

    # -- sparse fluid-boundary hoist (config.dense_fb_columns) ---------------

    def _fb_cols(self) -> int:
        """Static boundary-adjacency table size for the sparse fb hoist,
        or 0 when the world set none (no boundaries) or the adjacency is
        near-dense (gathered columns would not beat the roll fold)."""
        cols = getattr(self.sim, "dense_fb_columns", None)
        if not cols:
            return 0
        cols = min(int(cols), self.spec_f.num_cells)
        if cols * 2 >= self.spec_f.num_cells:
            return 0
        return cols

    def _hoist_fb_sparse(self, fb_body):
        """The fb hoist over boundary-ADJACENT fluid columns only:

        1. the boundary occupancy mask [C] is dilated by the 3^dim flat
           shifts;
        2. the adjacent cell ids compact into a static [AFB] table via
           ``topk`` (keys ``C - cell`` are unique, so the table order is
           ascending cell id, as ``lax.top_k`` gives it); overflow is
           counted in ``bin_overflow``;
        3. the pair fold runs over ``[cap_f, cap_b, AFB]`` gathered blocks;
        4. the outputs scatter back into full-grid arrays (every other
           column's fb sums are exactly zero).
        """
        C = self.spec_f.num_cells
        dev = self.device
        AFB = self._fb_cols()
        shifts = dg.flat_shifts(self.spec_f)

        occ = torch.zeros((C + 1,), dtype=torch.bool, device=dev)
        occ[torch.where(self._b_is_void, C, self._b_active)] = True
        occ = occ[:C]
        adj = occ
        for s in shifts:
            if s != 0:
                adj = adj | torch.roll(occ, s)
        iota = torch.arange(C, dtype=torch.int32, device=dev)
        key = torch.where(adj, C - iota, 0)
        vals, af = torch.topk(key, AFB)
        got = vals > 0
        n_adj = adj.sum(dtype=torch.int32)
        self._fb_adj_overflow = torch.clamp(n_adj - AFB, min=0)
        af_g = torch.where(got, af, 0)

        # i-side: gathered fluid columns (mask zeroed on unused slots).
        Pi = self.P[..., af_g]
        maski = torch.where(got[None, :], self.maskf[..., af_g], 0.0)

        # j-side: boundary compact columns of each table cell's 3^dim
        # neighbors (void column for inactive cells).
        sh = torch.tensor(shifts, dtype=torch.int64, device=dev)
        nfb = self.binb.cell_to_active[
            torch.clamp(af_g[:, None] + sh[None, :], 0, C)
        ].long()  # [AFB, 3^dim]

        def jview(arr, o):
            return arr[..., nfb[:, o]]

        z = torch.zeros_like(maski)
        rho, Gb, sq, s2, sb, cnt = fold_pairs(
            self.offsets, self.h, self.dim, Pi, maski, self.Pb, self.maskb,
            jview, {"vol": self.Volb, "vb": self.Vbvel}, fb_body,
            (z, torch.zeros_like(Pi), z, z, z,
             torch.zeros_like(maski, dtype=torch.int32)),
        )

        # Scatter back to the grid (unused table slots target the spare
        # column C, which is cut off).
        af_sc = torch.where(got, af, C)
        packed = torch.cat(
            [rho[None], Gb, sq[None], s2[None], sb[None]], dim=0
        )
        fullf = torch.zeros(packed.shape[:-1] + (C + 1,), dtype=packed.dtype,
                            device=dev)
        fullf[..., af_sc] = packed
        fulli = torch.zeros(cnt.shape[:-1] + (C + 1,), dtype=cnt.dtype,
                            device=dev)
        fulli[..., af_sc] = cnt
        fullf, fulli = fullf[..., :C], fulli[..., :C]
        dim = self.dim
        return (fullf[0], fullf[1:1 + dim], fullf[1 + dim],
                fullf[2 + dim], fullf[3 + dim], fulli)

    # -- per-iteration passes -----------------------------------------------

    def t_pass(self, Q):
        """T_i = sum_ff m_j (Q_j . grad_ij) for a per-slot vector Q."""
        return pair.t_pass(
            self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
            self.P, self.M, Q, self.counts,
        )

    def k_pass(self, K):
        """K_i = sum_ff k_j m_j grad_ij for a per-slot scalar k."""
        return pair.k_pass(
            self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
            self.P, self.M, K, self.counts,
        )

    def delta_density(self, Vp):
        """sum m_j (v_i'-v_j').grad + boundary term via hoisted sums:
        = v_i'.Gsum - T(v') - Sb."""
        t = self.t_pass(Vp)
        return torch.sum(Vp * self.Gsum, dim=0) - t - self.Sb

    def boundary_forces(self, coef):
        """One boundary-owner pass: F_b = Volb_b sum_i grad_ij coef_i
        (grad w.r.t. the fluid point; dpos in the fold is p_b - p_i)."""
        kg_w, kg_dw = self.kg
        dim, h = self.dim, self.h

        def body(acc, dpos, r2, within, j):
            # No mask needed: coef is zero on dead fluid slots and the
            # sentinel positions zero dwr for any empty-slot pairing.
            _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
            c = j["coef"][None, :, :]
            return torch.stack(
                [acc[d] - torch.sum(dpos[d] * dwr * c, dim=1)
                 for d in range(dim)]
            )

        Fb = fold_pairs(
            self.offsets, h, dim, self.Pb, self.maskb, self.P, self.maskf,
            self.jbf, {"coef": coef}, body, torch.zeros_like(self.Pb),
        )
        return self.Volb[None] * Fb

    # -- layout conversion ---------------------------------------------------

    def _to_full(self, arr, fill=0.0):
        """Compact boundary columns [..., A_b+1] -> full grid [..., C]
        (the void column and unused slots land in a spare column)."""
        C = self.spec_f.num_cells
        cols = torch.where(self._b_is_void, C, self._b_active)
        full = torch.full(arr.shape[:-1] + (C + 1,), fill, dtype=arr.dtype,
                          device=arr.device)
        full[..., cols] = arr
        return full[..., :C]

    def to_f(self, values, fill=0.0):
        """Per-particle fluid values [N] / [N, D] -> grid layout."""
        return dg.to_grid(self.sf, self.binf, values, fill)

    def unbin_f(self, grid, fallback):
        """Fluid grid [cap, C] / [D, cap, C] -> particles; particles not
        in the grid keep ``fallback``."""
        return self._unbin(self.sf, self.binf, grid, fallback)

    def unbin_b(self, grid, fallback):
        """Boundary twin of :meth:`unbin_f`."""
        return self._unbin(self.sb, self.binb, grid, fallback)

    @staticmethod
    def _unbin(spec, binned, grid, fallback):
        out = dg.from_grid(spec, binned, grid, 0.0)
        sel = binned.in_grid[:, None] if out.ndim == 2 else binned.in_grid
        return torch.where(sel, out, fallback)

    def unbin_f_multi(self, items):
        """Unbin several fluid grids with ONE packed row gather.
        ``items``: [(grid, fallback)]."""
        return self._unbin_multi(self.sf, self.binf, items)

    def unbin_b_multi(self, items):
        """Boundary twin of :meth:`unbin_f_multi`."""
        return self._unbin_multi(self.sb, self.binb, items)

    @staticmethod
    def _unbin_multi(spec, binned, items):
        outs = dg.from_grid_multi(spec, binned, [g for g, _ in items])
        res = []
        for out, (_g, fb) in zip(outs, items):
            sel = binned.in_grid[:, None] if out.ndim == 2 else binned.in_grid
            res.append(torch.where(sel, out, fb))
        return res
