"""Shared machinery of the dense-layout pressure solvers (DFSPH, IISPH).

Port of ``salva_tpu.solver.dense_common``: binning, the per-substep
hoisted sums (density, gradient sums, gradient norms, boundary terms,
contact counts) and the per-iteration pair passes of the dense solvers,
on the full-grid layout (one column per window cell, ``[cap, C]``;
neighbor views are flat rolls of the cell axis), with either boundary
binning: sparse (``dense_sparse_boundary=True``, the default:
boundary-owner passes over occupied boundary cells only, and the sparse
fluid-boundary hoist over boundary-adjacent fluid columns) or full-grid
(``False``: the boundaries bin into the fluid grid's cells).

The brute all-pairs tier (a ``brute_spec`` fluid spec) binds both
particle sets to a 1D cyclic grid by index and walks its cyclic offsets
0..C-1 instead of a cell stencil; every view is a roll and every layout
shuffle a gather through the binding's ``grid_src``.

The four hot passes (``k_pass``, ``t_pass``, the ff hoist and the fb
hoist) go through ``ops.pair`` (hand kernels for CUDA tensors, the plain
half-stencil versions for CPU tensors), except where the reference runs
its full-stencil plain folds (``solver/full_folds.py``): on the brute
tier, on every device (the reference runs no Pallas kernel there, and
no hand kernel runs here), and on a grid with
``dense_half_stencil=False`` for CPU tensors (for CUDA tensors the
kernels, which walk the full stencil). The sorted binnings' layout
shuffles (``to_grid`` / ``to_grid_multi``) go through ``ops.binning``.
Everything else, the non-pressure forces included, is plain torch.

With a ``halo`` (``parallel/domain.py``, the slab path) the context
covers one x-slab of the grid and its two ghost layers
(``dense_grid.bin_particles_slab``), with the full-grid boundary binning
and neither the half stencil, the fitted window nor the sparse fb
table, as in the JAX package. Unlike the JAX package's slab path, the
hand kernels stay on for CUDA tensors: they treat the cells beyond the
local grid as empty where the plain folds roll cyclically, which gives
different values on the ghost columns only, and every ghost column a
solver or force reads is first overwritten by a ``halo.exchange``.

Not ported (each raises ``NotImplementedError`` naming its flag): the
dense+spill structure (``dense_spill_columns``), the compact layout
(``dense_compact``) and frozen pair coefficients
(``dense_frozen_pairs``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..geometry import dense_grid as dg
from ..kernels import get_kernel, w_dwr
from ..ops import pair
from ..ops.pair import fold_pairs
from . import full_folds


def per_fluid_mean_max_grid(values, fid, mask, num_fluids: int, halo=None,
                            interior=None):
    """`per_fluid_mean_max` on grid layout: the mean over each fluid's
    live slots, then the max over fluids (`dfsph_solver.rs:150-160`).

    With ``halo`` / ``interior`` set (the slab path), each slab reduces
    over its owned slots and the sums and counts are summed over the
    slabs, so every slab computes the reference's global mean error."""
    err = torch.zeros((), dtype=torch.float32, device=values.device)
    live = mask > 0
    if interior is not None:
        live = live & interior
    for f in range(num_fluids):
        sel = live & (fid == f)
        s = torch.sum(torch.where(sel, values, 0.0))
        cnt = torch.sum(sel.to(torch.float32))
        if halo is not None:
            s = halo.psum(s)
            cnt = halo.psum(cnt)
        err = torch.maximum(
            err, torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
        )
    return err


def _unsupported(sim: SimConfig):
    """The config flag of the first non-ported branch this configuration
    would take, or None."""
    for flag in ("dense_compact", "dense_frozen_pairs", "dense_spill_columns"):
        if getattr(sim, flag, None):
            return flag
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
                 halo=None, need_s2: bool = True):
        flag = _unsupported(sim)
        if flag is not None:
            raise NotImplementedError(
                f"{flag} is not ported to salva_tpu_torch"
            )
        # ``need_s2``: accumulate the IISPH-only sums (s2_ff / s2_m).
        self.need_s2 = need_s2
        self.sim = sim
        self.spec_f = spec_f
        self.spec_b = spec_b
        self.dim = sim.dim
        self.h = sim.h
        self.kd = get_kernel(sim.kernel_density)
        self.kg = get_kernel(sim.kernel_gradient)
        dev = fluids.positions.device
        self.device = dev
        # Brute all-pairs tier (``dense_grid.brute_spec``): a 1D cyclic
        # grid whose offsets 0..C-1 pair every cell with every cell.
        self.brute = spec_f.brute
        self.offsets = dg.stencil_offsets(spec_f)
        self.halo = halo
        # The full-stencil plain folds run the hot passes on the brute
        # tier (every device) and, for CPU tensors, on a grid without the
        # half stencil (a slab has none); ``ops.pair`` runs them
        # everywhere else.
        self.use_full_folds = self.brute or (
            dev.type == "cpu"
            and (halo is not None or not sim.dense_half_stencil)
        )
        # Fluid-tracking grid window (config.fitted_dims): static dims,
        # origin recomputed here from the live fluid extent each substep.
        # Boundary particles outside the window are dropped from binning
        # (> h from any fluid by the margin) rather than clamped into the
        # border ring.
        self.fitted = (getattr(sim, "fitted_dims", None) is not None
                       and halo is None and not self.brute)
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
            shift = torch.floor((lo - 2.0 * h - anchor) * dg.inv_width(h))
            shift = torch.minimum(
                torch.clamp(shift, min=0.0),
                torch.from_numpy(max_shift).to(dev),
            )
            self.origin_dyn = anchor + shift * torch.tensor(
                h, dtype=torch.float32, device=dev
            )

        self.sf = spec_f
        self.interior = None
        if halo is not None:
            # The slab path: this slab's extended x-range of the grid;
            # every view rolls the LOCAL cell axis, and the slab binning
            # fills the ghost layers.
            nxl = halo.nxl
            self.binf = dg.bin_particles_slab(
                spec_f, nxl, halo.x0, fluids.positions, fluids.alive)
            self.binb = dg.bin_particles_slab(
                spec_b, nxl, halo.x0, boundaries.positions, boundaries.alive)
            spec_f = spec_f.replace(dims=(nxl + 2,) + spec_f.dims[1:])
            spec_b = spec_b.replace(dims=(nxl + 2,) + spec_b.dims[1:])
            self.spec_f = self.sf = spec_f
            self.spec_b = spec_b
            # Slot ownership: the columns of the owned layers.
            layer = torch.arange(spec_f.num_cells, device=dev) // halo.nyz
            self.interior = ((layer >= 1) & (layer < nxl + 1))[None, :]
        offs = self.offsets
        self.jff = lambda arr, o: dg.shift_j(spec_f, arr, offs[o])
        # Fluid-owner / boundary-j view of the non-pressure forces: a roll
        # on both boundary binnings (under the sparse one the forces read
        # the boundary arrays rematerialized onto the full grid, see
        # ``force_field_views``).
        self.jfb = self.jff
        self.sparse_b = (bool(sim.dense_sparse_boundary) and not self.brute
                         and halo is None)
        if self.brute:
            # Identity bindings on the same cyclic columns: every view is
            # a roll (the fitted window and the sparse tables stay off).
            self.binf = dg.bin_particles_brute(spec_f, fluids.alive)
            self.binb = dg.bin_particles_brute(spec_b, boundaries.alive)
        elif halo is None:
            self.binf = dg.bin_particles(
                spec_f, fluids.positions, fluids.alive,
                origin=self.origin_dyn,
            )
            if not self.sparse_b:
                # Full-grid boundary binning: the boundary grid is the
                # fluid grid's [cap_b, C].
                self.binb = dg.bin_particles(
                    spec_b, boundaries.positions, boundaries.alive,
                    drop_clamped=self.drop_b, origin=self.origin_dyn,
                )
        if self.sparse_b:
            self._bin_boundaries_sparse(sim, spec_f, spec_b, boundaries)
        else:
            # The boundary grid has the fluid grid's columns, so every
            # fluid/boundary view is a roll.
            self.sb = spec_b
            self.jbf = self.jbb = self.jff
        self.maskf = self.binf.mask
        self.live = self.maskf > 0
        # Per-cell live counts [C] (ranks fill from 0 on the sorted
        # binnings): what the hand kernels loop over instead of the cap
        # padding.
        self.counts = self.live.sum(dim=0, dtype=torch.int32)
        self.uniform = getattr(sim, "uniform_particles", None)
        f_items = [
            (fluids.positions, dg.POS_SENTINEL),
            (fluids.velocities, 0.0),
        ]
        if self.uniform is None:
            f_items += [(fluids.masses, 0.0), (fluids.density0, 1.0)]
        b_items = [(boundaries.positions, dg.POS_SENTINEL),
                   (boundaries.velocities, 0.0)]
        # The volumes a previous step stored, when the world marks the
        # boundaries unchanged (``_compute_boundary_volumes``).
        self._volumes_cached = not getattr(sim, "recompute_boundary_volumes",
                                           True)
        if self._volumes_cached:
            b_items.append((boundaries.volumes, 0.0))
        # Both binnings' layout shuffles in one call (one kernel launch on
        # the card).
        f_grids, b_grids = dg.to_grid_multi2(self.sf, self.binf, f_items,
                                             self.sb, self.binb, b_items)
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
        self.Pb, self.Vbvel = b_grids[0], b_grids[1]
        self._volumes_grid = b_grids[2] if self._volumes_cached else None
        self.maskb = self.binb.mask
        self.counts_b = (self.maskb > 0).sum(dim=0, dtype=torch.int32)

        self._fb_adj_overflow = 0
        self._full_b = None  # force_field_views' full-grid boundary arrays
        self._compute_boundary_volumes()
        self._hoist()

    def _bin_boundaries_sparse(self, sim, spec_f, spec_b, boundaries):
        """Boundary side compact (walls/floors occupy few cells):
        boundary-owner passes run over A_b occupied columns; the
        fluid-owner fb hoist reads them through ``cell_to_active``."""
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
                              device=self.device)
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

    @property
    def bin_overflow(self):
        extra = self.binb.active_overflow if self.sparse_b else 0
        return (self.binf.overflow + self.binb.overflow + extra
                + self._fb_adj_overflow)

    # -- per-substep passes -------------------------------------------------

    def _compute_boundary_volumes(self):
        """V_b = 1 / sum W_bb (`dfsph_solver.rs:72-96`), or the volumes a
        previous step stored when the world marks the boundaries unchanged
        (``sim.recompute_boundary_volumes = False``)."""
        if self._volumes_cached:
            self.Volb = self._volumes_grid
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
        if self.halo is not None:
            # A ghost boundary cell summed half its neighbourhood; the fb
            # passes read Volb at j, so refresh it from the owners.
            self.Volb = self.halo.exchange(self.Volb)

    def _hoist(self):
        dim, h = self.dim, self.h
        kd, kg = self.sim.kernel_density, self.sim.kernel_gradient
        if self.use_full_folds:
            rho_ff, Gf, sq_ff, s2_ff, cnt_ff = full_folds.hoist_ff(
                self.spec_f, h, dim, kd, kg, self.P, self.M, self.maskf,
                need_s2=self.need_s2,
            )
        else:
            rho_ff, Gf, sq_ff, s2_ff, cnt_ff = pair.hoist_ff(
                self.spec_f, h, dim, kd, kg, self.P, self.M, self.counts,
                need_s2=self.need_s2,
            )
        if self.brute:
            fb = full_folds.hoist_fb(
                self.spec_f, h, dim, kd, kg, self.P, self.maskf, self.Pb,
                self.maskb, self.Volb, self.Vbvel, need_s2=self.need_s2,
            )
        else:
            # The fb hoist, one pass for the three grid branches of the
            # reference (its fb hoist is a full fold with or without the
            # half stencil): the sparse table (boundary-adjacent columns
            # only), every column over the compact boundary table
            # (near-dense adjacency or no boundaries), and the full-grid
            # boundary binning (identity map).
            fb = pair.hoist_fb(
                self.spec_f, h, dim, kd, kg, self.P, self.counts, self.Pb,
                self.Volb, self.Vbvel, self.counts_b,
                cell_to_col=(self.binb.cell_to_active if self.sparse_b
                             else None),
                cols=self._fb_table() if self._fb_cols() else None,
                need_s2=self.need_s2,
            )
        rho_fb, Gb_raw, sq_fb, s2_fb, Sb_raw, cnt_fb = fb

        R0 = self.R0
        self.rho = torch.where(self.live, rho_ff + R0 * rho_fb, R0)
        if self.halo is not None:
            # The single-pass forces (XSPH, artificial viscosity) and the
            # solvers read rho at j.
            self.rho = self.halo.exchange(self.rho)
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

    def contact_diagnostics(self):
        """The binning's and the hoist's ``StepDiagnostics`` fields: contact
        counts over the owned live slots, bin overflow, clamps and the peak
        density ratio; on the slab path summed (the ratio: maxed) over the
        slabs."""
        own = self.live if self.interior is None else self.live & self.interior
        d = dict(
            ncontacts_ff=torch.where(own, self.cnt_ff, 0).sum(
                dtype=torch.int32),
            ncontacts_fb=torch.where(own, self.cnt_fb, 0).sum(
                dtype=torch.int32),
            neighbor_overflow=torch.as_tensor(self.bin_overflow,
                                              dtype=torch.int32),
            candidate_overflow=self.binf.clamped + self.binb.clamped,
            max_density_ratio=torch.clamp(
                torch.where(own, self.rho / self.R0, 0.0).amax(), min=0.0),
        )
        if self.halo is not None:
            d = {k: (self.halo.pmax(v) if k == "max_density_ratio"
                     else self.halo.psum(v)) for k, v in d.items()}
        return d

    # -- sparse fluid-boundary hoist (config.dense_fb_columns) ---------------

    def _fb_cols(self) -> int:
        """Static boundary-adjacency table size for the sparse fb hoist,
        or 0 when the world set none (no boundaries, or the full-grid
        boundary binning) or the adjacency is near-dense (the table would
        not save work)."""
        cols = getattr(self.sim, "dense_fb_columns", None)
        if not cols or not self.sparse_b:
            return 0
        cols = min(int(cols), self.spec_f.num_cells)
        if cols * 2 >= self.spec_f.num_cells:
            return 0
        return cols

    def _fb_table(self):
        """The fluid columns of the sparse fb hoist, [AFB] int32 (unused
        entries = C):

        1. the boundary occupancy mask [C] is dilated by the 3^dim flat
           shifts;
        2. the adjacent cell ids compact into a static [AFB] table via
           ``topk`` (keys ``C - cell`` are unique, so the table order is
           ascending cell id, as ``lax.top_k`` gives it); overflow is
           counted in ``bin_overflow``, and the columns past the table
           are dropped exactly as the reference drops them.
        """
        C = self.spec_f.num_cells
        dev = self.device
        AFB = self._fb_cols()
        occ = torch.zeros((C + 1,), dtype=torch.bool, device=dev)
        occ[torch.where(self._b_is_void, C, self._b_active)] = True
        occ = occ[:C]
        adj = occ
        for s in dg.flat_shifts(self.spec_f):
            if s != 0:
                adj = adj | torch.roll(occ, s)
        iota = torch.arange(C, dtype=torch.int32, device=dev)
        key = torch.where(adj, C - iota, 0)
        vals, af = torch.topk(key, AFB)
        n_adj = adj.sum(dtype=torch.int32)
        self._fb_adj_overflow = torch.clamp(n_adj - AFB, min=0)
        return torch.where(vals > 0, af, C).to(torch.int32)

    # -- per-iteration passes -----------------------------------------------

    def t_pass(self, Q):
        """T_i = sum_ff m_j (Q_j . grad_ij) for a per-slot vector Q."""
        args = (self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
                self.P, self.M, Q)
        if self.use_full_folds:
            return full_folds.t_pass(*args)
        return pair.t_pass(*args, self.counts)

    def k_pass(self, K):
        """K_i = sum_ff k_j m_j grad_ij for a per-slot scalar k."""
        args = (self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
                self.P, self.M, K)
        if self.use_full_folds:
            return full_folds.k_pass(*args)
        return pair.k_pass(*args, self.counts)

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

    # -- force-facing views ---------------------------------------------------

    def force_field_views(self):
        """(jfb, jbf, Pb, Vbvel, Volb, maskb) as the non-pressure force
        passes (``forces_dense``) consume them.

        Under the sparse boundary binning the compact boundary arrays are
        rematerialized onto the full grid here, at the first call of a
        substep (only a pair force asks for them), so that the force
        passes run as plain roll-view blocks, as in the JAX package."""
        if not self.sparse_b:
            return (self.jfb, self.jbf, self.Pb, self.Vbvel, self.Volb,
                    self.maskb)
        if self._full_b is None:
            C = self.spec_f.num_cells
            cols = torch.where(self._b_is_void, C, self._b_active)

            def to_full(arr, fill=0.0):
                full = torch.full(arr.shape[:-1] + (C + 1,), fill,
                                  dtype=arr.dtype, device=arr.device)
                full[..., cols] = arr  # void columns land in the spare C
                return full[..., :C]

            self._full_b = (to_full(self.Pb, dg.POS_SENTINEL),
                            to_full(self.Vbvel), to_full(self.Volb),
                            to_full(self.maskb))
        return (self.jff, self.jff) + self._full_b

    def np_fb_to_native(self, fb_full):
        """Bring a force boundary-feedback grid back to the native
        boundary layout (full grid -> compact columns in sparse mode)."""
        if not self.sparse_b:
            return fb_full
        gather_cols = torch.where(self._b_is_void, 0, self._b_active)
        out = fb_full[..., gather_cols]
        return out * self.maskb[None] if out.ndim == 3 else out * self.maskb

    def vol_grid(self, fluids):
        """Particle volumes in grid layout (mask-derived when uniform)."""
        if self.uniform is not None:
            _fid, m0, rho0 = self.uniform
            return self.maskf * torch.tensor(m0 / rho0, dtype=torch.float32,
                                             device=self.device)
        return self.to_f(fluids.volumes)

    def apply_forces(self, dense_forces, fluids, V, dt, inv_dt, A, es=None):
        """The non-pressure stage of predict_advection: ``A`` plus each
        dense force's acceleration on the live slots, in order, and the
        summed boundary feedback of the forces in the native boundary
        layout (None when no force feeds back). ``V``: the velocities the
        forces read (DFSPH: after the divergence solve). A
        ``ParticleWiseForce`` (the elasticity) runs in particle layout on
        ``fluids`` and the elasticity state ``es``, and is binned into the
        grid; the pair forces' field views are built only when one runs."""
        from .forces_dense import DenseFields, ParticleWiseForce

        fields = None
        fb = None
        for force in dense_forces:
            if isinstance(force, ParticleWiseForce):
                a_p = force.force.apply_particles(fluids, es, self.dim)
                A = A + self.to_f(a_p) * self.maskf[None]
                continue
            if fields is None:
                jfb, jbf, Pb, Vbvel, Volb, maskb = self.force_field_views()
                fields = DenseFields(
                    jff=self.jff, jfb=jfb, jbf=jbf,
                    n_offsets=len(self.offsets), P=self.P, V=V, M=self.M,
                    VOL=self.vol_grid(fluids), R0=self.R0, RHO=self.rho,
                    FID=self.FID, maskf=self.maskf, Pb=Pb, Vbvel=Vbvel,
                    Volb=Volb, maskb=maskb, h=self.h, dim=self.dim, dt=dt,
                    inv_dt=inv_dt, kernel_density=self.sim.kernel_density,
                    kernel_gradient=self.sim.kernel_gradient,
                    halo=self.halo, interior=self.interior,
                )
            a_d, fb_d = force.apply(fields)
            A = A + a_d * self.maskf[None]
            if fb_d is not None:
                fb = fb_d if fb is None else fb + fb_d
        return A, (None if fb is None else self.np_fb_to_native(fb))

    # -- layout conversion ---------------------------------------------------

    def to_f(self, values, fill=0.0):
        """Per-particle fluid values [N] / [N, D] -> grid layout."""
        return dg.to_grid(self.sf, self.binf, values, fill)

    def unbin_f(self, grid, fallback):
        """Fluid grid [cap, C] / [D, cap, C] -> particles; particles not
        in the grid keep ``fallback``."""
        return self.unbin_f_multi([(grid, fallback)])[0]

    def unbin_b(self, grid, fallback):
        """Boundary twin of :meth:`unbin_f`."""
        return self.unbin_b_multi([(grid, fallback)])[0]

    def unbin_f_multi(self, items):
        """Unbin several fluid grids with ONE packed row gather.
        ``items``: [(grid, fallback)]."""
        return self._unbin_multi(self.sf, self.binf, items)

    def unbin_b_multi(self, items):
        """Boundary twin of :meth:`unbin_f_multi`."""
        return self._unbin_multi(self.sb, self.binb, items)

    def _unbin_multi(self, spec, binned, items):
        """On the slab path each particle is read from the one slab that
        owns it (``halo.merge_particles``); the others give zeros."""
        outs = dg.from_grid_multi(spec, binned, [g for g, _ in items])
        keep = binned.in_grid if self.halo is None else binned.in_interior
        res = []
        for out, (_g, fb) in zip(outs, items):
            sel = keep[:, None] if out.ndim == 2 else keep
            if self.halo is None:
                res.append(torch.where(sel, out, fb))
            else:
                res.append(self.halo.merge_particles(
                    torch.where(sel, out, 0.0), keep, fb))
        return res
