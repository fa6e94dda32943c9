"""Shared machinery of the dense-layout pressure solvers (DFSPH, IISPH).

Port of ``salva_tpu.solver.dense_common``: binning, the per-substep
hoisted sums (density, gradient sums, gradient norms, boundary terms,
contact counts) and the per-iteration pair passes of the dense solvers.
Three cell indexings share all physics code, as in the JAX package:

- **grid** (the default): one column per window cell (``[cap, C]``;
  neighbor views are flat rolls of the cell axis), with either boundary
  binning: sparse (``dense_sparse_boundary=True``, the default:
  boundary-owner passes over occupied boundary cells only, and the
  sparse fluid-boundary hoist over boundary-adjacent fluid columns) or
  full-grid (``False``: the boundaries bin into the fluid grid's cells);
- **dense+spill** (``dense_spill_columns = E``; the grid with sparse
  boundary binning and the half stencil, one device): ranks past the cap
  of an over-cap cell land in E spill columns appended to the column
  axis (``[cap, C + E + 1]``, see ``dense_grid.Binned``); the main columns
  run the grid's pair passes, the spill interactions small gathered pair
  blocks (see the dense+spill section below);
- **compact** (``dense_compact=True``): one column per occupied cell plus
  a void column (``[cap, A + 1]``, ``dense_grid.bin_particles_active``);
  neighbor views gather columns through ``[A + 1, 3^dim]`` neighbor tables
  (``dense_grid.neighbor_table``).

The brute all-pairs tier (a ``brute_spec`` fluid spec) binds both
particle sets to a 1D cyclic grid by index and walks its cyclic offsets
0..C-1 instead of a cell stencil; every view is a roll and every layout
shuffle a gather through the binding's ``grid_src``.

On the grid, the four hot passes (``k_pass``, ``t_pass``, the ff hoist
and the fb hoist) go through ``ops.pair`` (hand kernels for CUDA tensors,
the plain half-stencil versions for CPU tensors), except where the
reference runs its full-stencil plain folds (``solver/full_folds.py``):
on the brute tier and on the compact layout, on every device (the
reference runs no Pallas kernel there, and no hand kernel runs here),
and on a grid with ``dense_half_stencil=False`` for CPU tensors (for
CUDA tensors the kernels, which walk the full stencil). The dense+spill
layout runs the ff passes through ``ops.pair`` on its main columns and
its own plain folds for the pairs that touch a spill slot, on every
device (the reference runs its half-stencil folds and those plain folds
there).
With frozen pair coefficients (``dense_frozen_pairs``) the hoists stay
as above, and ``k_pass`` / ``t_pass`` become multiply-reduces over the
coefficients s_ij = (dW/dr / r) m_j stored once a substep
(``sp_multi``; in ``dense_pair_dtype``, accumulated in float32). The
sorted binnings' layout shuffles (``to_grid`` / ``to_grid_multi``) go
through ``ops.binning`` on every layout but the brute tier's.
Everything else, the non-pressure forces included, is plain torch.

With a ``halo`` (``parallel/domain.py``, the slab path) the context
covers one x-slab of the grid and its two ghost layers
(``dense_grid.bin_particles_slab``), with the full-grid boundary binning
and neither the half stencil, the fitted window, the sparse fb table,
the compact layout nor the spill structure, as in the JAX package.
Unlike the JAX package's slab path, the hand kernels stay on for CUDA
tensors: they treat the cells beyond the local grid as empty where the
plain folds roll cyclically, which gives different values on the ghost
columns only, and every ghost column a solver or force reads is first
overwritten by a ``halo.exchange``.
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
        # The compact active-cell layout (off on the brute tier and on the
        # slab path, as in the JAX package).
        self.compact = (bool(sim.dense_compact) and not self.brute
                        and halo is None)
        # The full-stencil plain folds run the hot passes on the brute
        # tier and the compact layout (every device) and, for CPU tensors,
        # on a grid without the half stencil (a slab has none); ``ops.pair``
        # runs them on the other grids.
        self.use_full_folds = self.brute or self.compact or (
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
        # Dense+spill pair structure (config.dense_spill_columns): the
        # single-device grid only; the other layouts keep their own caps.
        self.spill_E = 0
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
        # on both grid boundary binnings (under the sparse one the forces
        # read the boundary arrays rematerialized onto the full grid, see
        # ``force_field_views``); a table gather on the compact layout.
        self.jfb = self.jff
        self.sparse_b = (bool(sim.dense_sparse_boundary) and not self.brute
                         and not self.compact and halo is None)
        if self.brute:
            # Identity bindings on the same cyclic columns: every view is
            # a roll (the fitted window and the sparse tables stay off).
            self.binf = dg.bin_particles_brute(spec_f, fluids.alive)
            self.binb = dg.bin_particles_brute(spec_b, boundaries.alive)
        elif self.compact:
            self._bin_compact(sim, spec_f, spec_b, fluids, boundaries)
        elif halo is None:
            self.spill_E = int(sim.dense_spill_columns or 0)
            self._Cmain = spec_f.num_cells
            self.binf = dg.bin_particles(
                spec_f, fluids.positions, fluids.alive,
                origin=self.origin_dyn, spill_cols=self.spill_E,
            )
            if self.spill_E:
                # The extended column axis [cap, C + E + 1] (spill columns
                # and the void column): every layout shuffle works through
                # the extended run table and slots; only the pair passes
                # decompose.
                self.sf = dg.ActiveSpec(
                    spec_f.num_cells + self.spill_E + 1, spec_f.cap)
            if not self.sparse_b:
                # Full-grid boundary binning: the boundary grid is the
                # fluid grid's [cap_b, C].
                self.binb = dg.bin_particles(
                    spec_b, boundaries.positions, boundaries.alive,
                    drop_clamped=self.drop_b, origin=self.origin_dyn,
                )
        if self.sparse_b:
            self._bin_boundaries_sparse(sim, spec_f, spec_b, boundaries)
        elif not self.compact:
            # The boundary grid has the fluid grid's columns, so every
            # fluid/boundary view is a roll.
            self.sb = spec_b
            self.jbf = self.jbb = self.jff
        if self.spill_E and not (self.sparse_b and sim.dense_half_stencil):
            raise ValueError(
                "dense_spill_columns requires the single-device full-grid "
                "half-stencil layout with sparse boundary binning (the "
                "world only enables it there)"
            )
        self.maskf = self.binf.mask
        self.live = self.maskf > 0
        # Per-cell live counts of the main columns [C] (ranks fill from 0
        # on the sorted binnings): what the hand kernels loop over instead
        # of the cap padding.
        self.counts = self._mslice(self.live).sum(dim=0, dtype=torch.int32)
        if self.spill_E:
            self._build_spill_tables()
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
        self._full_b = None  # the boundary arrays on the full grid
        if self.spill_E:
            # The main slice as the pair kernels take it (contiguous).
            self._Pm = self._mslice(self.P).contiguous()
            self._Mm = self._mslice(self.M).contiguous()
        self._compute_boundary_volumes()
        self._hoist()
        self.frozen = bool(sim.dense_frozen_pairs)
        if self.frozen:
            if self.spill_E:
                raise NotImplementedError(
                    "dense_frozen_pairs is incompatible with "
                    "dense_spill_columns"
                )
            self._freeze_pairs()

    def _bin_compact(self, sim, spec_f, spec_b, fluids, boundaries):
        """The compact layout: both particle sets bound to tables of their
        occupied cells (``A + 1`` columns, sized from the capacities by
        ``dense_active_ratio(_boundary)``, at least 256, at most the cell
        count), and the four neighbor-table views."""
        a_f = max(256, min(spec_f.num_cells,
                           int(fluids.capacity * sim.dense_active_ratio)))
        a_b = max(256, min(spec_b.num_cells,
                           int(boundaries.capacity
                               * sim.dense_active_ratio_boundary)))
        self.binf = dg.bin_particles_active(
            spec_f, a_f, fluids.positions, fluids.alive, cap=spec_f.cap,
            origin=self.origin_dyn,
        )
        self.binb = dg.bin_particles_active(
            spec_b, a_b, boundaries.positions, boundaries.alive,
            cap=spec_b.cap, drop_clamped=self.drop_b, origin=self.origin_dyn,
        )
        self.sf = dg.ActiveSpec(a_f + 1, spec_f.cap)
        self.sb = dg.ActiveSpec(a_b + 1, spec_b.cap)

        def view(owner, target):
            table = dg.neighbor_table(spec_f, owner.active_cells,
                                      target.cell_to_active).long()
            return lambda arr, o: arr[..., table[:, o]]

        self.jff = view(self.binf, self.binf)
        self.jfb = view(self.binf, self.binb)
        self.jbf = view(self.binb, self.binf)
        self.jbb = view(self.binb, self.binb)

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
        extra = 0
        if self.compact:
            extra = self.binf.active_overflow + self.binb.active_overflow
        elif self.sparse_b:
            extra = self.binb.active_overflow
        return (self.binf.overflow + self.binb.overflow + extra
                + self._fb_adj_overflow + self.spill_overflow)

    @property
    def spill_overflow(self):
        """Spill-structure table overflows (cells beyond the spill table,
        adjacency columns beyond its table, condensed spill-neighbor
        entries beyond K): each one means dropped contacts, so the world
        grows the tables when this fires."""
        if not self.spill_E:
            return 0
        return (self.binf.spill_col_overflow + self._spill_adj_overflow
                + self._spill_k_overflow)

    @property
    def spill_k_overflow(self):
        """The condensed K table's part of ``spill_overflow``: a larger
        spill table E cannot heal it, so the world widens
        ``dense_spill_k`` (or leaves the spill tier) instead."""
        return self._spill_k_overflow if self.spill_E else 0

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
        if self.spill_E:
            ff = self._hoist_ff_spill()
        elif self.use_full_folds:
            ff = full_folds.hoist_ff(
                self.spec_f, h, dim, kd, kg, self.P, self.M, self.maskf,
                need_s2=self.need_s2, jview=self.jff,
            )
        else:
            ff = pair.hoist_ff(
                self.spec_f, h, dim, kd, kg, self.P, self.M, self.counts,
                need_s2=self.need_s2,
            )
        rho_ff, Gf, sq_ff, s2_ff, cnt_ff = ff
        if self.brute or self.compact:
            fb = full_folds.hoist_fb(
                self.spec_f, h, dim, kd, kg, self.P, self.maskf, self.Pb,
                self.maskb, self.Volb, self.Vbvel, need_s2=self.need_s2,
                jview=self.jfb,
            )
        elif self.spill_E:
            fb = self._hoist_fb_spill()
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
        counts over the owned live slots, bin and spill overflow, clamps
        and the peak density ratio; on the slab path summed (the ratio:
        maxed) over the slabs."""
        own = self.live if self.interior is None else self.live & self.interior

        def i32(v):
            return torch.as_tensor(v, dtype=torch.int32, device=self.device)

        d = dict(
            ncontacts_ff=torch.where(own, self.cnt_ff, 0).sum(
                dtype=torch.int32),
            ncontacts_fb=torch.where(own, self.cnt_fb, 0).sum(
                dtype=torch.int32),
            neighbor_overflow=i32(self.bin_overflow),
            candidate_overflow=self.binf.clamped + self.binb.clamped,
            max_density_ratio=torch.clamp(
                torch.where(own, self.rho / self.R0, 0.0).amax(), min=0.0),
            spill_overflow=i32(self.spill_overflow),
            spill_k_overflow=i32(self.spill_k_overflow),
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

    def _fb_adjacency(self):
        """The boundary occupancy mask [C] dilated by the 3^dim flat
        shifts: the fluid columns within one cell of a boundary cell."""
        C = self.spec_f.num_cells
        occ = torch.zeros((C + 1,), dtype=torch.bool, device=self.device)
        occ[torch.where(self._b_is_void, C, self._b_active)] = True
        occ = occ[:C]
        adj = occ
        for s in dg.flat_shifts(self.spec_f):
            if s != 0:
                adj = adj | torch.roll(occ, s)
        return adj

    def _fb_topk(self, adj):
        """The adjacent columns of the mask ``adj`` compacted into the
        static [AFB] table via ``topk`` (keys ``n - column`` are unique, so
        the table order is ascending column, as ``lax.top_k`` gives it):
        (whether each entry is used, its column); overflow is counted in
        ``bin_overflow``, and the columns past the table are dropped
        exactly as the reference drops them."""
        n = adj.shape[0]
        AFB = self._fb_cols()
        iota = torch.arange(n, dtype=torch.int32, device=self.device)
        vals, af = torch.topk(torch.where(adj, n - iota, 0), AFB)
        self._fb_adj_overflow = torch.clamp(
            adj.sum(dtype=torch.int32) - AFB, min=0)
        return vals > 0, af

    def _fb_table(self):
        """The fluid columns of the sparse fb hoist, [AFB] int32 (unused
        entries = C; see :meth:`_fb_topk`)."""
        got, af = self._fb_topk(self._fb_adjacency())
        return torch.where(got, af, self.spec_f.num_cells).to(torch.int32)

    # -- dense+spill machinery (config.dense_spill_columns) ------------------
    #
    # The pair universe splits by (i-class, j-class) over main-grid and
    # spill slots; each combination is covered exactly once:
    #   main  <- main : the pair passes (``ops/pair.py``: the hand kernels
    #                   on the card) on the [..., :C] main slice, whose
    #                   columns are the grid's and whose live counts are
    #                   ``counts``;
    #   spill <- main : gathered blocks over the spill columns' 3^dim
    #                   main-neighbor columns;
    #   spill <- spill: gathered blocks over the spill columns' 3^dim
    #                   spill-neighbor columns (full stencil, so both
    #                   directions are covered);
    #   main  <- spill: gathered blocks over the main columns adjacent to
    #                   any spill cell (a compact table), each with a
    #                   condensed [K] table of its neighboring spill
    #                   columns (K = dense_spill_k).
    # Outputs assemble back onto the extended column axis with one
    # unique-column scatter. The three folds that read spill slots are
    # plain torch on every device, as the JAX package's are plain XLA.

    def _build_spill_tables(self):
        sim, spec = self.sim, self.spec_f
        dev = self.device
        E = self.spill_E
        C = spec.num_cells
        self.cap2 = min(8, spec.cap)
        self.CE = C + E + 1
        shifts_py = dg.flat_shifts(spec)
        shifts = torch.tensor(shifts_py, dtype=torch.int64, device=dev)
        sc = self.binf.spill_cells.long()  # [E], C = unused
        used = sc < C
        self._c2s_ext = torch.cat([
            self.binf.cell_to_spill.long(),
            torch.full((1,), E, dtype=torch.int64, device=dev)])  # [C + 1]

        # j-tables of each spill column's 3^dim neighborhood; out-of-range
        # cells (a border-ring cell can spill under an escape pile-up) and
        # unused entries route to the void column.
        nb = sc[:, None] + shifts[None, :]
        valid = used[:, None] & (nb >= 0) & (nb < C)
        self._sp_nb_main = torch.where(valid, nb, self.CE - 1)
        nb_cell = torch.clamp(torch.where(valid, nb, C), 0, C)
        self._sp_nb_spill = C + self._c2s_ext[nb_cell]  # [E, 3^dim]
        # The same neighborhoods as cell ids, for gathers into [_, C]-shaped
        # boundary grids (the i-side sentinel masks the unused ones).
        self._sp_nb_cell = torch.where(valid, nb, 0)

        # The adjacency table (main-i <- spill-j): occupied main columns
        # with a spill cell in their 3^dim neighborhood, compacted by topk.
        AADJ = int(min(sim.dense_spill_adj_columns or 8 * E, C))
        K = min(int(sim.dense_spill_k), len(shifts_py))
        occ = self.binf.cell_to_spill < E  # [C]
        adj = occ
        for s in shifts_py:
            if s != 0:
                adj = adj | torch.roll(occ, s)
        adj = adj & torch.any(self.maskf[:, :C] > 0, dim=0)
        iota = torch.arange(C, dtype=torch.int32, device=dev)
        vals, ac = torch.topk(torch.where(adj, C - iota, 0), AADJ)
        got = vals > 0
        self._spill_adj_overflow = torch.clamp(
            adj.sum(dtype=torch.int32) - AADJ, min=0)
        self._adj_cols = torch.where(got, ac, 0)
        self._adj_got = got
        self._adj_sc = torch.where(got, ac, self.CE)  # scatter target

        # The condensed spill-j table [AADJ, K]: the spill columns of each
        # adjacent column's neighborhood (entries beyond K are dropped and
        # counted).
        s_nb = self._c2s_ext[torch.clamp(
            self._adj_cols[:, None] + shifts[None, :], 0, C)]
        is_sp = (s_nb < E) & got[:, None]
        n_off = len(shifts_py)
        rank = n_off - torch.arange(n_off, dtype=torch.int64, device=dev)
        kv, ko = torch.topk(torch.where(is_sp, rank[None, :], 0), K, dim=1)
        picked = torch.gather(s_nb, 1, ko)
        self._adj_sp_nb = torch.where(kv > 0, C + picked, self.CE - 1)
        self._spill_k_overflow = torch.clamp(
            is_sp.sum(dim=1, dtype=torch.int32) - K, min=0).sum(
                dtype=torch.int32)

    def _mslice(self, arr):
        """The main-column slice of an extended array (identity without
        spill)."""
        return arr[..., :self._Cmain] if self.spill_E else arr

    def _sp_i(self, arr):
        """The spill-i slice: the live rows of the spill columns."""
        return arr[..., :self.cap2, self._Cmain:self._Cmain + self.spill_E]

    def _jv_sp_main(self, arr, o):
        return arr[..., self._sp_nb_main[:, o]]

    def _jv_sp_spill(self, arr, o):
        return arr[..., :self.cap2, :][..., self._sp_nb_spill[:, o]]

    def _jv_adj_spill(self, arr, k):
        return arr[..., :self.cap2, :][..., self._adj_sp_nb[:, k]]

    def _ff_spill_fold(self, j_arrays, body, init):
        """The spill-i fold of a fluid-fluid pass: main-j, then spill-j
        gathered blocks over the spill columns' neighborhoods."""
        acc = fold_pairs(
            self.offsets, self.h, self.dim, self._sp_i(self.P),
            self._sp_i(self.maskf), self.P, self.maskf, self._jv_sp_main,
            j_arrays, body, init,
        )
        return fold_pairs(
            self.offsets, self.h, self.dim, self._sp_i(self.P),
            self._sp_i(self.maskf), self.P, self.maskf, self._jv_sp_spill,
            j_arrays, body, acc,
        )

    def _ff_adj_fold(self, j_arrays, body, init):
        """The adjacent-main-i <- spill-j fold (condensed K-wide
        j-table)."""
        Pad = self.P[..., self._adj_cols]
        mad = torch.where(self._adj_got, self.maskf[..., self._adj_cols], 0.0)
        K = self._adj_sp_nb.shape[1]
        return fold_pairs(
            range(K), self.h, self.dim, Pad, mad, self.P, self.maskf,
            self._jv_adj_spill, j_arrays, body, init,
        )

    def _zeros_sp(self, lead=(), dtype=torch.float32):
        """Zeros of a spill-i block's shape, ``lead + (cap2, E)``."""
        return torch.zeros(lead + (self.cap2, self.spill_E), dtype=dtype,
                           device=self.device)

    def _zeros_adj(self, lead=(), dtype=torch.float32):
        """Zeros of an adjacent-main-i block's shape,
        ``lead + (cap, AADJ)``."""
        return torch.zeros(lead + (self.spec_f.cap, self._adj_cols.shape[0]),
                           dtype=dtype, device=self.device)

    def _assemble(self, main, spill, adj=None):
        """main [..., cap, C] + spill [..., cap2, E] + optional
        adj [..., cap, AADJ] -> extended [..., cap, CE]."""
        cap = self.spec_f.cap
        if self.cap2 < cap:
            spill = torch.cat([spill, torch.zeros(
                spill.shape[:-2] + (cap - self.cap2,) + spill.shape[-1:],
                dtype=spill.dtype, device=spill.device)], dim=-2)
        void = torch.zeros(main.shape[:-1] + (1,), dtype=main.dtype,
                           device=main.device)
        out = torch.cat([main, spill, void], dim=-1)
        if adj is not None:
            # Unused entries target the spare column CE, cut off.
            scat = torch.zeros(main.shape[:-1] + (self.CE + 1,),
                               dtype=main.dtype, device=main.device)
            scat[..., self._adj_sc] = adj
            out = out + scat[..., :self.CE]
        return out

    def _hoist_ff_spill(self):
        """The ff hoist on the spill layout: ``pair.hoist_ff`` on the main
        slice, the spill-i and the adjacent-main-i folds."""
        dim, h = self.dim, self.h
        kd, kg = self.sim.kernel_density, self.sim.kernel_gradient
        main = pair.hoist_ff(
            self.spec_f, h, dim, kd, kg, self._Pm, self._Mm, self.counts,
            need_s2=self.need_s2,
        )
        body = full_folds.ff_body(h, dim, kd, kg, self.need_s2)
        j_arr = {"m": self.M}
        init = [(z(), z((dim,)), z(), z(), z((), torch.int32))
                for z in (self._zeros_sp, self._zeros_adj)]
        sp = self._ff_spill_fold(j_arr, body, init[0])
        adj = self._ff_adj_fold(j_arr, body, init[1])
        return tuple(self._assemble(m, s_, a)
                     for m, s_, a in zip(main, sp, adj))

    def _hoist_fb_spill(self):
        """The fb hoist on the spill layout: the sparse table extended over
        the spill columns, or (no table) the full-roll fold on the main
        slice plus a gathered spill-i block over each spill column's
        3^dim boundary neighborhood."""
        dim, h = self.dim, self.h
        fb_body = pair._fb_body(h, dim, self.sim.kernel_density,
                                self.sim.kernel_gradient, self.need_s2)
        if self._fb_cols():
            return self._hoist_fb_sparse_spill(fb_body)
        pb, vbvel, volb, maskb = self._full_boundary()
        j_arr = {"vol": volb, "vb": vbvel}
        zm = torch.zeros_like(self._mslice(self.maskf))
        main = fold_pairs(
            self.offsets, h, dim, self._mslice(self.P),
            self._mslice(self.maskf), pb, maskb, self.jfb, j_arr, fb_body,
            (zm, torch.zeros_like(self._mslice(self.P)), zm, zm, zm,
             torch.zeros_like(zm, dtype=torch.int32)),
        )
        zs = self._zeros_sp()
        sp = fold_pairs(
            self.offsets, h, dim, self._sp_i(self.P), self._sp_i(self.maskf),
            pb, maskb, lambda arr, o: arr[..., self._sp_nb_cell[:, o]],
            j_arr, fb_body,
            (zs, self._zeros_sp((dim,)), zs, zs, zs,
             self._zeros_sp((), torch.int32)),
        )
        return tuple(self._assemble(m, s_) for m, s_ in zip(main, sp))

    def _hoist_fb_sparse_spill(self, fb_body):
        """``_hoist_fb_sparse`` of the reference under the spill structure:
        the adjacency extends over the spill columns (a spill column whose
        cell is boundary-adjacent enters the table with its extended
        column id, and reads its cell's boundary neighborhood), so spill
        particles keep their wall contacts."""
        C, E = self._Cmain, self.spill_E
        adj = self._fb_adjacency()
        sc = self.binf.spill_cells.long()
        adj_sp = torch.where(sc < C, adj[torch.clamp(sc, max=C - 1)], False)
        got, af = self._fb_topk(torch.cat([adj, adj_sp]))
        af_g = torch.where(got, af, 0)
        # The i side: gathered fluid columns (mask zeroed on unused slots).
        Pi = self.P[..., af_g]
        maski = torch.where(got[None, :], self.maskf[..., af_g], 0.0)
        # The j side: the boundary table columns of each entry's cell's
        # 3^dim neighbors (the void column for inactive cells).
        af_cell = torch.where(af_g < C, af_g,
                              sc[torch.clamp(af_g - C, 0, E - 1)])
        sh = torch.tensor(dg.flat_shifts(self.spec_f), dtype=torch.int64,
                          device=self.device)
        nfb = self.binb.cell_to_active.long()[
            torch.clamp(af_cell[:, None] + sh[None, :], 0, C)]
        z = torch.zeros_like(maski)
        rho, gb, sq, s2, sb, cnt = fold_pairs(
            self.offsets, self.h, self.dim, Pi, maski, self.Pb, self.maskb,
            lambda arr, o: arr[..., nfb[:, o]],
            {"vol": self.Volb, "vb": self.Vbvel}, fb_body,
            (z, torch.zeros_like(Pi), z, z, z,
             torch.zeros_like(maski, dtype=torch.int32)),
        )
        # Back onto the extended grid (unused entries target the spare
        # column CE, cut off).
        af_sc = torch.where(got, af, self.CE)
        packed = torch.cat([rho[None], gb, sq[None], s2[None], sb[None]])
        fullf = torch.zeros(packed.shape[:-1] + (self.CE + 1,),
                            dtype=packed.dtype, device=self.device)
        fullf[..., af_sc] = packed
        fulli = torch.zeros(cnt.shape[:-1] + (self.CE + 1,),
                            dtype=cnt.dtype, device=self.device)
        fulli[..., af_sc] = cnt
        fullf, fulli = fullf[..., :self.CE], fulli[..., :self.CE]
        dim = self.dim
        return (fullf[0], fullf[1:1 + dim], fullf[1 + dim], fullf[2 + dim],
                fullf[3 + dim], fulli)

    def _t_body(self):
        """The spill folds' ``t_pass`` body (mask-free: dead slots carry
        zero mass and far positions)."""
        kg_w, kg_dw = self.kg
        dim, h = self.dim, self.h

        def body(acc, dpos, r2, within, j):
            _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
            t = j["q"][0][None, :, :] * dpos[0]
            for d in range(1, dim):
                t = t + j["q"][d][None, :, :] * dpos[d]
            return acc + torch.sum(t * dwr * j["m"][None, :, :], dim=1)

        return body

    def _k_body(self):
        """The spill folds' ``k_pass`` body."""
        kg_w, kg_dw = self.kg
        dim, h = self.dim, self.h

        def body(acc, dpos, r2, within, j):
            _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
            coeff = j["mk"][None, :, :] * dwr
            return torch.stack([acc[d] + torch.sum(dpos[d] * coeff, dim=1)
                                for d in range(dim)])

        return body

    def _t_pass_spill(self, Q):
        main = pair.t_pass(
            self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
            self._Pm, self._Mm, self._mslice(Q).contiguous(), self.counts)
        j_arr = {"m": self.M, "q": Q}
        body = self._t_body()
        sp = self._ff_spill_fold(j_arr, body, self._zeros_sp())
        adj = self._ff_adj_fold(j_arr, body, self._zeros_adj())
        return self._assemble(main, sp, adj)

    def _k_pass_spill(self, K):
        main = pair.k_pass(
            self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
            self._Pm, self._Mm, self._mslice(K).contiguous(), self.counts)
        j_arr = {"mk": self.M * K}
        body = self._k_body()
        sp = self._ff_spill_fold(j_arr, body, self._zeros_sp((self.dim,)))
        adj = self._ff_adj_fold(j_arr, body, self._zeros_adj((self.dim,)))
        return self._assemble(main, sp, adj)

    # -- frozen pair coefficients (config.dense_frozen_pairs) ----------------

    def _freeze_pairs(self):
        """Materialize the iteration-invariant pair coefficient
        ``s_ij = (dW/dr / r) * m_j`` per neighbor view ([cap, cap, C]
        each, in ``dense_pair_dtype``). Contact gradients are frozen during
        a substep (`helper.rs:9-44`), so every per-iteration pair sum is
        linear in per-slot vectors through these coefficients, and the
        solver loops never evaluate the kernel polynomial again."""
        dtype = getattr(torch, self.sim.dense_pair_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"dense_pair_dtype {self.sim.dense_pair_dtype!r}"
                             " names no torch dtype")
        self.S = [
            (dwr * view(self.M)[None, :, :]).to(dtype)
            for _dpos, dwr, view in full_folds._hot_blocks(
                self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
                self.P, self.jff)
        ]

    def sp_multi(self, X):
        """[m, cap, C] channels -> [m, cap, C]: X_out[m, i] =
        sum_j s_ij X[m, j] over the frozen coefficients (float32
        accumulation)."""
        acc = torch.zeros((X.shape[0],) + tuple(self.maskf.shape),
                          dtype=torch.float32, device=self.device)
        for o, S_o in enumerate(self.S):
            xj = self.jff(X, o)
            acc = acc + torch.sum(S_o[None].float() * xj[:, None].float(),
                                  dim=2)
        return acc

    # -- per-iteration passes -----------------------------------------------

    def t_pass(self, Q):
        """T_i = sum_ff m_j (Q_j . grad_ij) for a per-slot vector Q."""
        if self.frozen:
            # grad_ij = s_ij (p_i - p_j):
            # T_i = sum_d p_i,d SP(Q_d)_i - SP(sum_d Q_d p_d)_i.
            ch = torch.cat([Q, torch.sum(Q * self.P, dim=0, keepdim=True)])
            out = self.sp_multi(ch)
            return torch.sum(self.P * out[:self.dim], dim=0) - out[self.dim]
        if self.spill_E:
            return self._t_pass_spill(Q)
        args = (self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
                self.P, self.M, Q)
        if self.use_full_folds:
            return full_folds.t_pass(*args, jview=self.jff)
        return pair.t_pass(*args, self.counts)

    def k_pass(self, K):
        """K_i = sum_ff k_j m_j grad_ij for a per-slot scalar k."""
        if self.frozen:
            # K_i,d = p_i,d SP(K)_i - SP(K p_d)_i.
            out = self.sp_multi(torch.cat([K[None], K[None] * self.P]))
            return self.P * out[0][None] - out[1:]
        if self.spill_E:
            return self._k_pass_spill(K)
        args = (self.spec_f, self.h, self.dim, self.sim.kernel_gradient,
                self.P, self.M, K)
        if self.use_full_folds:
            return full_folds.k_pass(*args, jview=self.jff)
        return pair.k_pass(*args, self.counts)

    def delta_density(self, Vp):
        """sum m_j (v_i'-v_j').grad + boundary term via hoisted sums:
        = v_i'.Gsum - T(v') - Sb."""
        t = self.t_pass(Vp)
        return torch.sum(Vp * self.Gsum, dim=0) - t - self.Sb

    def boundary_forces(self, coef):
        """One boundary-owner pass: F_b = Volb_b sum_i grad_ij coef_i
        (grad w.r.t. the fluid point; dpos in the fold is p_b - p_i).
        Under the spill structure a second fold adds the spill fluid
        slots' contributions (j = the spill columns of each boundary
        cell's 3^dim neighborhood)."""
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
        if self.spill_E:
            C = self._Cmain
            sh = torch.tensor(dg.flat_shifts(self.spec_f), dtype=torch.int64,
                              device=self.device)
            b_cell = torch.clamp(self._b_active, max=C)  # void -> C
            nbs = C + self._c2s_ext[torch.clamp(
                b_cell[:, None] + sh[None, :], 0, C)]  # [Ab+1, 3^dim]
            Fb = fold_pairs(
                self.offsets, h, dim, self.Pb, self.maskb, self.P,
                self.maskf,
                lambda arr, o: arr[..., :self.cap2, :][..., nbs[:, o]],
                {"coef": coef}, body, Fb,
            )
        return self.Volb[None] * Fb

    # -- force-facing views ---------------------------------------------------

    def _full_boundary(self):
        """(Pb, Vbvel, Volb, maskb) of the sparse boundary binning
        rematerialized onto the full fluid grid, built at the first call of
        a substep."""
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
        return self._full_b

    def force_field_views(self):
        """(jfb, jbf, Pb, Vbvel, Volb, maskb) as the non-pressure force
        passes (``forces_dense``) consume them.

        Under the sparse boundary binning the compact boundary arrays are
        rematerialized onto the full grid (only a pair force asks for
        them), so that the force passes run as plain roll-view blocks, as
        in the JAX package; the compact layout gives its table views."""
        if self.spill_E:
            # The generic force pair passes do not know the spill
            # decomposition; the world keeps the spill structure off for
            # worlds with dense pair forces (particle-wise forces, like the
            # elasticity, never come here).
            raise NotImplementedError(
                "dense pair forces are not supported with "
                "dense_spill_columns; the world falls back to the plain "
                "cap tier for such scenes"
            )
        if not self.sparse_b:
            return (self.jfb, self.jbf, self.Pb, self.Vbvel, self.Volb,
                    self.maskb)
        return (self.jff, self.jff) + self._full_boundary()

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

    def apply_forces(self, dense_forces, fluids, V, dt, inv_dt, A, es=None,
                     particle_wise=True):
        """The non-pressure stage of predict_advection: ``A`` plus each
        dense force's acceleration on the live slots, in order, and the
        summed boundary feedback of the forces in the native boundary
        layout (None when no force feeds back). ``V``: the velocities the
        forces read (DFSPH: after the divergence solve). A
        ``ParticleWiseForce`` (the elasticity) runs in particle layout on
        ``fluids`` and the elasticity state ``es``, and is binned into the
        grid; ``particle_wise=False`` skips it (the caller adds its
        precomputed acceleration). The pair forces' field views are built
        only when one runs."""
        from .forces_dense import DenseFields, ParticleWiseForce

        fields = None
        fb = None
        for force in dense_forces:
            if isinstance(force, ParticleWiseForce):
                if not particle_wise:
                    continue
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
