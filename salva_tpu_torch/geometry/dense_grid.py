"""Dense binned cell grid, on torch tensors.

Port of ``salva_tpu.geometry.dense_grid``. Particles are binned once per
substep into a dense ``[cap, C]`` slot layout (cell width = h, cells
flattened row-major, a one-cell ghost ring at each face kept empty by
clamping into the interior). Slot ``[r, c]`` holds cell ``c``'s rank-``r``
particle; ranks fill from 0 in the stable sort order of (cell, particle
index), so every slot assignment here is identical to the JAX package's.

Grid channels are component-major (``[D, cap, C]``) with the cell axis
last and contiguous, which is the layout the hand kernels of
``ops/pair.py`` read.

JAX scatters with ``mode="drop"`` have no torch counterpart: every such
scatter goes through :func:`_scatter_drop`, which routes out-of-range
indices to one extra slot that is cut off afterwards.

Two more layouts of the JAX package bind particles differently: the
dense+spill structure (:func:`bin_particles` with ``spill_cols``: ranks
past the cap of an over-cap cell in spill columns appended to the column
axis) and the compact layout (:func:`bin_particles_active`: one column
per occupied cell, neighbours through :func:`neighbor_table`). Both keep
the run table of the sorted binnings, so their layout shuffles expand
exactly as the grid's do.

The brute all-pairs tier (:func:`brute_spec`, :func:`bin_particles_brute`)
binds particles to a 1D cyclic "grid" by index alone; its layout
shuffles gather through the binding's ``grid_src`` table, as the JAX
package's do.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DenseGridSpec:
    """Static geometry of the binned grid (hashable)."""

    origin: Tuple[float, ...]
    dims: Tuple[int, ...]  # number of cells per axis (incl. ghost ring)
    cap: int  # max particles per cell
    cell_width: float
    # Unpadded x-extent for interior clamping: when the x-axis is padded
    # up to a slab-count multiple (``parallel.domain.pad_spec_for_devices``),
    # escaped particles must still clamp to the ORIGINAL border ring, or
    # the slab and single-device runs bin them into different cells.
    clamp_nx: int = None
    # All-pairs brute tier (:func:`brute_spec`): ``dims`` is a 1D CYCLIC
    # group of cells with no spatial meaning; offsets 0..C-1 of
    # :func:`shift_j` pair every cell with every cell once, so every
    # particle meets every other. Position binning is bypassed
    # (:func:`bin_particles_brute`).
    brute: bool = False

    def __post_init__(self):
        if any(d < 3 for d in self.dims):
            raise ValueError("grid dims must be >= 3 (ghost ring)")

    @property
    def dim(self) -> int:
        return len(self.dims)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.dims))

    def flat_shift(self, offset) -> int:
        """Flat-index delta of a cell offset (row-major)."""
        s = 0
        for d, off in zip(self.dims, offset):
            s = s * d + off
        return s

    def replace(self, **kw) -> "DenseGridSpec":
        return dataclasses.replace(self, **kw)


def spec_for_aabb(mins, maxs, h: float, cap: int, margin_cells: int = 2
                  ) -> DenseGridSpec:
    """Spec covering [mins, maxs] with >= ``margin_cells`` ghost/margin
    cells on every face (at least one must stay empty; clamping keeps it
    so)."""
    mins = np.asarray(mins, np.float64)
    maxs = np.asarray(maxs, np.float64)
    margin = max(margin_cells, 1)
    origin = mins - margin * h
    dims = np.ceil((maxs - origin) / h).astype(int) + margin
    dims = np.maximum(dims, 3)
    return DenseGridSpec(
        origin=tuple(float(v) for v in origin),
        dims=tuple(int(v) for v in dims),
        cap=cap,
        cell_width=float(h),
    )


# Position fill for empty slots: far outside any domain, so every pair
# term involving an empty slot vanishes through the kernel's compact
# support (dW = W = 0 beyond h).
POS_SENTINEL = 1.0e6


class Binned(NamedTuple):
    """A particle set bound to grid slots (see ``salva_tpu``'s ``Binned``).

    - ``slot_of``: [N] int32 flat slot (cell * cap + rank); particles that
      do not fit point at the out-of-bounds slot ``C * cap``;
    - ``in_grid``: [N] bool;
    - ``mask``: [cap, C] f32 slot occupancy;
    - ``overflow``: [] int32 particles dropped by full cells;
    - ``clamped``: [] int32 particles clamped into the interior box;
    - the run table every layout shuffle of a sorted binning into the
      grid reads (:func:`to_grid`, :func:`to_grid_multi`,
      ``ops/binning.py``): ``order`` [N] int32, the stable sort of the
      particles by cell, and per column ``start`` [C] (first sorted index;
      0 for an empty cell) and ``count`` [C] (particles in the cell, also
      past ``cap``), both int32; None for the brute tier's identity
      binding, which has no sorted order;
    - ``grid_src``: [cap, C] int64 particle index feeding each slot
      (N = empty), the brute tier's binding only: its layout shuffles
      gather through it (None for the sorted binnings).

    With ``spill_cols = E > 0`` (the dense+spill pair structure,
    ``config.dense_spill_columns``) the column axis is EXTENDED to
    ``C + E + 1``: columns ``[C, C+E)`` are spill columns, one per cell
    whose occupancy exceeds ``cap``, holding ranks
    ``cap..cap+spill_rows-1`` in their rows ``0..spill_rows-1``, and column
    ``C+E`` is a void column (sentinel positions, zero masks) that
    absorbs every "no spill neighbor" gather. ``mask``, ``slot_of`` and
    the run table then cover the extended axis (a spill column's run
    starts ``cap`` past its cell's, and counts at most ``spill_rows``), so
    every layout shuffle works unchanged; only the pair passes know the
    structure (``solver/dense_common.DenseCtx``). Extra fields:

    - ``spill_cells``: [E] int32 cell of each spill column (unused: C), in
      ascending cell order;
    - ``cell_to_spill``: [C] int32 inverse map (no spill column: E);
    - ``spill_col_overflow``: [] int32 over-cap cells beyond E (their
      over-rank particles are dropped and counted in ``overflow``).
    """

    slot_of: torch.Tensor
    in_grid: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor
    clamped: torch.Tensor
    order: torch.Tensor = None
    start: torch.Tensor = None
    count: torch.Tensor = None
    grid_src: torch.Tensor = None
    spill_cells: torch.Tensor = None
    cell_to_spill: torch.Tensor = None
    spill_col_overflow: torch.Tensor = None


def _scatter_drop(size: int, fill, idx, values):
    """``full(size, fill).at[idx].set(values, mode="drop")``: indices
    outside ``[0, size)`` land in a spare slot that is cut off."""
    out = torch.as_tensor(fill, dtype=values.dtype, device=values.device)
    out = out.reshape(1).repeat(size + 1)
    idx = idx.long()
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    out[idx] = values
    return out[:size]


def inv_width(width: float) -> float:
    """The float32 reciprocal of a cell width. The JAX package divides by
    a constant width inside jit, and XLA compiles that division as a
    multiplication by the constant's float32 reciprocal; a particle on a
    cell edge lands in the cell that rounding gives (a true division puts
    some of them one cell lower)."""
    return float(np.float32(1.0) / np.float32(width))


def cell_of(spec: DenseGridSpec, positions, origin=None):
    """Flat interior-clamped cell id of each position + clamp mask.

    ``origin`` overrides the spec's static origin with a tensor (the
    fluid-tracking window recomputes it from the live fluid extent every
    substep)."""
    dev = positions.device
    if origin is None:
        origin = torch.tensor(spec.origin, dtype=positions.dtype, device=dev)
    dims = torch.tensor(spec.dims, dtype=torch.int32, device=dev)
    c = torch.floor((positions - origin) * inv_width(spec.cell_width)).to(
        torch.int32)
    clamped_mask = torch.any((c < 1) | (c >= dims - 1), dim=-1)
    c = torch.minimum(torch.maximum(c, torch.ones_like(dims)), dims - 2)
    flat = c[..., 0]
    for axis in range(1, spec.dim):
        flat = flat * spec.dims[axis] + c[..., axis]
    return flat, clamped_mask


def _sorted_ranks(key):
    """(order, rank_sorted, sorted_key, is_first): stable sort order of
    ``key`` plus each element's rank within its run of equal keys."""
    n = key.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=key.device)
    sk, order = torch.sort(key, stable=True)
    is_first = torch.ones((n,), dtype=torch.bool, device=key.device)
    is_first[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(is_first, iota, 0), dim=0).values
    return order.to(torch.int32), iota - first, sk, is_first


def bin_particles(spec: DenseGridSpec, positions, alive,
                  drop_clamped: bool = False, origin=None,
                  spill_cols: int = 0, spill_rows: int = 8) -> Binned:
    """Assign each alive particle a (cell, rank) slot (deterministic).

    ``drop_clamped=True`` excludes out-of-box particles from the grid
    instead of clamping them to the border ring. ``spill_cols = E > 0``
    enables the dense+spill structure (see :class:`Binned`): ranks
    ``cap..cap+spill_rows-1`` of over-cap cells land in spill columns
    instead of being dropped."""
    C = spec.num_cells
    cap = spec.cap
    cell, clamped_mask = cell_of(spec, positions, origin=origin)
    if drop_clamped:
        alive = alive & torch.logical_not(clamped_mask)
        clamped_mask = torch.zeros_like(clamped_mask)
    key = torch.where(alive, cell, C).to(torch.int32)
    order, rank, starts, counts, mask = _run_table(key, C, cap)
    fits = alive & (rank < cap)
    clamped = (alive & clamped_mask).sum(dtype=torch.int32)
    if spill_cols:
        return _bin_spill(cell, alive, rank, fits, clamped, order, starts,
                          counts, mask, C, cap, int(spill_cols),
                          min(int(spill_rows), cap))
    slot = torch.where(fits, cell * cap + rank, C * cap).to(torch.int32)
    overflow = (alive & (rank >= cap)).sum(dtype=torch.int32)
    return Binned(
        slot_of=slot,
        in_grid=fits,
        mask=mask,
        overflow=overflow,
        clamped=clamped,
        order=order,
        start=starts,
        count=counts,
    )


def _bin_spill(cell, alive, rank, fits, clamped, order, starts, counts, mask,
               C: int, cap: int, E: int, cap2: int) -> Binned:
    """The spill columns of :func:`bin_particles` (``E`` columns of
    ``cap2`` rows) and the extended slots and run table."""
    dev = cell.device
    # Spill columns in ascending cell order: a cumsum of the over-cap
    # occupancy mask.
    over_cell = counts > cap
    sidx = torch.cumsum(over_cell.to(torch.int32), 0,
                        dtype=torch.int32) - 1
    in_table = over_cell & (sidx < E)
    iota_c = torch.arange(C, dtype=torch.int32, device=dev)
    spill_cells = _scatter_drop(E, C, torch.where(in_table, sidx, E), iota_c)
    cell_to_spill = torch.where(in_table, sidx, E).to(torch.int32)
    spill_col_overflow = (over_cell & (sidx >= E)).sum(dtype=torch.int32)

    # The spill columns' runs: cap past their cells' runs, at most cap2
    # rows; the void column is empty.
    used = spill_cells < C
    sc_g = torch.clamp(spill_cells, max=C - 1).long()
    s_counts = torch.where(used, torch.clamp(counts[sc_g] - cap, max=cap2), 0)
    s_starts = torch.where(used, starts[sc_g] + cap, 0)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    start_ext = torch.cat([starts, s_starts.to(torch.int32), zero])
    count_ext = torch.cat([counts, s_counts.to(torch.int32), zero])
    r = torch.arange(cap, dtype=torch.int32, device=dev)
    mask_s = (r[:, None] < s_counts[None, :]).to(torch.float32)  # [cap, E]
    mask = torch.cat([mask, mask_s,
                      torch.zeros((cap, 1), dtype=torch.float32,
                                  device=dev)], dim=1)

    # Extended slot ids (column * cap + row over C + E + 1 columns).
    sidx_p = cell_to_spill[torch.clamp(cell, max=C - 1).long()]
    in_spill = alive & (rank >= cap) & (rank < cap + cap2) & (sidx_p < E)
    oob = (C + E + 1) * cap
    slot = torch.where(
        fits, cell * cap + rank,
        torch.where(in_spill, (C + sidx_p) * cap + (rank - cap), oob),
    ).to(torch.int32)
    fits = fits | in_spill
    return Binned(
        slot_of=slot,
        in_grid=fits,
        mask=mask,
        overflow=(alive & torch.logical_not(fits)).sum(dtype=torch.int32),
        clamped=clamped,
        order=order,
        start=start_ext,
        count=count_ext,
        spill_cells=spill_cells,
        cell_to_spill=cell_to_spill,
        spill_col_overflow=spill_col_overflow,
    )


def _run_table(key, C: int, cap: int):
    """The sorted binning of int32 cell keys in ``[0, C]`` (``C``: not
    binned): (order [N], each particle's rank in its cell [N], per column
    ``start`` and ``count`` [C] (the run table of ``ops/binning.expand``;
    start 0 for an empty cell, counts past ``cap`` kept), the slot
    occupancy mask [cap, C])."""
    n = key.shape[0]
    dev = key.device
    order, rank_sorted, sk, is_first = _sorted_ranks(key)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[order.long()] = rank_sorted
    # Per-cell sorted-run starts/ends: slot (c, r) is fed by sorted
    # position starts[c] + r.
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    live_sorted = sk < C
    first_live = is_first & live_sorted
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = sk[1:] != sk[:-1]
    is_last = live_sorted & last
    starts = _scatter_drop(C + 1, 0, torch.where(first_live, sk, C + 1),
                           iota)[:C]
    ends = _scatter_drop(C + 1, 0, torch.where(is_last, sk, C + 1),
                         iota + 1)[:C]
    counts = ends - starts
    r = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = r[:, None] < torch.clamp(counts, max=cap)[None, :]  # [cap, C]
    return order, rank, starts, counts, valid.to(torch.float32)


class SlabBinned(NamedTuple):
    """A particle set bound to slots of one slab of the grid and its two
    ghost x-layers (``salva_tpu``'s ``SlabBinned``; the slab path of
    ``parallel/domain.py``).

    The slab owning x-layers ``[x0, x0 + nxl)`` bins every particle whose
    (global, interior-clamped) cell lies in the extended slab
    ``[x0 - 1, x0 + nxl + 1)``; the two extra layers are the ghost layers,
    whose content mirrors the neighbouring slabs' border cells. Ranks
    within a cell follow global particle order, so per-cell pair sums see
    the single-device :func:`bin_particles` slots.

    - ``slot_of`` / ``in_grid`` / ``mask``: as in :class:`Binned`, over
      the local ``C_local = (nxl + 2) * prod(dims[1:])`` cells;
    - ``in_interior``: [N] bool, binned into a layer this slab owns (each
      alive in-grid particle is interior on exactly one slab);
    - ``overflow`` / ``clamped``: counted over interior cells only, so
      their sum over the slabs is the global count;
    - ``order`` / ``start`` / ``count``: the run table, as in
      :class:`Binned`, over the local columns.
    """

    slot_of: torch.Tensor
    in_grid: torch.Tensor
    in_interior: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor
    clamped: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


def bin_particles_slab(spec: DenseGridSpec, nxl: int, x0: int, positions,
                       alive) -> SlabBinned:
    """Bin particles into one slab's extended x-range (see
    :class:`SlabBinned`); ``x0`` = rank * ``nxl``. Cells are found as
    :func:`cell_of` finds them (a multiplication by the float32 reciprocal
    of the width), clamped into the interior of the unpadded grid
    (``spec.clamp_nx``)."""
    dev = positions.device
    cap = spec.cap
    origin = torch.tensor(spec.origin, dtype=positions.dtype, device=dev)
    hi = np.asarray(spec.dims, np.int32) - 2
    if spec.clamp_nx is not None:
        hi[0] = spec.clamp_nx - 2
    hi = torch.from_numpy(hi).to(dev)
    c = torch.floor((positions - origin) * inv_width(spec.cell_width)).to(
        torch.int32)
    clamped_mask = torch.any((c < 1) | (c > hi), dim=-1)
    c = torch.minimum(torch.maximum(c, torch.ones_like(hi)), hi)
    rest = c[..., 1]
    for axis in range(2, spec.dim):
        rest = rest * spec.dims[axis] + c[..., axis]
    nyz = int(np.prod(spec.dims[1:]))
    lx = c[..., 0] - (int(x0) - 1)
    in_slab = alive & (lx >= 0) & (lx < nxl + 2)
    interior = in_slab & (lx >= 1) & (lx < nxl + 1)
    c_local = (nxl + 2) * nyz
    cell = torch.where(in_slab, lx * nyz + rest, c_local).to(torch.int32)
    order, rank, starts, counts, mask = _run_table(cell, c_local, cap)
    fits = in_slab & (rank < cap)
    slot = torch.where(fits, cell * cap + rank, c_local * cap).to(
        torch.int32)
    return SlabBinned(
        slot_of=slot,
        in_grid=fits,
        in_interior=interior & (rank < cap),
        mask=mask,
        overflow=(interior & (rank >= cap)).sum(dtype=torch.int32),
        clamped=(interior & clamped_mask).sum(dtype=torch.int32),
        order=order,
        start=starts,
        count=counts,
    )


def brute_spec(capacity: int, cells: int = 32) -> DenseGridSpec:
    """All-pairs "grid" of the brute small-N tier: ``cells`` cyclic cells
    x ``ceil(capacity / cells)`` slots (``salva_tpu``'s ``brute_spec``).
    One masked all-pairs block, as a 1D cyclic grid (offset k pairs cell
    c with cell c + k mod C), is exact and shuffle-free and cannot
    overflow; it reuses the dense roll machinery with capacity^2 pair
    slots in all."""
    cells = int(max(3, min(cells, capacity)))
    cap = -(-int(capacity) // cells)
    return DenseGridSpec(
        origin=(0.0,), dims=(cells,), cap=cap, cell_width=1.0, brute=True
    )


def bin_particles_brute(spec: DenseGridSpec, alive) -> Binned:
    """Identity binding of the brute tier: particle ``i`` feeds slot
    (rank ``i // C``, cell ``i % C``), with no sort and no scatter.
    Alive particles beyond ``C * cap`` (a mis-sized spec; the world sizes
    ``cap`` from the capacity) surface as ``overflow``."""
    C, cap = spec.dims[0], spec.cap
    n = alive.shape[0]
    dev = alive.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    cell = idx % C
    rank = idx // C
    fits = alive & (rank < cap)
    slot = torch.where(fits, cell * cap + rank, C * cap).to(torch.int32)
    # grid_src[r, c] = particle r * C + c, or n for an empty slot.
    src = (torch.arange(cap, dtype=torch.int64, device=dev)[:, None] * C
           + torch.arange(C, dtype=torch.int64, device=dev)[None, :])
    src = torch.clamp(src, max=n)
    alive_ext = torch.cat([alive, torch.zeros(1, dtype=torch.bool,
                                              device=dev)])
    src = torch.where(alive_ext[src], src, n)
    return Binned(
        slot_of=slot,
        in_grid=fits,
        mask=(src < n).to(torch.float32),
        overflow=(alive & (rank >= cap)).sum(dtype=torch.int32),
        clamped=torch.zeros((), dtype=torch.int32, device=dev),
        grid_src=src,
    )


def _gather_grid(src, values, fill):
    """``cat([values, fill])[src]`` per component: [N] -> [cap, C],
    [N, D] -> [D, cap, C] (the JAX ``to_grid`` through ``grid_src``)."""
    if values.ndim == 2:
        return torch.stack([_gather_grid(src, values[:, d], fill)
                            for d in range(values.shape[1])])
    ext = torch.cat([values, torch.full((1,), fill, dtype=values.dtype,
                                        device=values.device)])
    return ext[src]


def to_grid(spec, binned, values, fill=0.0):
    """Bring per-particle values into grid layout: [N] -> [cap, C];
    [N, D] -> [D, cap, C]. On a sorted binning one call of its expansion
    (``ops.binning.expand``): integer and bool values (ids, interaction
    bitmasks) expand exactly as two float32 channels, their low 16 bits
    and the rest. On the brute tier's identity binding a gather through
    its ``grid_src`` (there is no sorted order to expand)."""
    from ..ops import binning

    src = getattr(binned, "grid_src", None)
    if src is not None:
        return _gather_grid(src, values, fill)
    if values.dtype == torch.float32:
        return binning.expand(binned, [(values, fill)])[0]
    v, f = values.long(), int(fill)
    lo, hi = binning.expand(binned, [((v & 0xFFFF).float(), f & 0xFFFF),
                                     ((v >> 16).float(), f >> 16)])
    return ((hi.long() << 16) | lo.long()).to(values.dtype)


def to_grid_multi(spec, binned, items):
    """Bring SEVERAL float32 per-particle arrays into grid layout with one
    call of the binning's expansion (``ops.binning.expand``: the kernel for
    CUDA tensors, one launch for every channel; its plain version for CPU
    tensors). ``items``: list of ``(values, fill)`` with values [N] or
    [N, D]; returns contiguous [cap, C'] / [D, cap, C'] grids. The brute
    tier's identity binding gathers each item through ``grid_src``
    (:func:`to_grid`)."""
    from ..ops import binning

    src = getattr(binned, "grid_src", None)
    if src is not None:
        return [_gather_grid(src, v, f) for v, f in items]
    return binning.expand(binned, items)


def to_grid_multi2(spec_a, binned_a, items_a, spec_b, binned_b, items_b):
    """:func:`to_grid_multi` of two binnings (a substep's fluid and
    boundary binnings) in one call of ``ops.binning.expand_many``: one
    kernel launch for both on CUDA tensors. A brute-tier binding gathers
    its items through ``grid_src`` instead (it has no sorted order), and
    the other binning then expands alone. Returns (grids_a, grids_b)."""
    from ..ops import binning

    if (getattr(binned_a, "grid_src", None) is not None
            or getattr(binned_b, "grid_src", None) is not None):
        return (to_grid_multi(spec_a, binned_a, items_a),
                to_grid_multi(spec_b, binned_b, items_b))
    return tuple(binning.expand_many([(binned_a, items_a),
                                      (binned_b, items_b)]))


def from_grid_multi(spec, binned, grids):
    """Gather SEVERAL grid arrays back to particle layout with ONE packed
    row gather. ``grids``: list of [cap, C] or [D, cap, C] arrays. Returns
    a list of [N] / [N, D] arrays (invalid rows = 0)."""
    chans = []
    layout = []
    for g in grids:
        if g.ndim == 2:
            chans.append(g)
            layout.append(1)
        else:
            for d in range(g.shape[0]):
                chans.append(g[d])
            layout.append(g.shape[0])
    ch = len(chans)
    num_slots = chans[0].shape[0] * chans[0].shape[1]
    rows = torch.stack([g.T.reshape(-1) for g in chans], dim=-1)
    rows = torch.cat(
        [rows, torch.zeros((1, ch), dtype=rows.dtype, device=rows.device)]
    )
    idx = torch.clamp(binned.slot_of.long(), max=num_slots)
    picked = rows[idx]  # [N, ch]
    out = []
    col = 0
    for d in layout:
        out.append(picked[:, col] if d == 1 else picked[:, col:col + d])
        col += d
    return out


def from_grid(spec, binned, grid_values, default=0.0):
    """Gather per-particle values back: [cap, C] -> [N];
    [D, cap, C] -> [N, D]."""
    if grid_values.ndim == 2:
        flat = grid_values.T.reshape(-1)
        idx = torch.clamp(binned.slot_of.long(), max=flat.shape[0] - 1)
        return torch.where(binned.in_grid, flat[idx], default)
    return torch.stack(
        [from_grid(spec, binned, grid_values[d], default)
         for d in range(grid_values.shape[0])],
        dim=-1,
    )


class ActiveBinned(NamedTuple):
    """A particle set bound to slots of the occupied-cells-only table:
    ``A + 1`` columns, one per active (occupied) cell plus a trailing
    void column. Fields as ``salva_tpu``'s ``ActiveBinned``:
    ``active_cells`` [A+1] (void/unused = C), ``cell_to_active`` [C+1]
    (inactive -> A), ``active_overflow`` (occupied cells beyond A)."""

    slot_of: torch.Tensor
    in_grid: torch.Tensor
    mask: torch.Tensor
    active_cells: torch.Tensor
    cell_to_active: torch.Tensor
    overflow: torch.Tensor
    clamped: torch.Tensor
    active_overflow: torch.Tensor
    # The run table, as ``Binned``'s: ``order`` [N]; ``start`` / ``count``
    # [A+1] per column (the void column: 0, 0).
    order: torch.Tensor
    start: torch.Tensor
    count: torch.Tensor


class ActiveSpec(NamedTuple):
    """Shape shim so :func:`to_grid` / :func:`from_grid` work on the
    compact [cap, A+1] layout."""

    num_cells: int  # = A + 1 (including the void column)
    cap: int


def bin_particles_active(spec: DenseGridSpec, max_active: int, positions,
                         alive, cap: int = None,
                         drop_clamped: bool = False, origin=None):
    """Compact binning: assign (active cell, rank) slots over occupied
    cells only. Deterministic like :func:`bin_particles`."""
    dev = positions.device
    cap = spec.cap if cap is None else cap
    n = positions.shape[0]
    C = spec.num_cells
    A = max_active
    cell, clamped_mask = cell_of(spec, positions, origin=origin)
    if drop_clamped:
        alive = alive & torch.logical_not(clamped_mask)
        clamped_mask = torch.zeros_like(clamped_mask)
    key = torch.where(alive, cell, C).to(torch.int32)
    order, rank_sorted, sk, is_first = _sorted_ranks(key)
    live_sorted = sk < C
    is_first = is_first & live_sorted
    act_sorted = torch.cumsum(is_first.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    n_live = live_sorted.sum(dtype=torch.int32)
    iota = torch.arange(n, dtype=torch.int32, device=dev)

    # Active-cell table [A+1], void/unused = C.
    tgt = torch.where(is_first & (act_sorted < A), act_sorted, A + 1)
    active_cells = _scatter_drop(A + 1, C, tgt, sk)
    cell_to_active = torch.full((C + 1,), A, dtype=torch.int32, device=dev)
    cell_to_active[active_cells[:A].long()] = torch.arange(
        A, dtype=torch.int32, device=dev
    )
    cell_to_active[C] = A

    # Per-active-cell run starts in sorted order (starts[A] caps the last
    # kept cell's run so counts never bleed across dropped cells).
    tgt_s = torch.where(is_first & (act_sorted <= A), act_sorted, A + 1)
    starts = _scatter_drop(A + 1, n_live, tgt_s, iota)
    counts = torch.zeros((A + 1,), dtype=torch.int32, device=dev)
    counts[:A] = starts[1:] - starts[:-1]
    r = torch.arange(cap, dtype=torch.int32, device=dev)
    col_start = torch.zeros((A + 1,), dtype=torch.int32, device=dev)
    col_start[:A] = starts[:A]
    valid = r[:, None] < torch.clamp(counts, max=cap)[None, :]  # [cap, A+1]
    mask = valid.to(torch.float32)

    fits_sorted = (
        live_sorted & (rank_sorted < cap) & (act_sorted >= 0)
        & (act_sorted < A)
    )
    oob = (A + 1) * cap
    slot_sorted = torch.where(
        fits_sorted, act_sorted * cap + rank_sorted, oob
    ).to(torch.int32)
    slot = torch.empty((n,), dtype=torch.int32, device=dev)
    slot[order.long()] = slot_sorted
    fits = slot < oob
    overflow = alive.sum(dtype=torch.int32) - fits_sorted.sum(
        dtype=torch.int32
    )
    clamped = (alive & clamped_mask).sum(dtype=torch.int32)
    active_overflow = (is_first & (act_sorted >= A)).sum(dtype=torch.int32)
    return ActiveBinned(
        slot_of=slot,
        in_grid=fits,
        mask=mask,
        active_cells=active_cells,
        cell_to_active=cell_to_active,
        overflow=overflow,
        clamped=clamped,
        active_overflow=active_overflow,
        order=order,
        start=col_start,
        count=counts,
    )


def flat_shifts(spec: DenseGridSpec):
    """Flat-index deltas of the 3^dim neighbor offsets, in
    :func:`neighbor_offsets` order."""
    return [spec.flat_shift(off) for off in neighbor_offsets(spec.dim)]


def neighbor_table(spec: DenseGridSpec, owner_cells, cell_to_active_target):
    """[Ao+1, S] active indices of each owner cell's 3^dim neighbors in
    the target set (void / inactive -> the target's void column)."""
    shifts = torch.tensor(flat_shifts(spec), dtype=torch.int32,
                          device=owner_cells.device)
    nc = owner_cells[:, None] + shifts[None, :]
    # Real owner cells are interior (all neighbors in range); the void
    # row (= C) clips back into [0, C] and is masked by its sentinel
    # positions anyway.
    nc = torch.clamp(nc, 0, spec.num_cells)
    return cell_to_active_target[nc.long()]


def stencil_offsets(spec: DenseGridSpec):
    """The cell offsets a full-stencil fold walks: the 3^dim neighbor
    offsets of a grid, or 0..C-1 of the brute tier's cyclic group (each
    ordered cell pair once)."""
    if spec.brute:
        return [(k,) for k in range(spec.dims[0])]
    return neighbor_offsets(spec.dim)


def shift_j(spec: DenseGridSpec, arr, offset):
    """View of a [..., C] grid array where cell c sees cell c + offset
    (a flat roll; on the brute tier's 1D cyclic grid, offset (k,) pairs
    cell c with cell c + k mod C)."""
    s = spec.flat_shift(offset)
    if s == 0:
        return arr
    return torch.roll(arr, -s, dims=-1)


def neighbor_offsets(dim: int):
    if dim == 2:
        return [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    return [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]
