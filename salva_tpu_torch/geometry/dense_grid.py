"""Dense binned cell grid (the main-path subset), on torch tensors.

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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DenseGridSpec:
    """Static geometry of the binned grid (hashable)."""

    origin: Tuple[float, ...]
    dims: Tuple[int, ...]  # number of cells per axis (incl. ghost ring)
    cap: int  # max particles per cell
    cell_width: float

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
    - ``grid_src``: [cap, C] int32 particle index feeding each slot
      (N = empty).
    """

    slot_of: torch.Tensor
    in_grid: torch.Tensor
    mask: torch.Tensor
    overflow: torch.Tensor
    clamped: torch.Tensor
    grid_src: torch.Tensor


def _scatter_drop(size: int, fill, idx, values):
    """``full(size, fill).at[idx].set(values, mode="drop")``: indices
    outside ``[0, size)`` land in a spare slot that is cut off."""
    out = torch.as_tensor(fill, dtype=values.dtype, device=values.device)
    out = out.reshape(1).repeat(size + 1)
    idx = idx.long()
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    out[idx] = values
    return out[:size]


def cell_of(spec: DenseGridSpec, positions, origin=None):
    """Flat interior-clamped cell id of each position + clamp mask.

    ``origin`` overrides the spec's static origin with a tensor (the
    fluid-tracking window recomputes it from the live fluid extent every
    substep)."""
    dev = positions.device
    if origin is None:
        origin = torch.tensor(spec.origin, dtype=positions.dtype, device=dev)
    dims = torch.tensor(spec.dims, dtype=torch.int32, device=dev)
    c = torch.floor((positions - origin) / spec.cell_width).to(torch.int32)
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
                  spill_cols: int = 0) -> Binned:
    """Assign each alive particle a (cell, rank) slot (deterministic).

    ``drop_clamped=True`` excludes out-of-box particles from the grid
    instead of clamping them to the border ring."""
    if spill_cols:
        raise NotImplementedError(
            "dense_spill_columns (the dense+spill structure) is not ported"
        )
    dev = positions.device
    n = positions.shape[0]
    C = spec.num_cells
    cap = spec.cap
    cell, clamped_mask = cell_of(spec, positions, origin=origin)
    if drop_clamped:
        alive = alive & torch.logical_not(clamped_mask)
        clamped_mask = torch.zeros_like(clamped_mask)
    key = torch.where(alive, cell, C).to(torch.int32)
    order, rank_sorted, sk, is_first = _sorted_ranks(key)
    rank = torch.empty((n,), dtype=torch.int32, device=dev)
    rank[order.long()] = rank_sorted

    # Per-cell sorted-run starts/ends: slot (c, r) is fed by sorted
    # position starts[c] + r, so every channel bins through one row gather.
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
    valid = r[None, :] < torch.clamp(counts, max=cap)[:, None]  # [C, cap]
    src_sorted = torch.where(valid, starts[:, None] + r[None, :], n)
    order_ext = torch.cat(
        [order, torch.full((1,), n, dtype=torch.int32, device=dev)]
    )
    grid_src = order_ext[src_sorted.long()].T.contiguous()  # [cap, C]
    mask = valid.T.to(torch.float32).contiguous()

    fits = alive & (rank < cap)
    clamped = (alive & clamped_mask).sum(dtype=torch.int32)
    slot = torch.where(fits, cell * cap + rank, C * cap).to(torch.int32)
    overflow = (alive & (rank >= cap)).sum(dtype=torch.int32)
    return Binned(
        slot_of=slot,
        in_grid=fits,
        mask=mask,
        overflow=overflow,
        clamped=clamped,
        grid_src=grid_src,
    )


def to_grid(spec, binned, values, fill=0.0):
    """Bring per-particle values into grid layout by a row gather of the
    slot table: [N] -> [cap, C]; [N, D] -> [D, cap, C]."""
    if values.ndim == 2:
        return torch.stack(
            [to_grid(spec, binned, values[:, d], fill)
             for d in range(values.shape[1])]
        )
    ext = torch.cat(
        [values, torch.full((1,), fill, dtype=values.dtype,
                            device=values.device)]
    )
    return ext[binned.grid_src.long()]


def to_grid_multi(spec, binned, items):
    """Bring SEVERAL float32 per-particle arrays into grid layout with ONE
    packed row gather. ``items``: list of ``(values, fill)`` with values
    [N] or [N, D]; returns contiguous [cap, C'] / [D, cap, C'] grids."""
    src = binned.grid_src.long()
    chans = []
    layout = []
    for vals, _fill in items:
        if vals.ndim == 1:
            chans.append(vals)
            layout.append(1)
        else:
            for d in range(vals.shape[1]):
                chans.append(vals[:, d])
            layout.append(vals.shape[1])
    packed = torch.stack(chans, dim=-1)
    packed = torch.cat(
        [packed, torch.zeros((1, len(chans)), dtype=packed.dtype,
                             device=packed.device)]
    )
    g = packed[src]  # [cap, C', ch]
    empty = src >= packed.shape[0] - 1
    out = []
    col = 0
    for (vals, fill), d in zip(items, layout):
        comps = []
        for k in range(d):
            arr = g[..., col + k]
            if fill != 0.0:
                arr = torch.where(empty, fill, arr)
            comps.append(arr.contiguous())
        out.append(comps[0] if vals.ndim == 1 else torch.stack(comps))
        col += d
    return out


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
    grid_src: Optional[torch.Tensor] = None


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
    valid = r[None, :] < torch.clamp(counts, max=cap)[:, None]  # [A+1, cap]
    src_sorted = torch.where(valid, col_start[:, None] + r[None, :], n)
    order_ext = torch.cat(
        [order, torch.full((1,), n, dtype=torch.int32, device=dev)]
    )
    grid_src = order_ext[torch.clamp(src_sorted, max=n).long()].T.contiguous()
    mask = valid.T.to(torch.float32).contiguous()

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
        grid_src=grid_src,
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


def shift_j(spec: DenseGridSpec, arr, offset):
    """View of a [..., C] grid array where cell c sees cell c + offset."""
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
