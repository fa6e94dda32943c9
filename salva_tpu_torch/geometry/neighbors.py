"""Fixed-capacity neighbour lists from sorted cell ranges.

Port of ``salva_tpu.geometry.neighbors`` (the reference's neighbour
search, ``src/geometry/contacts.rs:154-400``): each query particle
gathers up to ``K`` neighbour indices into a static ``[N, K]`` table:

1. for each query point, compute the Morton keys of its 3^dim neighbour
   cells and binary-search their ranges in the sorted grid;
2. enumerate up to ``C = max_candidates`` candidate slots across those
   ranges (a ragged gather driven by a per-row cumulative sum);
3. filter by the exact distance test ``|p_i - p_j|^2 <= h^2``
   (``contacts.rs:285,322,366``), aliveness and interaction groups
   (``interaction_groups.rs:64-69``);
4. stably compact the survivors to the front and truncate to ``K``.

Candidates are enumerated in (cell offset, sorted position) order and the
compaction is stable, so the table — its invalid slots included — is the
JAX package's, index for index. Overflow of either capacity is counted.

Query rows run in blocks of ``query_chunk`` (a host loop in place of
``lax.map``) to bound the ``[B, C]`` transients. The JAX package pads the
rows to a multiple of ``query_chunk`` with dead rows at the origin, and
counts their candidate-window truncation in ``cand_overflow``; the port
reproduces that count from one such row instead of evaluating them all.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .grid import SpatialGrid, morton_key, neighbor_cell_offsets, search_cells


class GroupInfo(NamedTuple):
    """Interaction-group data of a particle set.

    ``memberships`` / ``filter``: u32 bitmasks held as int64
    (`interaction_groups.rs:9-60`); ``model``: int32 object id (which
    fluid / boundary a particle belongs to)."""

    memberships: torch.Tensor
    filter: torch.Tensor
    model: torch.Tensor


class NeighborLists(NamedTuple):
    """Compacted neighbour table.

    - ``idx``: [Nq, K] int64, source-set particle index per slot (a valid
      index even for invalid slots, so gathers are always safe);
    - ``valid``: [Nq, K] bool;
    - ``count``: [Nq] int32, valid neighbours *before* truncation (the
      DFSPH min-neighbour test, `dfsph_solver.rs:296-310`);
    - ``overflow``: [] int32, neighbours dropped by the K truncation;
    - ``cand_overflow``: [] int32, queries whose candidate window C was
      exhausted.
    """

    idx: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor
    cand_overflow: torch.Tensor


def _groups_allowed(q_groups: GroupInfo, s_groups: GroupInfo, j, qi,
                    same_model_always: bool):
    """Vectorized `InteractionGroups::test` (`interaction_groups.rs:64-69`);
    with ``same_model_always``, particles of the same model always
    interact (`contacts.rs:276-281,355-362`)."""
    mem_i = q_groups.memberships[qi][:, None]
    flt_i = q_groups.filter[qi][:, None]
    ok = ((mem_i & s_groups.filter[j]) != 0) & (
        (s_groups.memberships[j] & flt_i) != 0)
    if same_model_always:
        ok = ok | (q_groups.model[qi][:, None] == s_groups.model[j])
    return ok


def _candidate_block(q_pos, grid: SpatialGrid, n_src: int, h, dim: int,
                     max_candidates: int, divide: bool):
    """Up to C candidate source indices per query row: (j [B, C] int64,
    cand_valid [B, C] bool, truncated [B] bool)."""
    dev = q_pos.device
    offsets = torch.tensor(neighbor_cell_offsets(dim), dtype=torch.int32,
                           device=dev)  # [S, dim]
    ncells = search_cells(q_pos, h, divide)[:, None, :] + offsets[None]
    nkeys = morton_key(ncells, dim)  # [B, S]
    starts = torch.searchsorted(grid.sorted_keys, nkeys)
    lens = torch.searchsorted(grid.sorted_keys, nkeys, right=True) - starts
    cum = torch.cumsum(lens, dim=1)  # [B, S]
    total = cum[:, -1]

    ks = torch.arange(max_candidates, dtype=torch.int64, device=dev)
    # Which neighbour cell does candidate slot k fall into?
    cell_idx = torch.searchsorted(
        cum, ks.expand(cum.shape[0], max_candidates).contiguous(), right=True)
    cell_idx = torch.clamp(cell_idx, max=lens.shape[1] - 1)
    prev_cum = torch.where(
        cell_idx > 0,
        torch.gather(cum, 1, torch.clamp(cell_idx - 1, min=0)),
        0,
    )
    sorted_pos = torch.gather(starts, 1, cell_idx) + (ks[None, :] - prev_cum)
    cand_valid = ks[None, :] < torch.clamp(total, max=max_candidates)[:, None]
    sorted_pos = torch.clamp(sorted_pos, 0, max(n_src - 1, 0))
    return grid.order[sorted_pos], cand_valid, total > max_candidates


def _block_valid(q_pos, q_alive, qi, j, cand_valid, src_pos, src_alive,
                 q_groups, s_groups, h, same_model_always):
    """(dist2, valid) of a candidate block: distance test, aliveness and
    interaction groups."""
    dpos = q_pos[:, None, :] - src_pos[j]
    dist2 = torch.sum(dpos * dpos, dim=-1)
    valid = (
        cand_valid
        & (dist2 <= h * h)
        & src_alive[j]
        & q_alive[:, None]
        & _groups_allowed(q_groups, s_groups, j, qi, same_model_always)
    )
    return dist2, valid


def _pad_truncations(query_pos, grid, n_src, h, dim, max_candidates,
                     query_chunk, divide):
    """Truncated-window count of the JAX package's padding rows (dead rows
    at the origin filling the last block to ``query_chunk``)."""
    n_pad = (-query_pos.shape[0]) % query_chunk
    if n_pad == 0:
        return 0
    origin = torch.zeros((1, dim), dtype=query_pos.dtype,
                         device=query_pos.device)
    _, _, truncated = _candidate_block(origin, grid, n_src, h, dim,
                                       max_candidates, divide)
    return n_pad * truncated.to(torch.int32)[0]


def find_neighbors(
    query_pos,
    query_alive,
    q_groups: GroupInfo,
    grid: SpatialGrid,
    src_pos,
    src_alive,
    s_groups: GroupInfo,
    h,
    dim: int,
    max_neighbors: int,
    max_candidates: int,
    same_model_always: bool,
    query_chunk: int = 65536,
    divide: bool = False,
) -> NeighborLists:
    """Build the [Nq, K] neighbour table of ``query`` points against
    ``src``, in row blocks of ``query_chunk``. ``divide``: the query
    cells by a true division, as ``grid`` was built
    (``grid.search_cells``)."""
    nq, n_src = query_pos.shape[0], src_pos.shape[0]
    dev = query_pos.device
    k_cap = max_neighbors
    idx_parts, valid_parts, count_parts = [], [], []
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    cand_overflow = _pad_truncations(query_pos, grid, n_src, h, dim,
                                     max_candidates, query_chunk, divide)
    for lo in range(0, nq, query_chunk):
        hi = min(lo + query_chunk, nq)
        qi = torch.arange(lo, hi, device=dev)
        j, cand_valid, truncated = _candidate_block(
            query_pos[lo:hi], grid, n_src, h, dim, max_candidates, divide)
        _, valid = _block_valid(query_pos[lo:hi], query_alive[lo:hi], qi, j,
                                cand_valid, src_pos, src_alive, q_groups,
                                s_groups, h, same_model_always)
        count = torch.sum(valid, dim=1, dtype=torch.int32)
        # Stable compaction: valid slots first, original order preserved.
        perm = torch.argsort((~valid).to(torch.uint8), dim=1,
                             stable=True)[:, :k_cap]
        idx_parts.append(torch.gather(j, 1, perm))
        valid_parts.append(torch.gather(valid, 1, perm))
        count_parts.append(count)
        overflow = overflow + torch.clamp(count - k_cap, min=0).sum(
            dtype=torch.int32)
        cand_overflow = cand_overflow + truncated.sum(dtype=torch.int32)
        del j, cand_valid, valid, perm
    if not idx_parts:
        width = min(k_cap, max_candidates)
        idx_parts = [torch.zeros((0, width), dtype=torch.int64, device=dev)]
        valid_parts = [torch.zeros((0, width), dtype=torch.bool, device=dev)]
        count_parts = [torch.zeros((0,), dtype=torch.int32, device=dev)]
    return NeighborLists(
        idx=torch.cat(idx_parts),
        valid=torch.cat(valid_parts),
        count=torch.cat(count_parts),
        overflow=overflow,
        cand_overflow=torch.as_tensor(cand_overflow, dtype=torch.int32,
                                      device=dev),
    )


def weighted_sum_over_neighbors(
    query_pos,
    query_alive,
    q_groups: GroupInfo,
    grid: SpatialGrid,
    src_pos,
    src_alive,
    s_groups: GroupInfo,
    h,
    dim: int,
    max_candidates: int,
    same_model_always: bool,
    w_fn,
    query_chunk: int = 65536,
    divide: bool = False,
):
    """Sum ``W(|p_i - p_j|, h)`` over all neighbours without building a
    neighbour table (boundary volumes ``V_b = 1 / sum_k W_bk``,
    `dfsph_solver.rs:72-96`): (wsum [Nq], cand_overflow [] int32)."""
    nq, n_src = query_pos.shape[0], src_pos.shape[0]
    dev = query_pos.device
    parts = []
    cand_overflow = _pad_truncations(query_pos, grid, n_src, h, dim,
                                     max_candidates, query_chunk, divide)
    for lo in range(0, nq, query_chunk):
        hi = min(lo + query_chunk, nq)
        qi = torch.arange(lo, hi, device=dev)
        j, cand_valid, truncated = _candidate_block(
            query_pos[lo:hi], grid, n_src, h, dim, max_candidates, divide)
        dist2, valid = _block_valid(query_pos[lo:hi], query_alive[lo:hi], qi,
                                    j, cand_valid, src_pos, src_alive,
                                    q_groups, s_groups, h, same_model_always)
        w = w_fn(torch.sqrt(dist2), h, dim)
        parts.append(torch.sum(torch.where(valid, w, 0.0), dim=1))
        cand_overflow = cand_overflow + truncated.sum(dtype=torch.int32)
        del j, cand_valid, valid, dist2, w
    wsum = (torch.cat(parts) if parts
            else torch.zeros((0,), dtype=query_pos.dtype, device=dev))
    return wsum, torch.as_tensor(cand_overflow, dtype=torch.int32, device=dev)
