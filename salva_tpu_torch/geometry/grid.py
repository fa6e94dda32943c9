"""Sort-based spatial hashing on Morton keys (the gather layout's grid).

Port of ``salva_tpu.geometry.grid``: particles get a Morton (Z-order) key
of their wrapped integer cell coordinates and are sorted by it, so a
cell's particles form a contiguous range of the sorted order, found by
binary search. Cell width equals the kernel radius ``h``
(``contacts.rs:165``), so every neighbour of a particle lies in the 3^dim
adjacent cells.

Keys: the JAX package computes them in ``uint32``; torch has no usable
unsigned 32-bit type for shifts, sorts and ``searchsorted``, so they are
``int64`` holding the same values. Cell coordinates are masked to 10 bits
per axis in 3D (15 in 2D) exactly as the ``uint32`` cast does (``&`` of a
negative ``int64`` keeps the same low bits), so keys alias with a period
of 1024 (resp. 32768) cells; aliased cells only add candidates that the
exact distance test filters out. ``DEAD_KEY`` (2^32 - 1) sorts after
every real key (at most 30 bits).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Bits per axis for the Morton keys.
MORTON_BITS = {2: 15, 3: 10}

# Key assigned to dead (masked-out) particles: sorts after every real key.
DEAD_KEY = 0xFFFFFFFF


def _expand_bits_3(v):
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _expand_bits_2(v):
    """Spread the low 16 bits of v so they occupy every 2nd bit."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_key(cells, dim: int):
    """Morton key (int64, uint32 values) of integer cell coordinates
    ``cells[..., dim]``, wrapped to the key space."""
    c = cells.to(torch.int64) & ((1 << MORTON_BITS[dim]) - 1)
    if dim == 2:
        return _expand_bits_2(c[..., 0]) | (_expand_bits_2(c[..., 1]) << 1)
    return (
        _expand_bits_3(c[..., 0])
        | (_expand_bits_3(c[..., 1]) << 1)
        | (_expand_bits_3(c[..., 2]) << 2)
    )


def cell_coords(positions, h):
    """Integer cell coordinates ``floor(p / h)`` (`hgrid.rs:41-51`), int32,
    by a true division, as the JAX package's eager callers bin (``z_sort``,
    the elasticity's rest state). ``h`` divides as a tensor on the
    positions' device: a Python divisor would make CUDA multiply by its
    reciprocal."""
    h_t = torch.full((), h, dtype=positions.dtype, device=positions.device)
    return torch.floor(positions / h_t).to(torch.int32)


def search_cells(positions, h, divide: bool = False):
    """The cells the gather search bins with: ``floor(p * (1 / h))`` with
    the float32 reciprocal, as the JAX package's jitted step bins (XLA
    compiles the division by the constant ``h`` as that multiplication,
    which puts some particles on a cell edge one cell higher than a true
    division does); with ``divide``, :func:`cell_coords`."""
    if divide:
        return cell_coords(positions, h)
    inv = float(np.float32(1.0) / np.float32(h))
    return torch.floor(positions * inv).to(torch.int32)


class SpatialGrid(NamedTuple):
    """Sorted Morton-key index over a point set.

    - ``order``: [N] int64, particle indices sorted by key (dead last);
    - ``sorted_keys``: [N] int64, keys in sorted order;
    - ``cells``: [N, dim] int32, unsorted cell coords of every particle.
    """

    order: torch.Tensor
    sorted_keys: torch.Tensor
    cells: torch.Tensor


def build_grid(positions, alive, h, dim: int,
               divide: bool = False) -> SpatialGrid:
    """Build the sorted cell index for a point set (``HGrid::insert``
    over all particles, ``contacts.rs:133-151``): one key computation and
    one stable sort, as ``jnp.argsort`` is stable. The cells are
    :func:`search_cells` (``divide``: a true division)."""
    cells = search_cells(positions, h, divide)
    keys = torch.where(alive, morton_key(cells, dim), DEAD_KEY)
    order = torch.argsort(keys, stable=True)
    return SpatialGrid(order=order, sorted_keys=keys[order], cells=cells)


def neighbor_cell_offsets(dim: int):
    """Static list of the 3^dim neighbour-cell offsets (full stencil):
    every particle gathers its own neighbours, so the full stencil yields
    the reference's contact set (``contacts.rs:202-220``) with no
    scatter."""
    if dim == 2:
        return [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    return [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
    ]
