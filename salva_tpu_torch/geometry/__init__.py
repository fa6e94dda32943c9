"""Spatial binning: the dense layout's cell grid and the gather layout's
Morton grid, neighbour tables and contacts."""

from . import dense_grid
from .contacts import Contacts, evaluate_contacts
from .grid import (
    SpatialGrid,
    build_grid,
    cell_coords,
    morton_key,
    neighbor_cell_offsets,
)
from .neighbors import (
    GroupInfo,
    NeighborLists,
    find_neighbors,
    weighted_sum_over_neighbors,
)

__all__ = [
    "dense_grid",
    "Contacts",
    "evaluate_contacts",
    "SpatialGrid",
    "build_grid",
    "cell_coords",
    "morton_key",
    "neighbor_cell_offsets",
    "GroupInfo",
    "NeighborLists",
    "find_neighbors",
    "weighted_sum_over_neighbors",
]
