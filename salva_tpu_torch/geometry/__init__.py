"""Spatial binning for the dense layout."""

from . import dense_grid

__all__ = ["dense_grid"]
