"""Boundary sampling of analytic shapes."""

from .shape_sampling import shape_surface_sample, surface_sample_sdf

__all__ = ["shape_surface_sample", "surface_sample_sdf"]
