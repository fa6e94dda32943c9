"""Boundary-particle generation from shapes (the main-path subset).

Port of ``salva_tpu.sampling.shape_sampling``: the surface of an SDF
shape is sampled on a ``2 * radius`` lattice, keeping the lattice points
with ``|sdf| <= radius`` (the reference's ray-cast surface sampling,
``src/sampling/ray_sampling.rs:27-88``). Host-side, deterministic,
float32 numpy output in the shape's local frame.
"""

from __future__ import annotations

import numpy as np

from .. import shapes as shp


def _lattice(mins, maxs, spacing):
    axes = [
        np.arange(lo, hi + spacing * 0.5, spacing, dtype=np.float64)
        for lo, hi in zip(mins, maxs)
    ]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(
        -1, len(axes)
    )
    return pts.astype(np.float32)


def _shape_aabb(shape, dim: int):
    if isinstance(shape, shp.Cuboid):
        he = list(shape.half_extents)
        return [-h for h in he], he
    raise NotImplementedError(
        f"sampling {type(shape).__name__} is not ported to salva_tpu_torch"
    )


def surface_sample_sdf(sdf_fn, mins, maxs, particle_radius: float):
    """Sample an SDF's zero level set on a 2r lattice."""
    spacing = 2.0 * particle_radius
    pad = spacing
    pts = _lattice(
        [m - pad for m in mins], [m + pad for m in maxs], spacing
    )
    d = np.asarray(sdf_fn(pts))
    keep = np.abs(d) <= particle_radius
    return pts[keep]


def shape_surface_sample(shape, particle_radius: float, dim: int = 3):
    """Surface boundary particles of an analytic shape in its local frame
    (the `shape_surface_ray_sample` equivalent, `sampling/mod.rs:3-5`)."""
    mins, maxs = _shape_aabb(shape, dim)
    return surface_sample_sdf(shape.sdf, mins, maxs, particle_radius)
