"""Boundary-particle generation from shapes.

Port of ``salva_tpu.sampling.shape_sampling``: the reference's ray-cast
sampling (``src/sampling/ray_sampling.rs``) on a ``2 * radius`` lattice,
classified by the shape's SDF:

- surface sample: lattice points with ``|sdf| <= radius`` (`:27-88`);
- volume sample: lattice points with ``sdf <= radius`` (the interior and
  the surface shell, `:91-164`);
- a heightfield's surface: points on its own surface grid.

Host-side and deterministic: the SDF runs on CPU tensors of the float32
lattice, and the output is a float32 numpy array of local-space points,
equal to the JAX package's. A ``TriMesh`` goes to the native ray-cast
sampler (``native``: C++ built with ``g++`` at first use; a failed build
raises). A ``HalfSpace`` has no bounding box, so it raises ``TypeError``
as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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
    shp.check_ported(shape)
    if isinstance(shape, shp.Ball):
        r = shape.radius
        return [-r] * dim, [r] * dim
    if isinstance(shape, shp.Cuboid):
        he = list(shape.half_extents)
        return [-h for h in he], he
    if isinstance(shape, shp.Capsule):
        r, hh = shape.radius, shape.half_height
        lo = [-r] * dim
        hi = [r] * dim
        lo[1] = -hh - r
        hi[1] = hh + r
        return lo, hi
    if isinstance(shape, shp.Heightfield):
        hs = np.asarray(shape.heights)
        if len(shape.shape) == 1:
            sx = shape.extent[0]
            return [-sx / 2, float(hs.min())], [sx / 2, float(hs.max())]
        sx, sz = shape.extent
        return (
            [-sx / 2, float(hs.min()), -sz / 2],
            [sx / 2, float(hs.max()), sz / 2],
        )
    raise TypeError(f"cannot infer AABB of {type(shape).__name__}")


def _host_sdf(shape):
    """The shape's SDF on a float32 numpy array, evaluated on the CPU."""
    return lambda p: shape.sdf(torch.from_numpy(np.asarray(p))).numpy()


def surface_sample_sdf(sdf_fn, mins, maxs, particle_radius: float):
    """Sample an SDF's zero level set on a 2r lattice (`ray_sampling.rs`
    surface semantics: one quantized point per surface crossing)."""
    spacing = 2.0 * particle_radius
    pad = spacing
    pts = _lattice(
        [m - pad for m in mins], [m + pad for m in maxs], spacing
    )
    d = np.asarray(sdf_fn(pts))
    keep = np.abs(d) <= particle_radius
    return pts[keep]


def volume_sample_sdf(sdf_fn, mins, maxs, particle_radius: float):
    """Sample an SDF's interior (including the surface shell) on a 2r
    lattice (`ray_sampling.rs:91-164` volume semantics)."""
    spacing = 2.0 * particle_radius
    pts = _lattice(mins, maxs, spacing)
    d = np.asarray(sdf_fn(pts))
    keep = d <= particle_radius
    return pts[keep]


def shape_surface_sample(shape, particle_radius: float, dim: int = 3):
    """Surface boundary particles of an analytic shape in its local frame
    (the `shape_surface_ray_sample` equivalent, `sampling/mod.rs:3-5`)."""
    if isinstance(shape, shp.Heightfield):
        return _heightfield_surface(shape, particle_radius)
    if isinstance(shape, shp.TriMesh):
        from ..native import trimesh_surface_sample

        return trimesh_surface_sample(
            np.asarray(shape.vertices, np.float32),
            np.asarray(shape.indices, np.int32),
            particle_radius,
        )
    mins, maxs = _shape_aabb(shape, dim)
    return surface_sample_sdf(_host_sdf(shape), mins, maxs, particle_radius)


def shape_volume_sample(shape, particle_radius: float, dim: int = 3):
    """Volume sample of an analytic shape in its local frame
    (`shape_volume_ray_sample` equivalent)."""
    if isinstance(shape, shp.TriMesh):
        from ..native import trimesh_volume_sample

        return trimesh_volume_sample(
            np.asarray(shape.vertices, np.float32),
            np.asarray(shape.indices, np.int32),
            particle_radius,
        )
    mins, maxs = _shape_aabb(shape, dim)
    return volume_sample_sdf(_host_sdf(shape), mins, maxs, particle_radius)


def _heightfield_surface(shape: "shp.Heightfield", particle_radius: float):
    """Sample a heightfield directly on its own surface grid (a ray cast
    straight down would hit exactly these points)."""
    spacing = 2.0 * particle_radius
    if len(shape.shape) == 1:
        sx = shape.extent[0]
        xs = np.arange(-sx / 2, sx / 2 + spacing * 0.5, spacing)
        pts2 = np.stack([xs, np.zeros_like(xs)], axis=-1).astype(np.float32)
        ys = shape._height_at(torch.from_numpy(pts2)).numpy()
        return np.stack([xs, ys], axis=-1).astype(np.float32)
    sx, sz = shape.extent
    xs = np.arange(-sx / 2, sx / 2 + spacing * 0.5, spacing)
    zs = np.arange(-sz / 2, sz / 2 + spacing * 0.5, spacing)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    flat = np.stack([gx.ravel(), gz.ravel()], axis=-1).astype(np.float32)
    ys = shape._height_at(torch.from_numpy(flat)).numpy()
    return np.stack(
        [flat[:, 0], ys, flat[:, 1]], axis=-1
    ).astype(np.float32)
