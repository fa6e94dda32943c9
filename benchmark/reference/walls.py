"""Wall samples and fluid lattices, made from a configuration.

A frozen copy of the cuboid surface sampling that salva's scenes use
(`ray_sampling.rs` surface semantics: the points of a 2r lattice whose
signed distance to the box lies within r), the rigid pose of a collider's
samples, and the seeded jitter of a fluid lattice. The benchmark hands the
local samples to the program as ``ColliderSampling.static_sampling``
points and poses them here for the reference, so both sides start from
the same arrays. NumPy only.
"""

from __future__ import annotations

import numpy as np


def _lattice(mins, maxs, spacing):
    axes = [np.arange(lo, hi + spacing * 0.5, spacing, dtype=np.float64)
            for lo, hi in zip(mins, maxs)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return pts.reshape(-1, len(axes)).astype(np.float32)


def box_sdf(points, half_extents):
    """Signed distance of float32 ``points`` [n, 3] to a box centred at the
    origin, in float32."""
    b = np.asarray(half_extents, np.float32)
    q = np.abs(points) - b
    m = np.maximum(q, np.float32(0.0))
    sq = m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1] + m[:, 2] * m[:, 2]
    outside = np.where(sq > 0, np.sqrt(np.where(sq > 0, sq, 1.0)), 0.0)
    inside = np.minimum(q.max(axis=1), np.float32(0.0))
    return (outside + inside).astype(np.float32)


def cuboid_surface_samples(half_extents, radius: float) -> np.ndarray:
    """Local-frame surface samples of a box: lattice points of spacing 2r,
    padded by one spacing around the box, with |sdf| <= r."""
    spacing = 2.0 * radius
    he = [float(v) for v in half_extents]
    pts = _lattice([-v - spacing for v in he], [v + spacing for v in he],
                   spacing)
    return pts[np.abs(box_sdf(pts, he)) <= radius]


def posed(local, translation, rotation=None) -> np.ndarray:
    """``local @ R^T + t`` in float32, the world-space samples of a
    collider at rest."""
    if rotation is not None:
        local = local @ np.asarray(rotation, np.float32).T
    return (local + np.asarray(translation, np.float32)).astype(np.float32)


def cube_lattice(n: int, radius: float) -> np.ndarray:
    """n^3 points spaced 2r, centred on the origin (`examples3d/helper.rs`),
    float32."""
    ax = (np.arange(n, dtype=np.float32) * 2.0 + 1.0) * radius - n * radius
    pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)
    return pos.reshape(-1, 3).astype(np.float32)


def seeded_jitter(count: int, amplitude: float, seed: int) -> np.ndarray:
    """Uniform jitter in [-a, a] on each coordinate of ``count`` particles,
    drawn from ``seed``, float32 [count, 3]."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed) % 2 ** 64))
    a = float(amplitude)
    return rng.uniform(-a, a, size=(count, 3)).astype(np.float32)
