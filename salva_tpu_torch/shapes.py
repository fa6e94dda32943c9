"""Analytic shapes as signed distance fields.

Port of ``salva_tpu.shapes``: ``Ball``, ``Cuboid``, ``Capsule``,
``HalfSpace`` and ``Heightfield`` (2D and 3D), the triangle mesh
``TriMesh`` and its voxelized field ``VoxelSdf`` (3D), with
``sdf_normal``, ``world_sdf`` and ``project_point``. Projection of ``p`` onto a surface is
``p - sdf(p) * normal(p)``; penetration is ``sdf(p) < 0``. Each ``sdf``
takes a float32 torch tensor of points on any device; the host-side
sampling (``sampling.shape_sampling``) evaluates it on CPU tensors made
from float32 numpy lattices.

The JAX package takes the normal as the autodiff gradient of the SDF.
Here each shape computes its gradient beside its value
(``sdf_and_grad``) with JAX's differentiation rules, which differ from
torch's where the SDF is not differentiable: ``d|x|/dx = +1`` at
``x = 0``; ``maximum`` / ``minimum`` of two equal values give each half
the gradient (so ``clip`` gives one half on its bounds); a reduction's
maximum shares the gradient equally among the entries that attain it.
So the normal at a cube's centre is (1, 1, 1) / sqrt(3), as in the JAX
package, and never the zero vector torch's autograd would give.

A ``TriMesh`` has no analytic SDF: its queries go through its cached
voxelized field (``sampling.voxelize.trimesh_sdf``, a ``VoxelSdf``), as
the JAX package's coupling and queries take it. A query on an object
that is not a shape of this package (a ``salva_tpu`` shape, say) raises
``NotImplementedError`` by name.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np

import torch


def dot(a, b):
    """sum(a * b) over the last axis, added left to right (the order of
    the JAX package's reduction over a short axis)."""
    s = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i] * b[..., i]
    return s


def _sq_sum(v):
    return dot(v, v)


def _safe_norm_and_grad(v):
    """|v| over the last axis, zero (with a zero gradient) at v = 0
    (``salva_tpu.shapes._safe_norm``), and its gradient."""
    sq = _sq_sum(v)
    pos = sq > 0
    s = torch.sqrt(torch.where(pos, sq, 1.0))
    c = torch.where(pos, 0.5 / s, 0.0)[..., None]
    return torch.where(pos, s, 0.0), c * v + c * v


def _max_grad(x, other):
    """d maximum(x, other) / dx under JAX's rule: 1 where x wins, 1/2 at
    a tie, 0 where it loses."""
    return torch.where(x > other, 1.0, torch.where(x == other, 0.5, 0.0))


def _min_grad(x, other):
    return torch.where(x < other, 1.0, torch.where(x == other, 0.5, 0.0))


def _clip_and_grad(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` = minimum(hi, maximum(lo, x)) and its
    gradient (one half on either bound)."""
    a = torch.clamp(x, min=lo)
    return torch.clamp(a, max=hi), _max_grad(x, lo) * _min_grad(a, hi)


def _const(shape, name, like, dtype=None):
    """Field ``name`` of ``shape`` as a tensor on ``like``'s device, made
    once per device (a host-to-device copy each query would synchronize
    the card)."""
    dtype = dtype or like.dtype
    cache = shape.__dict__.setdefault("_tensors", {})
    key = (name, like.device, dtype)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.tensor(getattr(shape, name), dtype=dtype,
                                      device=like.device)
    return t


@dataclasses.dataclass(frozen=True)
class Ball:
    radius: float

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        n, g = _safe_norm_and_grad(p)
        return n - self.radius, g


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Box with the given half-extents (dim inferred from the tuple)."""

    half_extents: Tuple[float, ...]

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        b = _const(self, "half_extents", p)
        q = torch.abs(p) - b
        m = torch.clamp(q, min=0.0)
        outside, g_out = _safe_norm_and_grad(m)
        qmax = torch.amax(q, dim=-1)
        inside = torch.clamp(qmax, max=0.0)
        ties = (q == qmax[..., None]).to(p.dtype)
        share = ties / torch.sum(ties, dim=-1, keepdim=True)
        g_in = _min_grad(qmax, 0.0)[..., None] * share
        g_q = g_out * _max_grad(q, 0.0) + g_in
        sign = torch.where(p >= 0, 1.0, -1.0)
        return outside + inside, g_q * sign


@dataclasses.dataclass(frozen=True)
class Capsule:
    """Capsule along the local y axis: segment [-half_height, half_height]
    with the given radius."""

    half_height: float
    radius: float

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        hh = self.half_height
        y, dy = _clip_and_grad(p[..., 1], -hh, hh)
        d = p.clone()
        d[..., 1] = p[..., 1] - y
        n, g = _safe_norm_and_grad(d)
        g = g.clone()
        g[..., 1] = g[..., 1] + (-g[..., 1]) * dy
        return n - self.radius, g


@dataclasses.dataclass(frozen=True)
class HalfSpace:
    """Half-space below the plane with local normal ``normal`` through the
    origin: sdf = dot(n, p)."""

    normal: Tuple[float, ...]

    def _unit(self, p):
        n = _const(self, "normal", p)
        return n / torch.sqrt(_sq_sum(n))

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        n = self._unit(p)
        d = p[..., 0] * n[0]
        for i in range(1, p.shape[-1]):
            d = d + p[..., i] * n[i]
        return d, n.expand(p.shape).clone()


@dataclasses.dataclass(frozen=True)
class Heightfield:
    """Heightfield over the local x (2D) or x/z (3D) axes.

    ``heights``: tuple (2D: [nx]; 3D: row-major [nx, nz] flattened) sampled
    uniformly over ``extent`` centered at the origin. The pseudo-SDF is the
    vertical distance ``p_y - h(p_xz)`` (exact for flat terrain, a standard
    approximation on slopes).
    """

    heights: Tuple[float, ...]
    extent: Tuple[float, ...]  # (size_x,) in 2D; (size_x, size_z) in 3D
    shape: Tuple[int, ...]  # (nx,) or (nx, nz)

    def _axis(self, x, size, n):
        """Cell index, fraction and d(fraction)/dx along one axis."""
        f = (x / size + 0.5) * (n - 1)
        i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
        t, dt = _clip_and_grad(f - i0.to(x.dtype), 0.0, 1.0)
        return i0, t, dt * (n - 1) / size

    def _height_and_grad(self, xz):
        hs = _const(self, "heights", xz, torch.float32).reshape(self.shape)
        if len(self.shape) == 1:
            i0, t, dt = self._axis(xz[..., 0], self.extent[0], self.shape[0])
            h0, h1 = hs[i0], hs[i0 + 1]
            return h0 * (1 - t) + h1 * t, ((h1 - h0) * dt)[..., None]
        nx, nz = self.shape
        i0, tx, dtx = self._axis(xz[..., 0], self.extent[0], nx)
        k0, tz, dtz = self._axis(xz[..., 1], self.extent[1], nz)
        h00, h10 = hs[i0, k0], hs[i0 + 1, k0]
        h01, h11 = hs[i0, k0 + 1], hs[i0 + 1, k0 + 1]
        h = (h00 * (1 - tx) * (1 - tz) + h10 * tx * (1 - tz)
             + h01 * (1 - tx) * tz + h11 * tx * tz)
        gx = ((h10 - h00) * (1 - tz) + (h11 - h01) * tz) * dtx
        gz = ((h01 - h00) * (1 - tx) + (h11 - h10) * tx) * dtz
        return h, torch.stack([gx, gz], dim=-1)

    def _height_at(self, xz):
        return self._height_and_grad(xz)[0]

    def _xz(self, p):
        if len(self.shape) == 1:
            return p[..., 0:1]
        return torch.stack([p[..., 0], p[..., 2]], dim=-1)

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        h, gh = self._height_and_grad(self._xz(p))
        g = torch.zeros_like(p)
        g[..., 1] = 1.0
        g[..., 0] = -gh[..., 0]
        if len(self.shape) == 2:
            g[..., 2] = -gh[..., 1]
        return p[..., 1] - h, g


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Triangle mesh (host-side shape for boundary sampling).

    Sampled through the native ray-cast sampler (``native``), covering
    the reference's parry TriMesh support in ``shape_surface_ray_sample``
    (`ray_sampling.rs`). SDF queries (DynamicContactSampling coupling,
    shape intersection tests) go through a cached voxelized
    signed-distance field (``sampling.voxelize.trimesh_sdf`` ->
    :class:`VoxelSdf`). ``vertices`` / ``indices`` are nested tuples so
    the mesh stays hashable.
    """

    vertices: Tuple[Tuple[float, float, float], ...]
    indices: Tuple[Tuple[int, int, int], ...]

    @staticmethod
    def from_arrays(vertices, indices) -> "TriMesh":
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        t = np.asarray(indices, np.int32).reshape(-1, 3)
        return TriMesh(
            tuple(tuple(float(x) for x in row) for row in v),
            tuple(tuple(int(x) for x in row) for row in t),
        )


@dataclasses.dataclass(frozen=True, eq=False)
class VoxelSdf:
    """Discretized signed-distance field on a regular 3D grid (trilinear).

    The stand-in for shapes with no analytic SDF, triangle meshes above
    all (``sampling.voxelize.trimesh_sdf``): it gives TriMesh colliders
    the DynamicContactSampling the reference gets from parry's per-shape
    point projection (`fluids_pipeline.rs:192-255`). Outside the grid box
    the clamped border value plus the distance to the box is returned, so
    projection directions stay sane far away.

    ``values`` is held as a read-only float32 ndarray (flattened
    row-major) and hashed once by digest, so a coupling can key its
    per-field tensors on the shape cheaply.
    """

    values: object
    origin: Tuple[float, float, float]
    spacing: float
    shape: Tuple[int, int, int]

    def __post_init__(self):
        v = np.ascontiguousarray(
            np.asarray(self.values, np.float32).reshape(-1)
        )
        v.setflags(write=False)
        object.__setattr__(self, "values", v)
        key = (
            hashlib.sha1(v.tobytes()).digest(),
            tuple(self.origin),
            float(self.spacing),
            tuple(self.shape),
        )
        object.__setattr__(self, "_key", key)

    def __eq__(self, other):
        return isinstance(other, VoxelSdf) and self._key == other._key

    def __hash__(self):
        return hash(self._key)

    def sdf(self, p):
        return self.sdf_and_grad(p)[0]

    def sdf_and_grad(self, p):
        """Value and gradient under JAX's rules: ``fc = clip(f, 0, n - 1)``
        and each weight ``t = clip(fc - i0, 0, 1)`` pass one half of the
        gradient on their bounds (``t`` is tied at 1 in the top cell), and
        the outside term ``sqrt(d2 + 1e-12) * spacing`` adds its own."""
        vals = _const(self, "values", p, torch.float32).reshape(self.shape)
        hi = _const(self, "shape", p) - 1.0
        f = (p - _const(self, "origin", p)) / self.spacing
        fc, dfc = _clip_and_grad(f, 0.0, hi)
        top = _const(self, "shape", p, torch.int64) - 2
        i0 = torch.minimum(torch.clamp(torch.floor(fc).to(torch.int64),
                                       min=0), top)
        t, dt = _clip_and_grad(fc - i0.to(fc.dtype), 0.0, 1.0)
        ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]
        tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

        def v(dx, dy, dz):
            return vals[ix + dx, iy + dy, iz + dz]

        v000, v100, v010, v110 = v(0, 0, 0), v(1, 0, 0), v(0, 1, 0), v(1, 1, 0)
        v001, v101, v011, v111 = v(0, 0, 1), v(1, 0, 1), v(0, 1, 1), v(1, 1, 1)
        c00 = v000 * (1 - tx) + v100 * tx
        c10 = v010 * (1 - tx) + v110 * tx
        c01 = v001 * (1 - tx) + v101 * tx
        c11 = v011 * (1 - tx) + v111 * tx
        c0 = c00 * (1 - ty) + c10 * ty
        c1 = c01 * (1 - ty) + c11 * ty
        inner = c0 * (1 - tz) + c1 * tz
        # Outside the grid: the distance to the grid box (the epsilon
        # keeps the normal finite where f == fc).
        off = f - fc
        root = torch.sqrt(dot(off, off) + 1.0e-12)
        value = inner + root * self.spacing

        # d inner / d t, weighted as JAX's reverse pass weights each
        # corner (the cotangent of a corner product, then its value).
        w0, w1 = 1 - tz, tz
        w00, w10, w01, w11 = w0 * (1 - ty), w0 * ty, w1 * (1 - ty), w1 * ty
        g_tx = (v111 * w11 - v011 * w11 + v101 * w01 - v001 * w01
                + v110 * w10 - v010 * w10 + v100 * w00 - v000 * w00)
        g_ty = c11 * w1 - c01 * w1 + c10 * w0 - c00 * w0
        g_tz = c1 - c0
        g_fc = torch.stack([g_tx, g_ty, g_tz], dim=-1) * dt
        g_off = (0.5 / root * self.spacing)[..., None] * (off + off)
        g_f = g_fc * dfc + g_off * (1.0 - dfc)
        return value, g_f / self.spacing


SHAPES = (Ball, Cuboid, Capsule, HalfSpace, Heightfield, TriMesh, VoxelSdf)


def check_ported(shape):
    """Raise ``NotImplementedError``, by name, for an object that is not a
    shape of this package (a ``salva_tpu`` shape, say)."""
    if not isinstance(shape, SHAPES):
        raise NotImplementedError(
            f"{type(shape).__name__} is not a shape of salva_tpu_torch "
            "(ported: " + ", ".join(s.__name__ for s in SHAPES) + ")"
        )


def sdf_and_grad(shape, p):
    """(SDF value, SDF gradient) of ``shape`` at local points ``p``; a
    ``TriMesh`` answers through its cached voxelized field."""
    check_ported(shape)
    if isinstance(shape, TriMesh):
        from .sampling.voxelize import trimesh_sdf

        shape = trimesh_sdf(shape, device=p.device)
    return shape.sdf_and_grad(p)


def _unit(g):
    n = torch.sqrt(_sq_sum(g))[..., None]
    return g / torch.where(n > 1e-9, n, 1.0)


def sdf_normal(shape, p):
    """Unit outward normal = the normalized SDF gradient, under JAX's
    differentiation rules (module docstring)."""
    return _unit(sdf_and_grad(shape, p)[1])


def _to_local(p_world, rotation, translation):
    return (p_world - translation) @ rotation


def world_sdf(shape, p_world, rotation, translation):
    """SDF of a posed shape: transform points into the local frame."""
    return sdf_and_grad(shape, _to_local(p_world, rotation, translation))[0]


def project_point(shape, p_world, rotation, translation):
    """Project world points onto the posed shape's surface.

    Returns (projection, sdf_value, world_normal).
    """
    d, g = sdf_and_grad(shape, _to_local(p_world, rotation, translation))
    n_world = _unit(g) @ rotation.T
    return p_world - d[..., None] * n_world, d, n_world
