"""Triangle meshes in the PyTorch port, against the JAX package on the CPU.

- ``shapes.VoxelSdf``: values and gradients (the port computes the
  gradient beside the value under JAX's autodiff rules) within 1e-6 of
  ``jax.grad`` of the JAX field, on a fixture of tie points (grid nodes,
  the box faces, the top cell, points outside the box) and on random
  points of a mesh's field.
- ``sampling.voxelize.trimesh_sdf`` (float64 torch in the port, numpy in
  the JAX package): the field bitwise equal, for a cube and an icosphere.
- The native sampler (``csrc/trimesh_sampler.cpp``, built with g++ at
  first use): surface and volume samples bitwise equal to the JAX
  package's ``native/`` build, through ``shape_sampling``; a failed build
  raises with the compiler's output.
- A TriMesh collider with DynamicContactSampling (the scene of
  ``tests/test_voxelize.py``) on the host and the device coupling paths,
  and a static-sampled mesh under a falling block: positions within
  2e-6 m, boundary counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import shapes as tshapes
from salva_tpu_torch.sampling import shape_sampling as tsamp
from salva_tpu_torch.sampling.voxelize import trimesh_sdf
from test_torch_coupling import pose_static_samples
from test_voxelize import cube_mesh

torch.set_num_threads(1)

GRAD_ATOL = 1e-6
POS_ATOL = 2e-6


def icosphere(subdivisions=1, radius=0.4):
    """A closed icosphere (20 * 4^subdivisions triangles) as float32
    vertices and int32 indices."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mids, out = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = out
    return (np.asarray(verts) * radius).astype(np.float32), \
        np.asarray(faces, np.int32)


def _meshes():
    from salva_tpu import shapes as jshapes

    jcube = cube_mesh()
    v, f = icosphere()
    return {
        "cube": (jcube, tshapes.TriMesh(jcube.vertices, jcube.indices)),
        "icosphere": (jshapes.TriMesh.from_arrays(v, f),
                      tshapes.TriMesh.from_arrays(v, f)),
    }


def _jax_value_and_grad(field, pts):
    p = jnp.asarray(pts)
    grad = jax.vmap(jax.grad(lambda q: jnp.sum(field.sdf(q[None]))))(p)
    return np.asarray(field.sdf(p)), np.asarray(grad)


def _hold(jfield, tfield, pts, what):
    want_v, want_g = _jax_value_and_grad(jfield, pts)
    got_v, got_g = tfield.sdf_and_grad(torch.tensor(pts))
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-6,
                               err_msg=what)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=GRAD_ATOL, err_msg=what)
    return want_g


def _tie_points(origin, spacing, shape, rng):
    """Grid nodes, points on each face of the box, the top cell and its
    corner, and points outside the box (float32, exactly representable
    with a power-of-two spacing)."""
    o = np.asarray(origin, np.float32)
    n = np.asarray(shape)
    nodes = o + rng.integers(0, n, (60, 3)) * np.float32(spacing)
    faces = []
    for axis in range(3):
        for side in (0, n[axis] - 1):
            p = o + rng.uniform(0, n - 1, (6, 3)).astype(np.float32) * spacing
            p[:, axis] = o[axis] + side * spacing
            faces.append(p)
    top = o + (n - 1) * np.float32(spacing)
    corner = np.stack([top, top - np.float32([spacing / 2, 0, 0]),
                       top - np.float32([0, spacing, spacing / 4])])
    outside = np.stack([o - 1.0, top + 0.5, o + np.float32([-0.5, 0.25, 0.5]),
                        np.float32([top[0] + 1.0, o[1] + spacing, top[2]])])
    return np.concatenate([nodes, *faces, corner, outside]).astype(np.float32)


def test_voxel_sdf_grad_matches_jax_on_ties():
    """A synthetic field (spacing 1/4, values with few mantissa bits) on
    the tie fixture: JAX's rules give one half on the clips' bounds, the
    weight tied at 1 in the top cell, and the outside term's gradient."""
    from salva_tpu import shapes as jshapes

    rng = np.random.default_rng(3)
    shape, origin, spacing = (5, 4, 6), (-1.0, -0.5, -0.75), 0.25
    vals = (np.round(rng.normal(0.0, 1.0, shape) * 64) / 64).astype(
        np.float32)
    jf = jshapes.VoxelSdf(vals, origin, spacing, shape)
    tf = tshapes.VoxelSdf(vals, origin, spacing, shape)
    assert tf == tshapes.VoxelSdf(vals.copy(), origin, spacing, shape)
    assert hash(tf) == hash(tshapes.VoxelSdf(vals, origin, spacing, shape))
    assert not tf.values.flags.writeable
    pts = _tie_points(origin, spacing, shape, rng)
    g = _hold(jf, tf, pts, "ties")
    # The ties carry JAX's halves (a gradient component at a node is the
    # mean of the two cells' slopes, not either one's).
    assert np.isfinite(g).all()
    _hold(jf, tf, rng.uniform(-1.5, 1.5, (400, 3)).astype(np.float32),
          "random")


@pytest.mark.parametrize("name", ["cube", "icosphere"])
def test_trimesh_sdf_bitwise_and_grad(name):
    jm, tm = _meshes()[name]
    from salva_tpu.sampling.voxelize import trimesh_sdf as jax_trimesh_sdf

    jf = jax_trimesh_sdf(jm, resolution=16)
    tf = trimesh_sdf(tm, resolution=16, device="cpu")
    np.testing.assert_array_equal(tf.values, jf.values)
    assert (tf.origin, tf.spacing, tf.shape) == (jf.origin, jf.spacing,
                                                 jf.shape)
    assert trimesh_sdf(tm, resolution=16, device="cpu") is tf  # cached
    rng = np.random.default_rng(7)
    _hold(jf, tf, rng.uniform(-0.7, 0.7, (300, 3)).astype(np.float32),
          name)
    # The mesh answers SDF queries through its field.
    p = torch.tensor(rng.uniform(-0.7, 0.7, (50, 3)).astype(np.float32))
    d, g = tshapes.sdf_and_grad(tm, p)
    d48, g48 = trimesh_sdf(tm, device="cpu").sdf_and_grad(p)
    assert torch.equal(d, d48) and torch.equal(g, g48)


@pytest.mark.parametrize("name", ["cube", "icosphere"])
def test_native_samples_bitwise(name):
    from salva_tpu.sampling import shape_sampling as jsamp

    jm, tm = _meshes()[name]
    for radius in (0.05, 0.03):
        for fn in ("shape_surface_sample", "shape_volume_sample"):
            want = np.asarray(getattr(jsamp, fn)(jm, radius))
            got = getattr(tsamp, fn)(tm, radius)
            assert got.dtype == np.float32 and len(got) > 50
            np.testing.assert_array_equal(got, want, err_msg=fn)


def test_failed_sampler_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a compiler that fails makes the sampler raise
    with its output."""
    from salva_tpu_torch import native
    from salva_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    native._load.cache_clear()
    try:
        v, f = icosphere(0)
        with pytest.raises(RuntimeError, match="trimesh_sampler.cpp"):
            native.trimesh_surface_sample(v, f, 0.05)
    finally:
        native._load.cache_clear()


def _mesh_pipelines(device_coupling):
    """tests/test_voxelize.py's scene in both packages: one particle
    inside the unit cube mesh, one far away, DynamicContactSampling."""
    from salva_tpu.coupling import ColliderSampling, FluidsPipeline
    from salva_tpu.world import Boundary, Fluid
    from salva_tpu_torch import coupling

    jm, tm = _meshes()["cube"]
    pos = [[0.0, 0.45, 0.0], [0.0, 2.0, 0.0], [0.3, -0.2, 0.1]]
    out = []
    for mod, mesh, kw, F, B in (
            (None, jm, {}, Fluid, Boundary),
            (coupling, tm, dict(device="cpu"), st.Fluid, st.Boundary)):
        cls = FluidsPipeline if mod is None else coupling.FluidsPipeline
        samp = ColliderSampling if mod is None else coupling.ColliderSampling
        pip = cls(0.025, 2.0, dim=3, device_coupling=device_coupling, **kw)
        fl = pip.liquid_world.add_fluid(F(pos, density0=1000.0))
        body = pip.bodies.add_body("fixed")
        co = pip.bodies.add_collider(body, mesh)
        bo = pip.liquid_world.add_boundary(B(np.zeros((0, 3))))
        pip.coupling.register_coupling(
            bo, co, samp.dynamic_contact_sampling())
        out.append((pip, fl, bo))
    return out


@pytest.mark.parametrize("device_coupling", [False, True],
                         ids=["host", "device"])
def test_mesh_collider_matches_jax(device_coupling):
    (jp, jfl, jbo), (tp, tfl, tbo) = _mesh_pipelines(device_coupling)
    assert tp.device_coupling == device_coupling
    emitted = []
    for _ in range(3):
        jp.step((0.0, -9.81, 0.0), 1.0 / 200.0)
        tp.step((0.0, -9.81, 0.0), 1.0 / 200.0)
        jw, tw = jp.liquid_world, tp.liquid_world
        np.testing.assert_allclose(tw.fluid_positions(tfl),
                                   jw.fluid_positions(jfl), rtol=0,
                                   atol=POS_ATOL)
        emitted.append(int(tw.boundaries_state.alive.sum()))
        assert emitted[-1] == int(np.asarray(jw.boundaries_state.alive).sum())
        np.testing.assert_allclose(
            tw.boundary_positions(tbo), jw.boundary_positions(jbo),
            rtol=0, atol=POS_ATOL)
    # The penetrating particle was pushed out of the mesh (within a voxel).
    field = trimesh_sdf(_meshes()["cube"][1], device="cpu")
    d = field.sdf(torch.tensor(tw.fluid_positions(tfl)))
    assert float(d.min()) > -2.0 * field.spacing
    assert emitted[0] > 0, emitted  # the first step's contact sample


def test_static_mesh_boundary_matches_jax():
    """A small block falls onto a static-sampled icosphere (the native
    surface sampler) on the host coupling path: the same boundary points,
    positions within 2e-6 m."""
    from salva_tpu.coupling import ColliderSampling, FluidsPipeline
    from salva_tpu.sampling import shape_surface_sample as jsample
    from salva_tpu.world import Boundary, Fluid
    from salva_tpu_torch import coupling

    jm, tm = _meshes()["icosphere"]
    r = 0.05
    xs = (np.arange(5) * 2 * r - 0.2).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs + 0.55, xs, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    pts_j = np.asarray(jsample(jm, r))
    pts_t = tsamp.shape_surface_sample(tm, r)
    np.testing.assert_array_equal(pts_t, pts_j)
    worlds = []
    for cls, samp, mesh, pts, F, B, kw in (
            (FluidsPipeline, ColliderSampling, jm, pts_j, Fluid, Boundary,
             {}),
            (coupling.FluidsPipeline, coupling.ColliderSampling, tm, pts_t,
             st.Fluid, st.Boundary, dict(device="cpu"))):
        pip = cls(r, 2.0, dim=3, device_coupling=False, **kw)
        fl = pip.liquid_world.add_fluid(F(pos, density0=1000.0))
        body = pip.bodies.add_body("fixed")
        co = pip.bodies.add_collider(body, mesh)
        bo = pip.liquid_world.add_boundary(B(np.zeros((0, 3))))
        pip.coupling.register_coupling(bo, co, samp.static_sampling(pts))
        worlds.append((pip, fl, bo))
    (jp, jfl, jbo), (tp, tfl, tbo) = worlds
    pose_static_samples(jp)  # the port's first-step input
    for _ in range(3):
        jp.step((0.0, -9.81, 0.0), 1.0 / 200.0)
        tp.step((0.0, -9.81, 0.0), 1.0 / 200.0)
    np.testing.assert_allclose(tp.liquid_world.fluid_positions(tfl),
                               jp.liquid_world.fluid_positions(jfl), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_array_equal(tp.liquid_world.boundary_positions(tbo),
                                  jp.liquid_world.boundary_positions(jbo))
