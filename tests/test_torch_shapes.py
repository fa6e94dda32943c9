"""The analytic shapes and their sampling on the PyTorch port, against the
JAX package on the CPU.

- SDF values (within 1e-6) and normals, for every ported shape in 2D and
  3D, on random points and on a fixture of tie points where the SDF is
  not differentiable: shape centres, face centres, edges and diagonals,
  the plane y = 0 of a thin box (``surface_tension2``'s ground), capsule
  end caps and heightfield cell edges. The JAX package takes its normals
  from autodiff; the port reproduces JAX's rules (``d|x|/dx = +1`` at 0,
  ties of ``maximum`` / ``minimum`` / ``max`` shared), so the normals
  must agree within 1e-6, zero vectors and ties included.
- ``project_point`` and ``world_sdf`` of posed shapes (within 2e-6).
- The surface, volume and heightfield point sets, exactly.
"""

import numpy as np
import pytest
import torch

from salva_tpu import shapes as jshapes
from salva_tpu.sampling import shape_sampling as jsamp
from salva_tpu_torch import shapes as tshapes
from salva_tpu_torch.sampling import shape_sampling as tsamp

torch.set_num_threads(1)


def _heightfield(pkg, dim):
    """A small 2D or 3D heightfield of the scenes' kind (raised borders)."""
    rng = np.random.default_rng(3)
    if dim == 2:
        hs = rng.uniform(-0.5, 0.5, 9).astype(np.float32)
        hs[0] = hs[-1] = 2.0
        return pkg.Heightfield(tuple(float(v) for v in hs), (4.0,), (9,))
    hs = rng.uniform(-0.5, 0.5, (7, 5)).astype(np.float32)
    hs[0, :] = hs[-1, :] = 2.0
    return pkg.Heightfield(tuple(float(v) for v in hs.ravel()), (3.0, 2.0),
                           (7, 5))


def _shape(pkg, kind, dim):
    if kind == "ball":
        return pkg.Ball(0.4)
    if kind == "cuboid":
        return pkg.Cuboid((0.5, 0.25, 0.75)[:dim])
    if kind == "thin_cuboid":
        return pkg.Cuboid((0.15, 0.02, 0.15)[:dim])
    if kind == "capsule":
        return pkg.Capsule(0.3, 0.2)
    if kind == "halfspace":
        return pkg.HalfSpace((0.3, 1.0, -0.2)[:dim])
    return _heightfield(pkg, dim)


KINDS = ["ball", "cuboid", "thin_cuboid", "capsule", "halfspace",
         "heightfield"]


def _tie_points(kind, dim):
    """Points where the SDF has ties or kinks, for each shape."""
    z = np.zeros(dim, np.float32)
    pts = [z]
    if kind in ("cuboid", "thin_cuboid"):
        he = np.asarray((0.5, 0.25, 0.75)[:dim] if kind == "cuboid"
                        else (0.15, 0.02, 0.15)[:dim], np.float32)
        for i in range(dim):
            for s in (-1, 1):
                e = z.copy()
                e[i] = s * he[i]
                pts.append(e)  # face centres
                pts.append(e * 0.5)  # half-way to a face
        pts.append(he)  # corner
        pts.append(-he * 0.5)
        pts.append(np.full(dim, 0.1, np.float32))  # diagonal
        pts.append(np.full(dim, -0.01, np.float32))
        if kind == "thin_cuboid":
            # The local plane y = 0 of a thin ground, across |x| < 0.13.
            for x in (-0.12, -0.05, 0.0, 0.07, 0.13):
                p = z.copy()
                p[0] = x
                pts.append(p)
        # Points outside on the face planes' extensions (edges).
        e = he.copy()
        e[0] += 0.1
        pts.append(e)
    elif kind == "capsule":
        for y in (0.3, -0.3, 0.5, -0.5, 0.1):
            p = z.copy()
            p[1] = y
            pts.append(p)  # the axis, the end caps' centres and beyond
            q = p.copy()
            q[0] = 0.2
            pts.append(q)
    elif kind == "ball":
        pts.append(np.full(dim, 0.4 / np.sqrt(dim), np.float32))
    elif kind == "heightfield":
        xs = np.linspace(-2.0, 2.0, 9) if dim == 2 else np.linspace(-1.5, 1.5, 7)
        for x in xs:  # cell edges
            p = z.copy()
            p[0] = x
            p[1] = 0.3
            pts.append(p)
            if dim == 3:
                q = p.copy()
                q[2] = 0.5  # an edge in z too (nz = 5 over 2.0)
                pts.append(q)
        p = z.copy()
        p[0] = 5.0  # beyond the field (clamped cell)
        pts.append(p)
    else:
        pts.append(np.asarray((0.3, 1.0, -0.2)[:dim], np.float32))
    return np.stack(pts).astype(np.float32)


def _random_points(dim, n=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.2, 1.2, (n, dim)).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_sdf_and_normals_match_jax(kind, dim):
    pts = np.concatenate([_random_points(dim), _tie_points(kind, dim)])
    js, ts = _shape(jshapes, kind, dim), _shape(tshapes, kind, dim)
    d_j = np.asarray(js.sdf(pts))
    d_t = ts.sdf(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)
    n_j = np.asarray(jshapes.sdf_normal(js, pts))
    n_t = tshapes.sdf_normal(ts, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-6)


def test_zero_normals_match_jax():
    """Where JAX's gradient is the zero vector (the centre of a ball and a
    point on a capsule's axis), the port's normal is zero too."""
    for dim in (2, 3):
        z = np.zeros((1, dim), np.float32)
        for pkg_shape in (("ball", z), ("capsule", z)):
            kind, p = pkg_shape
            n_j = np.asarray(jshapes.sdf_normal(_shape(jshapes, kind, dim), p))
            n_t = tshapes.sdf_normal(_shape(tshapes, kind, dim),
                                     torch.from_numpy(p)).numpy()
            np.testing.assert_array_equal(n_t, n_j)
            assert not n_t.any()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_project_point_matches_jax(kind, dim):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-2.0, 2.0, (128, dim)).astype(np.float32)
    if dim == 2:
        a = 0.7
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                     np.float32)
    else:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    t = rng.uniform(-0.5, 0.5, dim).astype(np.float32)
    js, ts = _shape(jshapes, kind, dim), _shape(tshapes, kind, dim)
    pj, dj, nj = (np.asarray(v) for v in jshapes.project_point(js, pts, R, t))
    pt, dt, nt = (v.numpy() for v in tshapes.project_point(
        ts, torch.from_numpy(pts), torch.from_numpy(R), torch.from_numpy(t)))
    np.testing.assert_allclose(dt, dj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=2e-6)
    ws = tshapes.world_sdf(ts, torch.from_numpy(pts), torch.from_numpy(R),
                           torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(
        ws, np.asarray(jshapes.world_sdf(js, pts, R, t)), rtol=0, atol=2e-6)


SAMPLED = [
    ("ball", 2, 0.05), ("ball", 3, 0.05), ("cuboid", 2, 0.05),
    ("cuboid", 3, 0.05), ("thin_cuboid", 2, 0.0025),
    ("thin_cuboid", 3, 0.005), ("capsule", 2, 0.1), ("capsule", 3, 0.05),
    ("heightfield", 2, 0.1), ("heightfield", 3, 0.1),
]


@pytest.mark.parametrize("kind,dim,radius", SAMPLED)
def test_samples_equal_jax(kind, dim, radius):
    js, ts = _shape(jshapes, kind, dim), _shape(tshapes, kind, dim)
    surf_j = np.asarray(jsamp.shape_surface_sample(js, radius, dim))
    surf_t = tsamp.shape_surface_sample(ts, radius, dim)
    assert surf_t.dtype == np.float32 and len(surf_t) > 0
    np.testing.assert_array_equal(surf_t, surf_j)
    if kind == "heightfield":
        return
    vol_j = np.asarray(jsamp.shape_volume_sample(js, radius, dim))
    vol_t = tsamp.shape_volume_sample(ts, radius, dim)
    np.testing.assert_array_equal(vol_t, vol_j)


def test_scene_grounds_sample_equal_jax():
    """The two scene heightfields (basic2's cosine ground and
    heightfield3's sin/cos field, at heightfield3's r / 1.5) sample to
    the JAX package's point sets exactly."""
    from salva_tpu import scenes as jscenes
    from salva_tpu_torch import scenes as tscenes

    for fn, radius, dim in (("_cos_heightfield_2d", 0.1, 2),
                            ("_sincos_heightfield_3d", 0.1 / 1.5, 3)):
        j = getattr(jscenes, fn)()
        t = getattr(tscenes, fn)()
        assert t == tshapes.Heightfield(j.heights, j.extent, j.shape)
        np.testing.assert_array_equal(
            tsamp.shape_surface_sample(t, radius, dim),
            np.asarray(jsamp.shape_surface_sample(j, radius, dim)))


def test_unported_shapes_raise():
    """A shape of the JAX package is refused by name; the port's TriMesh
    answers (through its voxelized field) and samples (the native
    sampler)."""
    mesh = jshapes.TriMesh.from_arrays(np.eye(3), [[0, 1, 2]])
    with pytest.raises(NotImplementedError, match="TriMesh"):
        tshapes.sdf_normal(mesh, torch.zeros((1, 3)))
    with pytest.raises(NotImplementedError, match="TriMesh"):
        tsamp.shape_surface_sample(mesh, 0.05, 3)
    tet = tshapes.TriMesh.from_arrays(
        [[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.0, 0.0, 0.5],
         [0.0, 0.5, 0.0]], [[0, 1, 2], [0, 3, 1], [1, 3, 2], [2, 3, 0]])
    n = tshapes.sdf_normal(tet, torch.tensor([[0.0, -0.3, 0.0]]))
    assert float(n[0, 1]) < -0.9  # below the base: the normal points down
    assert len(tsamp.shape_surface_sample(tet, 0.05, 3)) > 20
    with pytest.raises(TypeError):  # no bounding box, as in JAX
        tsamp.shape_volume_sample(tshapes.HalfSpace((0.0, 1.0)), 0.05, 2)
