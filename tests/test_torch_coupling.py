"""Rigid-body coupling on the PyTorch port, against the JAX package on the
CPU, on both coupling paths (the host path: bodies in numpy; the device
path, ``device_coupling=True``: bodies, contacts and resampling as tensor
ops, forced here on the CPU).

The scenarios of ``tests/test_coupling.py``: static sampling tracks its
body (boundary particles follow the pose and carry the body's point
velocities), dynamic contact sampling depenetrates a fluid particle and
emits a boundary particle at its projection, and pressure feedback
(``transmit_forces``) pushes a submerged dynamic ball up. Each step of
both packages is held: fluid and boundary positions within 2e-6 m, body
translation, rotation and velocities within 1e-5, iterations identical,
contact counts exact. Also ``unregister_coupling``, a TriMesh collider
refused by name on either path, and a walled box (basic3's walls at a
tenth of their size) on the dense layout: its two coupling paths equal
to each other, and each held to the JAX package's on the same path.

The port writes the static samples at their poses before the first step
(``ColliderCouplingSet.presample``, ``DeviceColliderCoupling._freeze``),
because a coupled step sizes its dense layout from the boundary
particles it holds when it starts; the JAX package writes none there on
its host path and unposed ones on its device path, and drops contacts
at the first step. The tests that hold a dense coupled world to JAX
give JAX the same input (:func:`pose_static_samples`).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RADIUS = 0.05
POS_TOL = 2e-6
BODY_TOL = 1e-5


def _pkg(name):
    if name == "jax":
        import salva_tpu.coupling as coupling
        from salva_tpu import shapes
        from salva_tpu.sampling import shape_surface_sample
        from salva_tpu.world import Boundary, Fluid

        return coupling, shapes, shape_surface_sample, Boundary, Fluid, {}
    import salva_tpu_torch.coupling as coupling
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.world import Boundary, Fluid

    return (coupling, shapes, shape_surface_sample, Boundary, Fluid,
            {"device": "cpu"})


def _static_tracks(pkg, device_coupling):
    coupling, shapes, sample, Boundary, Fluid, kw = _pkg(pkg)
    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2,
                                  device_coupling=device_coupling, **kw)
    body = pip.bodies.add_body("dynamic", translation=(0.0, 1.0))
    shape = shapes.Ball(0.2)
    co = pip.bodies.add_collider(body, shape)
    bo = pip.liquid_world.add_boundary(Boundary(np.zeros((0, 2))))
    pip.coupling.register_coupling(
        bo, co, coupling.ColliderSampling.static_sampling(
            sample(shape, RADIUS, 2)))
    pip.bodies.bodies[body].linvel = np.array([1.0, 0.0], np.float32)
    pip.bodies.bodies[body].angvel = 0.5
    return pip, (0.0, 0.0), 0.1, bo


def _dynamic_emits(pkg, device_coupling):
    coupling, shapes, sample, Boundary, Fluid, kw = _pkg(pkg)
    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2,
                                  device_coupling=device_coupling, **kw)
    # Particles inside and above a box, moving further in.
    pts = np.array([[0.0, 0.45], [0.3, 0.48], [-0.4, 0.56], [0.9, 0.7]],
                   np.float32)
    vel = np.array([[0.0, -1.0], [0.2, -0.5], [0.0, 0.3], [0.0, -1.0]],
                   np.float32)
    pip.liquid_world.add_fluid(Fluid(pts, velocities=vel))
    body = pip.bodies.add_body("fixed")
    co = pip.bodies.add_collider(body, shapes.Cuboid((2.0, 0.5)))
    bo = pip.liquid_world.add_boundary(Boundary(np.zeros((0, 2))))
    pip.coupling.register_coupling(
        bo, co, coupling.ColliderSampling.dynamic_contact_sampling(
            max_samples=16))
    return pip, (0.0, 0.0), 1.0 / 200.0, bo


def _block():
    xs = np.arange(-0.5, 0.5, 2 * RADIUS)
    ys = np.arange(0.0, 0.6, 2 * RADIUS)
    g = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=-1).reshape(-1, 2)
    return g.astype(np.float32)


def _transmit(pkg, device_coupling):
    """tests/test_coupling.py's buoyant ball: fluid excavated around it,
    ball density 400."""
    coupling, shapes, sample, Boundary, Fluid, kw = _pkg(pkg)
    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2,
                                  device_coupling=device_coupling, **kw)
    pos = _block()
    center = np.array([0.0, 0.3], np.float32)
    keep = np.linalg.norm(pos - center, axis=1) > 0.1 + 2 * RADIUS
    pip.liquid_world.add_fluid(Fluid(pos[keep], density0=1000.0))
    xs = np.arange(-0.6, 0.6, 2 * RADIUS)
    floor = np.stack([xs, np.full(len(xs), -2 * RADIUS)], -1)
    pip.liquid_world.add_boundary(Boundary(floor.astype(np.float32)))
    body = pip.bodies.add_body("dynamic", translation=tuple(center))
    shape = shapes.Ball(0.1)
    co = pip.bodies.add_collider(body, shape, density=400.0)
    bo = pip.liquid_world.add_boundary(Boundary(np.zeros((0, 2))))
    pip.coupling.register_coupling(
        bo, co, coupling.ColliderSampling.static_sampling(
            sample(shape, RADIUS, 2)))
    return pip, (0.0, -9.81), 1.0 / 200.0, bo


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hold(pj, pt, bo, step):
    wj, wt = pj.liquid_world, pt.liquid_world
    for h in range(wj.num_fluids):
        np.testing.assert_allclose(wt.fluid_positions(h),
                                   wj.fluid_positions(h), rtol=0,
                                   atol=POS_TOL, err_msg=f"step {step}")
        np.testing.assert_allclose(wt.fluid_velocities(h),
                                   wj.fluid_velocities(h), rtol=0,
                                   atol=10 * POS_TOL, err_msg=f"step {step}")
    aj = _np(wj.boundaries_state.alive)
    at = _np(wt.boundaries_state.alive)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(_np(wt.boundaries_state.positions)[at],
                               _np(wj.boundaries_state.positions)[aj],
                               rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(_np(wt.boundaries_state.velocities)[at],
                               _np(wj.boundaries_state.velocities)[aj],
                               rtol=0, atol=BODY_TOL)
    dj, dt_ = wj.last_diagnostics, wt.last_diagnostics
    assert (dt_.solver.pressure_iters, dt_.solver.divergence_iters) == (
        int(dj.solver.pressure_iters), int(dj.solver.divergence_iters))
    assert (int(dt_.ncontacts_ff), int(dt_.ncontacts_fb)) == (
        int(dj.ncontacts_ff), int(dj.ncontacts_fb))
    for bj, bt in zip(pj.sync_bodies().bodies, pt.sync_bodies().bodies):
        for attr in ("translation", "rotation", "linvel", "angvel"):
            np.testing.assert_allclose(
                np.atleast_1d(getattr(bt, attr)),
                np.atleast_1d(getattr(bj, attr)), rtol=0, atol=BODY_TOL,
                err_msg=f"step {step} {attr}")


SCENARIOS = {"static_tracks": (_static_tracks, 1),
             "dynamic_emits": (_dynamic_emits, 2),
             "transmit": (_transmit, 3)}


@pytest.mark.parametrize("device_coupling", [False, True],
                         ids=["host", "device"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_coupling_matches_jax(name, device_coupling):
    build, steps = SCENARIOS[name]
    pj, g, dt, bo = build("jax", device_coupling)
    pt, _, _, _ = build("torch", device_coupling)
    assert pt.device_coupling == device_coupling
    wt = pt.liquid_world
    for step in range(steps):
        pj.step(g, dt)
        pt.step(g, dt)
        _hold(pj, pt, bo, step)
        if name == "transmit" and step == 0:
            # One step in, the net pressure feedback on the buoyant ball
            # points up and holds it above free fall.
            f = wt.boundary_forces(bo)
            assert f.sum(axis=0)[1] > 0.0, f.sum(axis=0)
            body = pt.sync_bodies().bodies[-1]
            assert body.linvel[1] > -9.81 / 200.0, body.linvel
    body = pt.sync_bodies().bodies[-1]
    if name == "static_tracks":
        pts = wt.boundary_positions(bo)
        # Moved 1.0 * 0.1 in x before resampling.
        assert abs(pts[:, 0].mean() - 0.1) < 1e-5
        assert abs(pts[:, 1].mean() - 1.0) < 1e-5
        assert abs(body.translation[0] - 0.1) < 1e-5
    elif name == "dynamic_emits":
        pos = wt.fluid_positions(0)
        assert pos[0, 1] >= 0.5 - 1e-5  # pushed out of the box
        alive = _np(wt.boundaries_state.alive)[wt._boundary_slot_owner == bo]
        assert alive.sum() > 0  # projections emitted
    else:
        assert np.isfinite(wt.boundary_forces(bo)).all()
        assert abs(body.linvel[1]) < 5.0, body.linvel


def test_default_path_follows_the_device(monkeypatch):
    """A CPU world takes the host path by default; a CUDA world the
    device path (checked without a card: only the choice is read)."""
    import salva_tpu_torch.coupling as coupling

    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2, device="cpu")
    assert not pip.device_coupling
    pip.liquid_world.device = torch.device("cuda")
    assert pip.device_coupling
    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2, device="cpu",
                                  device_coupling=True)
    assert pip.device_coupling


def test_unregister_coupling():
    coupling, shapes, _, Boundary, _, kw = _pkg("torch")
    pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=2, **kw)
    body = pip.bodies.add_body("fixed")
    co = pip.bodies.add_collider(body, shapes.Ball(0.2))
    bo = pip.liquid_world.add_boundary(Boundary(np.zeros((0, 2))))
    pip.coupling.register_coupling(
        bo, co, coupling.ColliderSampling.static_sampling(
            np.zeros((4, 2), np.float32)))
    assert pip.coupling.unregister_coupling(co) == bo
    assert pip.coupling.unregister_coupling(co) is None


@pytest.mark.parametrize("device_coupling", [False, True],
                         ids=["host", "device"])
def test_trimesh_collider_is_refused(device_coupling):
    """A collider of the JAX package's TriMesh class is refused by name;
    the port's own TriMesh couples on either path (its voxelized field
    pushes a particle placed inside the mesh out)."""
    from salva_tpu.shapes import TriMesh as JaxTriMesh
    from test_voxelize import cube_mesh

    coupling, shapes, _, Boundary, Fluid, kw = _pkg("torch")
    cube = cube_mesh()
    for mesh in (JaxTriMesh.from_arrays(np.eye(3), [[0, 1, 2]]),
                 shapes.TriMesh(cube.vertices, cube.indices)):
        pip = coupling.FluidsPipeline(RADIUS, 2.0, dim=3,
                                      device_coupling=device_coupling, **kw)
        fl = pip.liquid_world.add_fluid(
            Fluid(np.float32([[0.0, 0.45, 0.0]])))
        body = pip.bodies.add_body("fixed")
        co = pip.bodies.add_collider(body, mesh)
        bo = pip.liquid_world.add_boundary(Boundary(np.zeros((0, 3))))
        pip.coupling.register_coupling(
            bo, co, coupling.ColliderSampling.dynamic_contact_sampling())
        if isinstance(mesh, JaxTriMesh):
            with pytest.raises(NotImplementedError, match="TriMesh"):
                pip.step((0.0, -9.81, 0.0), 0.01)
            continue
        pip.step((0.0, -9.81, 0.0), 0.01)
        (y,) = pip.liquid_world.fluid_positions(fl)[:, 1]
        assert y > 0.5 - RADIUS, y  # out of the cube (half-extent 0.5)
        assert int(pip.liquid_world.boundaries_state.alive.sum()) == 1


def pose_static_samples(pip):
    """Give a JAX pipeline the port's first-step input: every static
    sample written at its collider's pose before the first step, as the
    port writes it (``ColliderCouplingSet.presample`` on the host path,
    ``DeviceColliderCoupling._freeze`` on the device path). A coupled
    step sizes its dense layout from the boundary particles the world
    holds when it starts; the JAX package holds none there on its host
    path and the unposed samples on its device path. On the device path
    the coupling is frozen first (its slot blocks stay; the posed points
    overwrite the unposed ones in place), with zero velocities as the
    port's freeze writes them."""
    device = bool(pip._device_request)
    if device:
        pip._maybe_device()
    rw = pip.bodies
    for e in pip.coupling.entries.values():
        if e.sampling.kind != "static":
            continue
        R, t = rw.collider_pose(e.collider)
        pts = e.sampling.points @ R.T + t
        vel = None if device else rw.body_of_collider(
            e.collider).velocities_at_points(pts)
        pip.liquid_world.set_boundary_particles(e.boundary, pts, vel)


def _walled_box(pkg, device_coupling):
    """basic3's construction at a tenth of its size: a fixed ground
    cuboid and four static-sampled walls around a 6^3 block, in a small
    domain (the dense layout's grid stays small on the CPU)."""
    coupling, shapes, _, _, Fluid, kw = _pkg(pkg)
    if pkg == "jax":
        from salva_tpu import scenes
    else:
        from salva_tpu_torch import scenes

    r = RADIUS
    pip = coupling.FluidsPipeline(
        r, 2.0, dim=3, layout="dense", fit_grid=False,
        domain=((-0.7, -0.3, -0.7), (0.7, 1.0, 0.7)),
        device_coupling=device_coupling, **kw)
    pos = scenes.cube_fluid((6, 6, 6), r)
    pos[:, 1] += 0.1 + 6 * r
    pip.liquid_world.add_fluid(Fluid(pos))
    ground = pip.bodies.add_body("fixed")
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                   np.float32)
    wall = shapes.Cuboid((0.1, 0.3, 0.5))
    for tr, R in (((0.0, 0.3, 0.5), rot), ((0.0, 0.3, -0.5), rot),
                  ((0.5, 0.3, 0.0), None), ((-0.5, 0.3, 0.0), None)):
        scenes._register_static(pip, ground, wall, r, tr, R)
    scenes._register_static(pip, ground, shapes.Cuboid((0.5, 0.1, 0.5)), r)
    return pip


def _dense_record(world):
    d = world.last_diagnostics
    return (d.solver.pressure_iters, d.solver.divergence_iters,
            int(d.ncontacts_ff), int(d.ncontacts_fb),
            int(d.neighbor_overflow), world._auto_caps,
            world._fb_cols_cache)


def test_host_and_device_paths_agree_on_the_dense_layout():
    """A walled box on the dense layout, 3 steps on each coupling path:
    identical iterations, contact counts, resolved caps and fb table, and
    positions (the walls are fixed, so the two paths write the same
    boundary particles; both write them before the first step, which
    sizes the dense layout from them: no overflow, where a first step
    sized for no boundary drops contacts at the walls' corners)."""
    runs = {}
    for device_coupling in (True, False):
        pip = _walled_box("torch", device_coupling)
        assert pip.device_coupling == device_coupling
        w = pip.liquid_world
        rec = []
        for _ in range(3):
            pip.step((0.0, -9.81, 0.0), 1.0 / 200.0)
            rec.append(_dense_record(w))
        runs[device_coupling] = (rec, w.fluid_positions(0))
    assert runs[True][0] == runs[False][0]
    assert not any(r[4] for r in runs[True][0])  # no overflow
    assert runs[True][0][0][5][1] > 8  # the boundary cap the walls need
    np.testing.assert_array_equal(runs[True][1], runs[False][1])


@pytest.mark.parametrize("device_coupling", [False, True],
                         ids=["host", "device"])
def test_walled_box_matches_jax(device_coupling):
    """The walled box on the dense layout against the JAX package on the
    same coupling path, its static samples posed before the first step
    (:func:`pose_static_samples`): 3 steps, each held by ``_hold``, with
    the same resolved caps and fb table and no overflow."""
    pj = _walled_box("jax", device_coupling)
    pt = _walled_box("torch", device_coupling)
    pose_static_samples(pj)
    for step in range(3):
        pj.step((0.0, -9.81, 0.0), 1.0 / 200.0)
        pt.step((0.0, -9.81, 0.0), 1.0 / 200.0)
        _hold(pj, pt, None, step)
        rj, rt = (_dense_record(p.liquid_world) for p in (pj, pt))
        assert rt[4:] == rj[4:] == (0, rj[5], rj[6]), (rt, rj)
