"""The rigid-body engine of the PyTorch port's coupling, against the JAX
package on the CPU.

- The host engine (``coupling.rigid_body``, numpy with its shape queries
  on CPU tensors) steps the scenarios of ``tests/test_coupling.py`` —
  bodies resting on a floor, two boxes stacking, a friction slide, a
  dynamic-dynamic collision — beside the JAX package's engine: body
  translation, rotation and linear / angular velocity within 1e-5 on
  every step through the first contacts (the boxes stay above the
  floor); the port alone then runs the slide and the collision to the
  end and holds the JAX suite's claims on them.
- The device rigid step (``DeviceColliderCoupling._rigid_step_dev``:
  contacts, the sequential-impulse solve, integration, the position
  projection) forced on the CPU, against JAX's, on a fixture whose
  contacts tie in depth (a box resting flat, a box on a box, a ball on a
  capsule): the projection's first-index tie-break decides which contact
  pushes each body. Body state within 1e-5, contact tables equal.
"""

import numpy as np
import pytest
import torch

from salva_tpu import shapes as jshapes
from salva_tpu.coupling.rigid_body import RigidBodyWorld as JWorld
from salva_tpu_torch import shapes as tshapes
from salva_tpu_torch.coupling.rigid_body import RigidBodyWorld as TWorld

torch.set_num_threads(1)

TOL = 1e-5


def _resting(world, shapes):
    ground = world.add_body("fixed", translation=(0.0, -0.1, 0.0))
    world.add_collider(ground, shapes.Cuboid((2.0, 0.1, 2.0)))
    rad = 0.2
    cube = world.add_body("dynamic", translation=(0.0, 1.0, 0.0))
    world.add_collider(cube, shapes.Cuboid((rad, rad, rad)), density=800.0)
    ball = world.add_body("dynamic", translation=(1.0, 1.5, 0.0))
    world.add_collider(ball, shapes.Ball(rad), density=800.0)
    return (0.0, -9.81, 0.0), 1.0 / 100.0


def _stacking(world, shapes):
    ground = world.add_body("fixed", translation=(0.0, -0.1, 0.0))
    world.add_collider(ground, shapes.Cuboid((2.0, 0.1, 2.0)))
    rad = 0.2
    lower = world.add_body("dynamic", translation=(0.0, 0.35, 0.0))
    world.add_collider(lower, shapes.Cuboid((rad, rad, rad)), density=800.0)
    upper = world.add_body("dynamic", translation=(0.02, 1.0, 0.0))
    world.add_collider(upper, shapes.Cuboid((rad, rad, rad)), density=800.0)
    return (0.0, -9.81, 0.0), 1.0 / 100.0


def _friction(world, shapes):
    ground = world.add_body("fixed", translation=(0.0, -0.1))
    world.add_collider(ground, shapes.Cuboid((10.0, 0.1)))
    box = world.add_body("dynamic", translation=(0.0, 0.2))
    world.add_collider(box, shapes.Cuboid((0.2, 0.2)), density=800.0)
    world.bodies[box].linvel = np.array([2.0, 0.0], np.float32)
    return (0.0, -9.81), 1.0 / 100.0


def _momentum(world, shapes):
    world.friction = 0.0
    a = world.add_body("dynamic", translation=(-0.5, 0.0))
    world.add_collider(a, shapes.Cuboid((0.2, 0.2)), density=1000.0)
    b = world.add_body("dynamic", translation=(0.5, 0.0))
    world.add_collider(b, shapes.Cuboid((0.2, 0.2)), density=1000.0)
    world.bodies[a].linvel = np.array([2.0, 0.0], np.float32)
    return (0.0, 0.0), 1.0 / 200.0


# (builder, dim, steps held against JAX, steps of the port's own run;
# the JAX side's shape queries retrace every call, ~0.3 s a step)
SCENARIOS = {
    "resting": (_resting, 3, 55, 55),
    "stacking": (_stacking, 3, 45, 45),
    "friction": (_friction, 2, 30, 300),
    "momentum": (_momentum, 2, 70, 120),
}


def _body_gap(a, b):
    return max(
        float(np.abs(a.translation - b.translation).max()),
        float(np.abs(a.rotation - b.rotation).max()),
        float(np.abs(a.linvel - b.linvel).max()),
        float(np.abs(np.atleast_1d(a.angvel) - np.atleast_1d(b.angvel)).max()),
    )


def _claims(name, world):
    """The physical claims of tests/test_coupling.py's twin scenarios
    (for the two drops, at the end of the held steps: no body fell
    through the floor or into the other)."""
    rad = 0.2
    if name == "resting":
        for b in world.bodies[1:]:
            assert b.translation[1] > 0.5 * rad, b.translation
    elif name == "stacking":
        lo, up = world.bodies[1], world.bodies[2]
        assert lo.translation[1] > 0.5 * rad, lo.translation
        assert up.translation[1] - lo.translation[1] > 1.5 * rad
    elif name == "friction":
        b = world.bodies[1]
        assert abs(b.linvel[0]) < 0.05 and b.translation[1] > 0.05
    else:
        ba, bb = world.bodies
        p1 = ba.mass * ba.linvel[0] + bb.mass * bb.linvel[0]
        p0 = ba.mass * 2.0
        assert abs(p1 - p0) < 0.05 * abs(p0), (p0, p1)
        assert bb.translation[0] > 0.5, bb.translation


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_host_engine_matches_jax(name):
    build, dim, held, total = SCENARIOS[name]
    jw, tw = JWorld(dim), TWorld(dim)
    g, dt = build(jw, jshapes)
    build(tw, tshapes)
    for b_j, b_t in zip(jw.bodies, tw.bodies):
        assert b_j.mass == b_t.mass
        np.testing.assert_array_equal(b_j.inertia, b_t.inertia)
    contacts = 0
    for i in range(held):
        contacts += len(tw._find_contacts())
        jw.step(dt, g)
        tw.step(dt, g)
        for b_j, b_t in zip(jw.bodies, tw.bodies):
            assert _body_gap(b_j, b_t) < TOL, (i, b_j.translation,
                                               b_t.translation)
    assert contacts > 0  # the held steps reach the contacts
    for _ in range(total - held):
        tw.step(dt, g)
    _claims(name, tw)


# -- the device rigid step, forced on the CPU ------------------------------


def _tie_fixture(pkg, shapes, dim):
    """Bodies in contact whose contact depths tie: a box resting flat and
    slightly sunk into the floor, a second box sunk into the first, and
    (2D) a ball on a capsule, all dynamic over a fixed floor."""
    kw = dict(device="cpu") if pkg.__name__.startswith("salva_tpu_torch") \
        else {}
    pip = pkg.FluidsPipeline(0.05, 2.0, dim=dim, device_coupling=True, **kw)
    bodies = pip.bodies
    if dim == 3:
        ground = bodies.add_body("fixed", translation=(0.0, -0.1, 0.0))
        bodies.add_collider(ground, shapes.Cuboid((2.0, 0.1, 2.0)))
        lo = bodies.add_body("dynamic", translation=(0.0, 0.19, 0.0))
        bodies.add_collider(lo, shapes.Cuboid((0.2, 0.2, 0.2)),
                            density=800.0)
        up = bodies.add_body("dynamic", translation=(0.0, 0.58, 0.0))
        bodies.add_collider(up, shapes.Cuboid((0.2, 0.2, 0.2)),
                            density=800.0)
        bodies.bodies[up].linvel = np.array([0.1, -0.5, 0.0], np.float32)
    else:
        ground = bodies.add_body("fixed", translation=(0.0, -0.1))
        bodies.add_collider(ground, shapes.Cuboid((3.0, 0.1)))
        box = bodies.add_body("dynamic", translation=(-1.0, 0.19))
        bodies.add_collider(box, shapes.Cuboid((0.2, 0.2)), density=800.0)
        cap = bodies.add_body("dynamic", translation=(1.0, 0.29))
        bodies.add_collider(cap, shapes.Capsule(0.1, 0.2), density=800.0)
        ball = bodies.add_body("dynamic", translation=(1.0, 0.78))
        bodies.add_collider(ball, shapes.Ball(0.2), density=800.0)
        bodies.bodies[ball].linvel = np.array([0.0, -1.0], np.float32)
        bodies.bodies[box].angvel = 0.3
    return pip


def _rigid_state(rs):
    return [np.asarray(t, np.float32) if not hasattr(t, "numpy")
            else t.numpy() for t in rs[:4]]


@pytest.mark.parametrize("dim", [2, 3])
def test_device_rigid_step_matches_jax(dim):
    import jax.numpy as jnp

    import salva_tpu.coupling as jcoupling
    import salva_tpu_torch.coupling as tcoupling

    pj = _tie_fixture(jcoupling, jshapes, dim)
    pt = _tie_fixture(tcoupling, tshapes, dim)
    dj, dt_ = pj._maybe_device(), pt._maybe_device()
    g = (0.0, -9.81, 0.0)[:dim]
    rs_j, rs_t = dj.rigid_state, dt_.rigid_state
    for a, b in zip(_rigid_state(rs_j), _rigid_state(rs_t)):
        np.testing.assert_array_equal(b, a)
    # The contact table at the first state: equal rows, depths tied.
    con_j = dj._find_contacts_dev(rs_j, 0.0)
    con_t = dt_._find_contacts_dev(rs_t, 0.0)
    n = int(con_j["count"])
    assert int(con_t["count"]) == n > 4
    for key in ("a", "b"):
        np.testing.assert_array_equal(con_t[key].numpy()[:n],
                                      np.asarray(con_j[key])[:n])
    for key in ("p", "n", "depth"):
        np.testing.assert_allclose(con_t[key].numpy()[:n],
                                   np.asarray(con_j[key])[:n], atol=2e-6)
    depth = np.asarray(con_j["depth"])[:n]
    assert len(np.unique(depth)) < n  # ties the projection must break
    dtime = 1.0 / 100.0
    for step in range(3):
        rs_j = dj._rigid_step_dev(rs_j, jnp.float32(dtime),
                                  jnp.asarray(g, jnp.float32))
        rs_t = dt_._rigid_step_dev(rs_t, dtime, torch.tensor(g))
        for a, b in zip(_rigid_state(rs_j), _rigid_state(rs_t)):
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL,
                                       err_msg=f"step {step}")
    # The projection's per-body push: one contact per body, the first of
    # the deepest, on both sides.
    pr_j = dj._project_positions_dev(rs_j)
    pr_t = dt_._project_positions_dev(rs_t)
    np.testing.assert_allclose(pr_t.trans.numpy(), np.asarray(pr_j.trans),
                               rtol=0, atol=TOL)


def test_solve_contacts_runs_plain_on_the_cpu_and_checks_operands():
    """On CPU tensors the wrapper runs the plain version (no launch);
    operands of the wrong type or shape are refused."""
    import salva_tpu_torch.coupling as tcoupling
    from salva_tpu_torch.ops import rigid

    pip = _tie_fixture(tcoupling, tshapes, 2)
    dev = pip._maybe_device()
    rs = dev.rigid_state
    con = dev._find_contacts_dev(rs, 0.0)
    args = (rs.trans, rs.rot, rs.linvel, rs.angvel, dev.inv_mass,
            dev.inv_inertia, con["a"], con["b"], con["p"], con["n"],
            con["count"])
    rigid.reset_launches()
    lin, ang = rigid.solve_contacts(*args, 0.0, 0.5, 8)
    plin, pang = rigid.solve_contacts_plain(*args, 0.0, 0.5, 8)
    assert torch.equal(lin, plin) and torch.equal(ang, pang)
    assert rigid.LAUNCHES["rigid_solve"] == 0
    with pytest.raises(TypeError):
        rigid.solve_contacts(*args[:6], con["a"].long(), *args[7:], 0.0,
                             0.5, 8)
    with pytest.raises(ValueError):
        rigid.solve_contacts(*args[:8], con["p"][:-1], *args[9:], 0.0,
                             0.5, 8)
