"""The port's slab step against the JAX package's sharded step.

``salva_tpu_torch.parallel.build_sharded_step_fn`` on 8 slabs
(``LocalHalos``) against ``salva_tpu.parallel.domain.
get_jitted_sharded_step_fn`` on the virtual 8-device CPU mesh, both with
replicated binning, on ``tests/test_domain.py``'s world (a 6^3 block
above a sampled floor in its domain), its forces and solvers, for its
steps. Held at its bounds: positions 1e-5, velocities 1e-4, boundary
forces 5e-3, identical iteration and contact counts at the last step,
no overflow. The DFSPH viscosity runs one iteration (ROADMAP Queue 3,
item 15).

Then the sharded-binning step (``sharded_binning=True``, particle
migration) against JAX's on the same mesh, on
``test_sharded_binning_matches_replicated``'s world and on the
elasticity world of ``test_sharded_binning_elasticity_matches_single_
device``, 5 steps each: the same bounds, identical iterations, contacts
and ``candidate_overflow`` (the send overflow included) at the last
step.

``slow``: the JAX side compiles an 8-device ``shard_map`` program per
case, minutes each on a CPU (``tests/test_domain.py:44-48``); the
port's plain folds over the full domain take ~12 s a step.
"""

import numpy as np
import pytest
import torch

from salva_tpu_torch.object.state import state_from_numpy

pytestmark = [pytest.mark.slow]

torch.set_num_threads(1)

RADIUS = 0.05
DT = 1.0 / 200.0
N_DEV = 8

CASES = {
    "pressure-only": ("dfsph", (), 5),
    "xsph": ("dfsph", (("XSPHViscosity", (0.5, 0.5)),), 5),
    "akinci": ("dfsph", (("Akinci2013SurfaceTension", (1.0, 0.5)),), 5),
    "he2014": ("dfsph", (("He2014SurfaceTension", (1.0, 0.5)),), 5),
    "iisph": ("iisph", (), 5),
    "iisph-akinci": ("iisph",
                     (("Akinci2013SurfaceTension", (1.0, 0.5)),), 5),
    "dfsph-viscosity": ("dfsph", (("DFSPHViscosity", (0.05, 1, 1)),), 3),
}


# The sharded-binning (migration) step against JAX's on the same mesh:
# test_sharded_binning_matches_replicated's world and the elasticity
# world of test_sharded_binning_elasticity_matches_single_device, 5
# steps each (tests/test_domain.py:179-297).
MIGRATE_CASES = {
    "pressure-only": ("dfsph", (), 5),
    "elasticity": ("dfsph", (("Becker2009Elasticity",
                              (50_000.0, 0.3, True)),), 5),
}


def _world(pkg, case, cases=CASES):
    """tests/test_domain.py's ``_world_3d`` in package ``pkg``."""
    import importlib

    solver, np_forces, _ = cases[case]
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    cfg = mod("config")
    forces = mod("forces")
    kw = dict(device="cpu") if pkg == "salva_tpu_torch" else dict(
        neighbors=cfg.NeighborConfig(max_neighbors=48, max_candidates=192,
                                     query_chunk=16384))
    world = mod("world").LiquidWorld(
        solver=cfg.DFSPHConfig() if solver == "dfsph" else cfg.IISPHConfig(),
        particle_radius=RADIUS, dim=3,
        domain=((-1.2, -0.5, -1.2), (1.2, 1.6, 1.2)), layout="dense", **kw)
    pos = mod("scenes").cube_fluid((6, 6, 6), RADIUS)
    pos[:, 1] += 0.45
    world.add_fluid(mod("world").Fluid(
        pos, density0=1000.0,
        nonpressure_forces=[getattr(forces, n)(*a) for n, a in np_forces]))
    world.add_boundary(mod("world").Boundary(mod("sampling").
                                             shape_surface_sample(
        mod("shapes").Cuboid((1.0, 0.1, 1.0)), RADIUS, 3)))
    world._prepare()
    return world


@pytest.mark.parametrize("case", list(CASES))
def test_slab_step_matches_jax_sharded_step(case):
    import jax.numpy as jnp
    from salva_tpu.parallel import make_mesh
    from salva_tpu.parallel.domain import get_jitted_sharded_step_fn

    from salva_tpu_torch.parallel import LocalHalos, build_sharded_step_fn

    steps = CASES[case][2]
    wj = _world("salva_tpu", case)
    jstep = get_jitted_sharded_step_fn(
        wj.sim, wj.solver_config, wj._force_set, 1,
        make_mesh(N_DEV, axis_name="x"))
    fl, bd, ss = wj.fluids_state, wj.boundaries_state, wj._solver_state
    for _ in range(steps):
        fl, bd, ss, dj = jstep(fl, bd, ss, None, jnp.float32(DT),
                               jnp.asarray([0.0, -9.81, 0.0], jnp.float32))

    wt = _world("salva_tpu_torch", case)
    # The same initial state, through numpy.
    for name in ("fluids_state", "boundaries_state"):
        src = getattr(wj, name)
        setattr(wt, name, state_from_numpy(
            {f: np.asarray(getattr(src, f))
             for f in src.__dataclass_fields__}, device="cpu"))
    sim = wt._boundary_volume_mode(wt._effective_sim(), None)
    tstep = build_sharded_step_fn(sim, wt.solver_config, wt._force_set, 1,
                                  LocalHalos(N_DEV))
    tf, tb, ts = wt.fluids_state, wt.boundaries_state, wt._solver_state
    g = torch.tensor([0.0, -9.81, 0.0])
    for _ in range(steps):
        tf, tb, ts, dt_ = tstep(tf, tb, ts, None, DT, g)

    np.testing.assert_allclose(tf.positions.numpy(),
                               np.asarray(fl.positions), atol=1e-5)
    np.testing.assert_allclose(tf.velocities.numpy(),
                               np.asarray(fl.velocities), atol=1e-4)
    np.testing.assert_allclose(tb.forces.numpy(), np.asarray(bd.forces),
                               atol=5e-3)
    assert dt_.solver.pressure_iters == int(dj.solver.pressure_iters)
    assert dt_.solver.divergence_iters == int(dj.solver.divergence_iters)
    assert int(dt_.ncontacts_ff) == int(dj.ncontacts_ff)
    assert int(dt_.ncontacts_fb) == int(dj.ncontacts_fb)
    assert int(dt_.neighbor_overflow) == int(dj.neighbor_overflow) == 0


@pytest.mark.parametrize("case", list(MIGRATE_CASES))
def test_migrated_step_matches_jax_sharded_binning(case):
    import jax.numpy as jnp
    from salva_tpu.parallel import make_mesh
    from salva_tpu.parallel.domain import get_jitted_sharded_step_fn

    from salva_tpu_torch.parallel import LocalHalos, build_sharded_step_fn

    steps = MIGRATE_CASES[case][2]
    wj = _world("salva_tpu", case, MIGRATE_CASES)
    jstep = get_jitted_sharded_step_fn(
        wj.sim, wj.solver_config, wj._force_set, 1,
        make_mesh(N_DEV, axis_name="x"), sharded_binning=True)
    fl, bd, ss = wj.fluids_state, wj.boundaries_state, wj._solver_state
    for _ in range(steps):
        fl, bd, ss, dj = jstep(fl, bd, ss, wj._elasticity_state,
                               jnp.float32(DT),
                               jnp.asarray([0.0, -9.81, 0.0], jnp.float32))

    wt = _world("salva_tpu_torch", case, MIGRATE_CASES)
    for name in ("fluids_state", "boundaries_state"):
        src = getattr(wj, name)
        setattr(wt, name, state_from_numpy(
            {f: np.asarray(getattr(src, f))
             for f in src.__dataclass_fields__}, device="cpu"))
    sim = wt._boundary_volume_mode(wt._effective_sim(), None)
    tstep = build_sharded_step_fn(sim, wt.solver_config, wt._force_set, 1,
                                  LocalHalos(N_DEV), sharded_binning=True)
    tf, tb, ts = wt.fluids_state, wt.boundaries_state, wt._solver_state
    g = torch.tensor([0.0, -9.81, 0.0])
    for _ in range(steps):
        tf, tb, ts, dt_ = tstep(tf, tb, ts, wt._elasticity_state, DT, g)

    np.testing.assert_allclose(tf.positions.numpy(),
                               np.asarray(fl.positions), atol=1e-5)
    np.testing.assert_allclose(tf.velocities.numpy(),
                               np.asarray(fl.velocities), atol=1e-4)
    np.testing.assert_allclose(tb.forces.numpy(), np.asarray(bd.forces),
                               atol=5e-3)
    assert dt_.solver.pressure_iters == int(dj.solver.pressure_iters)
    assert dt_.solver.divergence_iters == int(dj.solver.divergence_iters)
    assert int(dt_.ncontacts_ff) == int(dj.ncontacts_ff)
    assert int(dt_.ncontacts_fb) == int(dj.ncontacts_fb)
    assert int(dt_.neighbor_overflow) == int(dj.neighbor_overflow) == 0
    assert int(dt_.candidate_overflow) == int(dj.candidate_overflow) == 0
