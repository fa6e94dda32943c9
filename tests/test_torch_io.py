"""``.npz`` checkpoints of the PyTorch port (``salva_tpu_torch.io``),
against the JAX package's format on the CPU.

- The file: a world built the same way in both packages and saved before
  its first step writes the same arrays (names, dtypes, values) and the
  same ``meta`` document; the port adds only ``host_state``.
- Resume: a world saved mid-run and loaded resumes bit for bit (the 2D
  gather world of ``tests/test_io.py``, and the 7^3 dense dam break with
  auto caps, adaptive substepping and debug checks, whose layout state
  comes back from ``host_state``).
- Cross-load: a file saved by either package loads in the other, and the
  two packages' loaded worlds step within 2e-6 m of each other with
  identical iterations (gather and dense layouts).
- Records: the config and force descriptors survive; a legacy snapshot
  without per-fluid radii falls back to the world radius; a legacy DFSPH
  solver state (velocity changes only) is zero-padded as the JAX package
  pads it; ``CustomForce`` instances warn at save; an elastic fluid's rest
  state is rebuilt after load.
"""

import json

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import forces as tforces
from salva_tpu_torch.io import load_world, save_world

torch.set_num_threads(1)

RADIUS = 0.05
POS_ATOL = 2e-6
NB = dict(max_neighbors=40, max_candidates=128, query_chunk=4096)
DT = 1.0 / 200.0
G2 = (0.0, -9.81)


def _cube(n, origin):
    xs = np.arange(n) * 2.0 * RADIUS
    g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    return (g + np.asarray(origin)).astype(np.float32)


def _floor():
    xs = np.arange(-1.0, 1.0, 2 * RADIUS, dtype=np.float32)
    return np.stack([xs, np.full_like(xs, -2 * RADIUS)], axis=-1)


def _world(pkg, layout="gather"):
    """tests/test_io.py's world (a 6x6 block with XSPH over a floor) in
    either package; ``layout="dense"`` puts it in test_io's domain."""
    dense = layout == "dense"
    kw = dict(domain=((-1.0, -0.2), (1.0, 1.5)), layout="dense") \
        if dense else {}
    if pkg == "jax":
        from salva_tpu import forces
        from salva_tpu.config import DFSPHConfig, NeighborConfig
        from salva_tpu.world import Boundary, Fluid, LiquidWorld

        w = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=2,
                        neighbors=NeighborConfig(**NB), **kw)
        if dense:
            w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                                  dense_compact=False)
    else:
        forces, Boundary, Fluid = tforces, st.Boundary, st.Fluid
        w = st.LiquidWorld(particle_radius=RADIUS, dim=2,
                           neighbors=st.NeighborConfig(**NB), device="cpu",
                           **kw)
    w.add_fluid(Fluid(_cube(6, (-0.3, 0.02 if not dense else 0.1)),
                      density0=1000.0,
                      nonpressure_forces=[forces.XSPHViscosity(0.5, 0.0)]))
    w.add_boundary(Boundary(_floor()))
    return w


def _iters(w):
    s = w.last_diagnostics.solver
    return int(s.pressure_iters), int(s.divergence_iters)


def test_file_matches_the_jax_format(tmp_path):
    from salva_tpu.io import save_world as jax_save

    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jax_save(_world("jax"), jpath)
    save_world(_world("torch"), tpath)
    jd, td = np.load(jpath), np.load(tpath)
    assert sorted(td.files) == sorted(jd.files + ["host_state"])
    for name in jd.files:
        assert td[name].dtype == jd[name].dtype, name
        if name != "meta":
            np.testing.assert_array_equal(td[name], jd[name], err_msg=name)
    assert json.loads(bytes(td["meta"]).decode()) == json.loads(
        bytes(jd["meta"]).decode())
    assert td["f_alive"].dtype == np.bool_
    assert td["f_fluid_id"].dtype == td["b_boundary_id"].dtype == np.int32
    assert td["f_memberships"].dtype == np.uint32


@pytest.mark.parametrize("case", ["gather_2d", "dense_3d"])
def test_resume_is_bitwise(tmp_path, case):
    if case == "gather_2d":
        world, steps, dt, gravity = _world("torch"), 5, DT, G2
    else:
        from test_torch_dam_break import _torch_world

        world, _ = _torch_world()
        world.sim = world.sim.replace(layout="auto")
        world.timestep_manager.adaptive = True
        world.debug_checks = True
        steps, dt, gravity = 2, 1.0 / 60.0, (0.0, -9.81, 0.0)
    for _ in range(steps):
        world.step(dt, gravity)
    path = str(tmp_path / "ckpt.npz")
    save_world(world, path)
    restored = load_world(path, device="cpu")
    assert restored.device == torch.device("cpu")
    for name in ("positions", "velocities", "alive"):
        assert torch.equal(getattr(restored.fluids_state, name),
                           getattr(world.fluids_state, name))
    for _ in range(steps):
        for w in (world, restored):
            w.counters.reset()
            w.step(dt, gravity)
        assert restored.counters.nsubsteps == world.counters.nsubsteps
        assert _iters(restored) == _iters(world)
        assert torch.equal(restored.fluids_state.positions,
                           world.fluids_state.positions)
        assert torch.equal(restored.fluids_state.velocities,
                           world.fluids_state.velocities)
    if case == "dense_3d":
        assert restored._auto_caps == world._auto_caps
        assert restored._fitted_dims == world._fitted_dims


def test_load_preserves_config(tmp_path):
    world = _world("torch")
    world.timestep_manager.adaptive = True
    world.debug_checks = True
    path = str(tmp_path / "ckpt.npz")
    save_world(world, path)
    restored = load_world(path, device="cpu")
    assert restored.solver_config == world.solver_config
    assert restored.sim == world.sim
    assert restored.num_fluids == world.num_fluids
    (force,) = restored._fluid_records[0].nonpressure_forces
    assert force == tforces.XSPHViscosity(0.5, 0.0)
    assert restored.timestep_manager.adaptive and restored.debug_checks


@pytest.mark.parametrize("layout", ["gather", "dense"])
@pytest.mark.parametrize("saved_by", ["jax", "torch"])
def test_cross_load(tmp_path, saved_by, layout):
    """A file saved by ``saved_by`` loads in both packages; the two loaded
    worlds take the same steps within 2e-6 m."""
    from salva_tpu.io import load_world as jax_load
    from salva_tpu.io import save_world as jax_save

    world = _world(saved_by, layout)
    for _ in range(3):
        world.step(DT, G2)
    path = str(tmp_path / "ckpt.npz")
    (jax_save if saved_by == "jax" else save_world)(world, path)
    jw = jax_load(path)
    if layout == "dense":
        jw.sim = jw.sim.replace(use_pallas=False, dense_spill_auto=False,
                                dense_compact=False)
    tw = load_world(path, device="cpu")
    np.testing.assert_array_equal(tw.fluids_state.positions.numpy(),
                                  np.asarray(jw.fluids_state.positions))
    assert tw._fluid_records[0].particle_radius == \
        jw._fluid_records[0].particle_radius
    for _ in range(2):
        jw.step(DT, G2)
        tw.step(DT, G2)
        assert _iters(tw) == _iters(jw)
        np.testing.assert_allclose(tw.fluids_state.positions.numpy(),
                                   np.asarray(jw.fluids_state.positions),
                                   rtol=0, atol=POS_ATOL)
    assert np.isfinite(tw.fluid_positions(0)).all()


def _rewrite(path, edit):
    data = dict(np.load(path))
    meta = json.loads(bytes(data["meta"]).decode())
    edit(meta, data)
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **data)


def test_legacy_snapshot_falls_back_to_world_radius(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_world(_world("torch"), path)

    def drop_radius(meta, data):
        for r in meta["fluid_records"]:
            del r["particle_radius"]
        del data["host_state"]

    _rewrite(path, drop_radius)
    restored = load_world(path, device="cpu")
    assert restored._fluid_records[0].particle_radius == RADIUS
    assert not restored.timestep_manager.adaptive  # no host state: defaults


def test_legacy_solver_state_is_padded_as_jax(tmp_path):
    from salva_tpu.io import load_world as jax_load

    world = _world("torch")
    world.step(DT, G2)
    path = str(tmp_path / "ckpt.npz")
    save_world(world, path)

    def velocity_changes_only(meta, data):
        data["solver_state"] = data["solver_state"][:, :2]

    _rewrite(path, velocity_changes_only)
    jw, tw = jax_load(path), load_world(path, device="cpu")
    jw._prepare()
    tw._prepare()
    np.testing.assert_array_equal(tw._solver_state.numpy(),
                                  np.asarray(jw._solver_state))
    assert tw._solver_state.shape[1] == 4
    assert not tw._solver_state[:, 2:].any()


def test_custom_force_warns_and_elasticity_rebuilds(tmp_path):
    from salva_tpu_torch.scenes import AttractorForce

    world = st.LiquidWorld(particle_radius=RADIUS, dim=2, device="cpu")
    world.add_fluid(st.Fluid(_cube(4, (0.0, 0.0)), nonpressure_forces=[
        AttractorForce((1.0, 0.0))]))
    world.add_fluid(st.Fluid(_cube(4, (1.0, 0.0)), nonpressure_forces=[
        tforces.Becker2009Elasticity(50_000.0, 0.3)]))
    world.step(DT, G2)
    path = str(tmp_path / "ckpt.npz")
    with pytest.warns(UserWarning, match=r"CustomForce instances on fluids "
                      r"\[0\]"):
        save_world(world, path)
    restored = load_world(path, device="cpu")
    assert restored._fluid_records[0].nonpressure_forces == []
    assert restored._elasticity_dirty
    restored.step(DT, G2)
    assert restored._elasticity_state is not None
