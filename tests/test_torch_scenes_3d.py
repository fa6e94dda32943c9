"""The 3D reference scenes on the PyTorch port, against the JAX package on
the CPU (``build_both`` / ``run_and_hold`` and the tolerances:
``tests/test_torch_scenes_2d.py``), ``basic3`` and ``harness_basic3`` at
``nparticles=5``; the registry's keys; and the world's emitter and
deletion API held to JAX's on ``faucet3``: emission into free slots
(exact counts and slots), predicate deletion, deferred and immediate
deletion, ``add_particles``, the isometries, ``remove_fluid`` and
``remove_boundary``, and the ``faucet3`` schedule of emitted sheets.
"""

import numpy as np
import pytest
import torch

from test_torch_scenes_2d import POS_TOL, build_both, run_and_hold

torch.set_num_threads(1)


def test_registry_has_the_jax_keys():
    from salva_tpu import scenes as jscenes
    from salva_tpu_torch import scenes as tscenes

    assert list(tscenes.SCENES) == list(jscenes.SCENES)
    assert len(tscenes.SCENES) == 12


SCENES_3D = {
    # name: (builder kwargs, layout on the CPU, device path held too)
    "basic3": ({"nparticles": 5}, "gather", False),
    "harness_basic3": ({"nparticles": 5}, "gather", True),
    "surface_tension3": ({}, "gather", False),
    "elasticity3": ({}, "gather", False),
    "custom_forces3": ({}, "gather", False),
    "faucet3": ({}, "gather", False),
    "heightfield3": ({}, "gather", False),
}


@pytest.mark.parametrize("name", list(SCENES_3D))
def test_scene_3d_matches_jax(name):
    kw, want, device_too = SCENES_3D[name]
    for device_coupling in ((None, True) if device_too else (None,)):
        sj, st = build_both(name, device_coupling, **kw)
        assert st.pipeline.device_coupling == bool(device_coupling)
        assert run_and_hold(sj, st) == want
        for h in st.fluid_handles:
            assert np.isfinite(st.world.fluid_positions(h)).all()
    if name in ("basic3", "harness_basic3"):
        # The fluid stays inside the box walls (tests/test_scenes.py).
        pos = st.world.fluid_positions(st.fluid_handles[0])
        assert np.abs(pos[:, [0, 2]]).max() < 2.6


def _alive(world):
    a = world.fluids_state.alive
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_fluid(wj, wt, msg):
    np.testing.assert_array_equal(_alive(wt), _alive(wj), err_msg=msg)
    for h in range(wj.num_fluids):
        np.testing.assert_array_equal(wt.fluid_slots(h), wj.fluid_slots(h),
                                      err_msg=msg)
        np.testing.assert_allclose(wt.fluid_positions(h),
                                   wj.fluid_positions(h), rtol=0,
                                   atol=POS_TOL, err_msg=msg)


def test_faucet3_emission_and_deletion_match_jax():
    sj, st = build_both("faucet3")
    wj, wt = sj.world, st.world
    fl = st.fluid_handles[0]
    # The schedule: a 10 x 10 sheet at t = 0, none at t = dt (< 0.06 s).
    run_and_hold(sj, st)
    assert len(wt.fluid_positions(fl)) == 100
    _same_fluid(wj, wt, "after 2 steps")
    # Predicate deletion through the alive mask (faucet3 deletes below
    # y = -2; here the sheet's front rows).
    wj.delete_where(fl, lambda p, v: p[:, 0] > 0.05)
    wt.delete_where(fl, lambda p, v: p[:, 0] > 0.05)
    _same_fluid(wj, wt, "delete_where")
    n = len(wt.fluid_positions(fl))
    assert 0 < n < 100
    # Device emission of another sheet into the freed slots.
    template = wt.fluid_positions(fl)[:7] + np.float32(0.3)
    wj.emit_particles(fl, template)
    wt.emit_particles(fl, template)
    _same_fluid(wj, wt, "emit_particles")
    assert len(wt.fluid_positions(fl)) == n + 7
    # Deferred deletion, applied at the next step's start.
    for w in (wj, wt):
        w.delete_particle_at_next_timestep(fl, 3)
        w.delete_particle_at_next_timestep(fl, 5)
    assert wt.num_deleted_particles(fl) == wj.num_deleted_particles(fl) == 2
    assert len(wt.fluid_positions(fl)) == n + 7  # still there
    for s in (sj, st):
        s.callback, cb = None, s.callback
        s.step()
        s.callback = cb
    _same_fluid(wj, wt, "deferred deletion")
    assert len(wt.fluid_positions(fl)) == n + 5
    # Immediate deletion, host-side addition, isometries.
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                   np.float32)
    for w in (wj, wt):
        w.delete_particles(fl, [0, 2])
        w.add_particles(fl, template[:4] - np.float32(0.1))
        w.transform_fluid_by(fl, rot, (0.0, 0.1, 0.0))
        w.transform_boundary_by(0, None, (0.0, 0.05, 0.0))
    _same_fluid(wj, wt, "delete / add / transform")
    assert len(wt.fluid_positions(fl)) == n + 7
    np.testing.assert_allclose(wt.boundary_positions(0),
                               wj.boundary_positions(0), rtol=0,
                               atol=POS_TOL)
    # Removing the fluid and the ball's boundary.
    for w in (wj, wt):
        w.remove_boundary(0)
        w.remove_fluid(fl)
    _same_fluid(wj, wt, "remove")
    assert len(wt.fluid_positions(fl)) == 0
    assert len(wt.boundary_positions(0)) == 0
    assert wt._uniform_particles() is None
