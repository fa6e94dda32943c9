"""The 2D reference scenes on the PyTorch port, against the JAX package on
the CPU (the 3D scenes: ``tests/test_torch_scenes_3d.py``, which reuses
``build_both`` and ``run_and_hold`` from here).

Every entry of ``salva_tpu_torch.scenes.SCENES`` is built by both
packages at its published size (``basic3`` / ``harness_basic3`` at
``nparticles=5``) and held:

- the same resolved layout (brute, dense or gather; the ``auto`` choices
  depend on the backend, so it is asserted, not assumed);
- the fluid particle set exactly at build time, and each boundary's
  particles after each step (the coupled boundaries are sampled at the
  first step; the port writes the static ones at their poses before it,
  so their slot blocks may lie in another order than JAX's);
- 2 steps through ``scenes.run``: fluid positions within 2e-6 m,
  iterations identical, ff / fb contact counts exact, boundary positions
  within 2e-6 m, body translation, rotation and velocities within 1e-5.

Scenes on the CPU take the host coupling path by default; ``layers2``
(``basic2``'s three dynamic bodies and heightfield, with interaction
groups) also runs the device path (``device_coupling=True``) against
JAX's device path, as ``harness_basic3`` does in 3D.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

POS_TOL = 2e-6
BODY_TOL = 1e-5
STEPS = 2


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fields(state):
    return {f.name: _np(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def resolved_layout(world, step_module):
    """brute, dense or gather: what the next step of ``world`` runs."""
    sim = world._effective_sim()
    if sim.layout == "brute":
        return "brute"
    if world._force_set is None:
        world._force_set = world._build_force_set()
    dense = step_module._dense_config(sim, world.solver_config,
                                      world._force_set)
    return "dense" if dense is not None else "gather"


def build_both(name, device_coupling=None, **kw):
    """The scene ``name`` from both packages (torch on the CPU)."""
    from salva_tpu import scenes as jscenes
    from salva_tpu_torch import scenes as tscenes

    sj = jscenes.SCENES[name](**kw)
    st = tscenes.SCENES[name](device="cpu", **kw)
    if device_coupling is not None:
        sj.pipeline._device_request = device_coupling
        st.pipeline._device_request = device_coupling
    fj, ft = _fields(sj.world.fluids_state), _fields(st.world.fluids_state)
    assert fj.keys() == ft.keys()
    for key in fj:
        np.testing.assert_array_equal(ft[key], fj[key].astype(ft[key].dtype),
                                      err_msg=key)
    assert len(sj.pipeline.coupling.entries) == len(
        st.pipeline.coupling.entries)
    for ej, et in zip(sj.pipeline.coupling.entries.values(),
                      st.pipeline.coupling.entries.values()):
        assert (ej.boundary, ej.collider, ej.sampling.kind) == (
            et.boundary, et.collider, et.sampling.kind)
        if ej.sampling.kind == "static":
            np.testing.assert_array_equal(et.sampling.points,
                                          ej.sampling.points)
    return sj, st


def _boundary(world, handle):
    """The live particles of boundary ``handle``, in slot order (the
    packages may place the boundaries' slot blocks in another order)."""
    live = (world._boundary_slot_owner == handle) & _np(
        world.boundaries_state.alive)
    return _np(world.boundaries_state.positions)[live]


def hold(sj, st, step):
    """One step's state of the two scenes, held to the tolerances."""
    wj, wt = sj.world, st.world
    msg = f"{sj.name} step {step}"
    for h in sj.fluid_handles:
        np.testing.assert_allclose(wt.fluid_positions(h),
                                   wj.fluid_positions(h), rtol=0,
                                   atol=POS_TOL, err_msg=msg)
    dj, dt_ = wj.last_diagnostics, wt.last_diagnostics
    assert (dt_.solver.pressure_iters, dt_.solver.divergence_iters) == (
        int(dj.solver.pressure_iters), int(dj.solver.divergence_iters)), msg
    assert (int(dt_.ncontacts_ff), int(dt_.ncontacts_fb)) == (
        int(dj.ncontacts_ff), int(dj.ncontacts_fb)), msg
    for h in range(wj.num_boundaries):
        np.testing.assert_allclose(_boundary(wt, h), _boundary(wj, h),
                                   rtol=0, atol=POS_TOL,
                                   err_msg=f"{msg} boundary {h}")
    for bj, bt in zip(sj.pipeline.sync_bodies().bodies,
                      st.pipeline.sync_bodies().bodies):
        for attr in ("translation", "rotation", "linvel", "angvel"):
            np.testing.assert_allclose(
                np.atleast_1d(getattr(bt, attr)),
                np.atleast_1d(getattr(bj, attr)), rtol=0, atol=BODY_TOL,
                err_msg=f"{msg} {attr}")


def run_and_hold(sj, st, steps=STEPS):
    from salva_tpu import scenes as jscenes
    from salva_tpu import step as jstep
    from salva_tpu_torch import scenes as tscenes
    from salva_tpu_torch import step as tstep

    layout = resolved_layout(st.world, tstep)
    assert layout == resolved_layout(sj.world, jstep)
    for i in range(steps):
        # One step of each, through scenes.run's callback protocol.
        for s, mod in ((sj, jscenes), (st, tscenes)):
            s.callback, cb = None, s.callback
            if cb is not None:
                cb(s, i, i * s.dt)
            mod.run(s, 1)
            s.callback = cb
        hold(sj, st, i)
        assert resolved_layout(st.world, tstep) == resolved_layout(
            sj.world, jstep)
    return layout


SCENES_2D = {
    # name: (layout on the CPU, device paths held too)
    "basic2": ("dense", False),
    "layers2": ("dense", True),
    "surface_tension2": ("gather", False),
    "elasticity2": ("dense", False),
    "custom_forces2": ("gather", False),
}


@pytest.mark.parametrize("name", list(SCENES_2D))
def test_scene_2d_matches_jax(name):
    want, both_paths = SCENES_2D[name]
    for device_coupling in ((None, True) if both_paths else (None,)):
        sj, st = build_both(name, device_coupling)
        assert st.pipeline.device_coupling == bool(device_coupling)
        assert run_and_hold(sj, st) == want
        for h in st.fluid_handles:
            assert np.isfinite(st.world.fluid_positions(h)).all()
