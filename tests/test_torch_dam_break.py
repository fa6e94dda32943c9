"""The 3D DFSPH dense dam break, run by both packages on the CPU.

The scene is built the way ``bench.py`` builds it (``cube_fluid`` block
one radius above a sampled ``Cuboid`` floor, moving down at 2 m/s, a
static ``domain``), at 7^3 particles, and both worlds step 6 times
through their public API. Both sides pin ``layout="dense"``; the JAX
world also pins ``use_pallas=False``, ``dense_spill_auto=False`` and
``dense_compact=False`` (its auto tiers read the JAX backend). The port
runs its plain pair passes (CPU tensors) — the half-stencil folds the JAX
package runs on the CPU.

Held to: identical initial state (the JAX state enters the port through
``state_from_numpy``), identical resolved layout, identical pressure and
divergence iteration counts on every step, exact contact and overflow
counts, positions and velocities within ``atol=2e-6`` (the tolerance the
JAX suite holds dense against gather to, ``tests/test_brute.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.object.state import state_from_numpy, state_to_numpy

RADIUS = 0.05
N_SIDE = 7
STEPS = 6
DT = 1.0 / 200.0
GRAVITY = (0.0, -9.81, 0.0)


def _scene(shapes, shape_surface_sample, cube_fluid):
    half = N_SIDE * RADIUS
    wall = max(1.5 * half, half + 0.5)
    domain = (
        (-wall - 0.3, -0.4, -wall - 0.3),
        (wall + 0.3, 2.0 * half + 1.0, wall + 0.3),
    )
    pos = cube_fluid((N_SIDE,) * 3, RADIUS)
    pos[:, 1] += half + RADIUS
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), RADIUS, 3)
    floor[:, 1] -= 0.1
    return domain, pos, vel, floor


def _jax_world():
    from salva_tpu import shapes
    from salva_tpu.config import DFSPHConfig
    from salva_tpu.sampling import shape_surface_sample
    from salva_tpu.scenes import cube_fluid
    from salva_tpu.world import Boundary, Fluid, LiquidWorld

    domain, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    w = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=3,
                    domain=domain, layout="dense")
    w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                          dense_compact=False)
    w.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    w.add_boundary(Boundary(floor))
    return w, floor


def _torch_world():
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid

    domain, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    w = st.LiquidWorld(solver=st.DFSPHConfig(), particle_radius=RADIUS,
                       dim=3, domain=domain, layout="dense", device="cpu")
    w.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel))
    w.add_boundary(st.Boundary(floor))
    return w, floor


def _jax_fields(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _snapshot(w, jax_side):
    d = w.last_diagnostics
    if jax_side:
        fl, bd = _jax_fields(w.fluids_state), _jax_fields(w.boundaries_state)
        solver = np.asarray(w._solver_state)
    else:
        fl = state_to_numpy(w.fluids_state)
        bd = state_to_numpy(w.boundaries_state)
        solver = state_to_numpy(w._solver_state)
    return dict(
        fluids=fl, boundaries=bd, solver=solver,
        p_iters=int(d.solver.pressure_iters),
        d_iters=int(d.solver.divergence_iters),
        ncontacts_ff=int(d.ncontacts_ff),
        ncontacts_fb=int(d.ncontacts_fb),
        neighbor_overflow=int(d.neighbor_overflow),
        candidate_overflow=int(d.candidate_overflow),
        max_density_ratio=float(d.max_density_ratio),
        layout=(w.sim.dense_cap, w._auto_caps, w._fitted_dims,
                w.grid_refit_count),
    )


@pytest.fixture(scope="module")
def runs():
    wj, floor_j = _jax_world()
    wt, floor_t = _torch_world()
    init = (_jax_fields(wj.fluids_state), _jax_fields(wj.boundaries_state),
            wt.fluids_state, wt.boundaries_state)
    jax_steps, torch_steps = [], []
    for _ in range(STEPS):
        wj.step(DT, GRAVITY)
        wt.step(DT, GRAVITY)
        jax_steps.append(_snapshot(wj, True))
        torch_steps.append(_snapshot(wt, False))
    return dict(floors=(floor_j, floor_t), init=init, jax=jax_steps,
                torch=torch_steps, worlds=(wj, wt))


def test_scene_and_initial_state_match(runs):
    floor_j, floor_t = runs["floors"]
    np.testing.assert_array_equal(floor_t, floor_j)
    fl_j, bd_j, fl_t, bd_t = runs["init"]
    for mine, theirs in ((fl_t, fl_j), (bd_t, bd_j)):
        ported = state_from_numpy(theirs)
        assert type(ported) is type(mine)
        for f in dataclasses.fields(mine):
            torch.testing.assert_close(getattr(mine, f.name),
                                       getattr(ported, f.name),
                                       rtol=0, atol=0, msg=f.name)


def test_resolved_layout_matches(runs):
    wj, wt = runs["worlds"]
    assert wt._auto_caps == wj._auto_caps
    assert wt._fitted_dims == wj._fitted_dims
    assert wt._fb_cols_cache == wj._fb_cols_cache
    for j, t in zip(runs["jax"], runs["torch"]):
        assert t["layout"] == j["layout"]


def test_iteration_counts_identical(runs):
    got = [(s["p_iters"], s["d_iters"]) for s in runs["torch"]]
    want = [(s["p_iters"], s["d_iters"]) for s in runs["jax"]]
    assert got == want


def test_contact_and_overflow_counts_exact(runs):
    keys = ("ncontacts_ff", "ncontacts_fb", "neighbor_overflow",
            "candidate_overflow")
    for j, t in zip(runs["jax"], runs["torch"]):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    # The block reaches the floor inside the run (fb contacts grow).
    assert runs["torch"][-1]["ncontacts_fb"] > runs["torch"][0]["ncontacts_fb"]


def test_positions_and_velocities_match(runs):
    for j, t in zip(runs["jax"], runs["torch"]):
        alive = j["fluids"]["alive"]
        np.testing.assert_array_equal(t["fluids"]["alive"], alive)
        for name in ("positions", "velocities"):
            np.testing.assert_allclose(t["fluids"][name][alive],
                                       j["fluids"][name][alive],
                                       rtol=0, atol=2e-6, err_msg=name)
        torch.testing.assert_close(
            torch.from_numpy(t["solver"]), state_from_numpy(j["solver"]),
            rtol=0, atol=2e-6,
        )
        np.testing.assert_allclose(t["max_density_ratio"],
                                   j["max_density_ratio"], rtol=1e-6)


def test_boundary_volumes_and_forces_match(runs):
    """Volumes: the in-window dense pass and the one-time full-extent
    pass (both float32 W sums; last-ulp summation order). Forces: the
    boundary-owner feedback pass, relative to its peak magnitude."""
    for j, t in zip(runs["jax"], runs["torch"]):
        bj, bt = j["boundaries"], t["boundaries"]
        np.testing.assert_allclose(bt["volumes"], bj["volumes"], rtol=1e-5)
        scale = max(float(np.abs(bj["forces"]).max()), 1e-30)
        np.testing.assert_allclose(bt["forces"] / scale,
                                   bj["forces"] / scale, rtol=0, atol=1e-4)
