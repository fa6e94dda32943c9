"""The 3D DFSPH dense dam break, run by both packages on the CPU.

The scene is built the way ``bench.py`` builds it (``cube_fluid`` block
one radius above a sampled ``Cuboid`` floor, moving down at 2 m/s, a
static ``domain``), at 7^3 particles, and both worlds step 6 times
through their public API. Both sides pin ``layout="dense"``; the JAX
world also pins ``use_pallas=False``, ``dense_spill_auto=False`` and
``dense_compact=False`` (its auto tiers read the JAX backend). The port
runs its plain pair passes (CPU tensors) — the folds the JAX package
runs on the CPU.

Held to: identical initial state (the JAX state enters the port through
``state_from_numpy``), identical resolved layout, identical pressure and
divergence iteration counts on every step, exact contact and overflow
counts, positions, velocities and solver state within ``atol=2e-6`` (the
tolerance the JAX suite holds dense against gather to,
``tests/test_brute.py``).

The helpers here (``run_both`` and the ``check_*`` functions) also drive
``tests/test_torch_iisph_dam_break.py``: IISPH, and DFSPH on the
full-grid boundary binning.
"""

import dataclasses

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.object.state import state_from_numpy, state_to_numpy

# One intra-op thread: the parity tests run many tiny torch ops, and the
# suite runs several test processes at once, where torch's spinning
# thread pools oversubscribe the cores (one IISPH parity fixture took
# over 800 s with the default pool under load, 89 s with one thread).
torch.set_num_threads(1)

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


def _forces(module, forces):
    """The force instances of ``forces`` ((class name, kwargs) pairs) from
    one package's ``forces`` module."""
    return [getattr(module, name)(**kw) for name, kw in forces]


def _jax_world(solver="dfsph", sparse_boundary=True, forces=(),
               kernels=("cubic", "cubic")):
    from salva_tpu import forces as force_specs
    from salva_tpu import shapes
    from salva_tpu.config import DFSPHConfig, IISPHConfig
    from salva_tpu.sampling import shape_surface_sample
    from salva_tpu.scenes import cube_fluid
    from salva_tpu.world import Boundary, Fluid, LiquidWorld

    domain, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    cfg = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}[solver]()
    w = LiquidWorld(solver=cfg, particle_radius=RADIUS, dim=3,
                    domain=domain, layout="dense")
    w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                          dense_compact=False,
                          dense_sparse_boundary=sparse_boundary,
                          kernel_density=kernels[0],
                          kernel_gradient=kernels[1])
    w.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                      nonpressure_forces=_forces(force_specs, forces)))
    w.add_boundary(Boundary(floor))
    return w, floor


def _torch_world(solver="dfsph", sparse_boundary=True, forces=(),
                 kernels=("cubic", "cubic")):
    from salva_tpu_torch import forces as force_specs
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid

    domain, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    cfg = {"dfsph": st.DFSPHConfig, "iisph": st.IISPHConfig}[solver]()
    w = st.LiquidWorld(solver=cfg, particle_radius=RADIUS,
                       dim=3, domain=domain, layout="dense", device="cpu")
    w.sim = w.sim.replace(dense_sparse_boundary=sparse_boundary,
                          kernel_density=kernels[0],
                          kernel_gradient=kernels[1])
    w.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel,
                         nonpressure_forces=_forces(force_specs, forces)))
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


def run_both(solver="dfsph", sparse_boundary=True, forces=(),
             kernels=("cubic", "cubic"), steps=STEPS):
    """Step the JAX and the port's world side by side ``steps`` times;
    per-step snapshots of both. ``forces``: the fluid's non-pressure
    forces, as (class name in ``forces.py``, kwargs) pairs; ``kernels``:
    (``kernel_density``, ``kernel_gradient``) of both worlds."""
    wj, floor_j = _jax_world(solver, sparse_boundary, forces, kernels)
    wt, floor_t = _torch_world(solver, sparse_boundary, forces, kernels)
    init = (_jax_fields(wj.fluids_state), _jax_fields(wj.boundaries_state),
            wt.fluids_state, wt.boundaries_state)
    jax_steps, torch_steps = [], []
    for _ in range(steps):
        wj.step(DT, GRAVITY)
        wt.step(DT, GRAVITY)
        jax_steps.append(_snapshot(wj, True))
        torch_steps.append(_snapshot(wt, False))
    return dict(floors=(floor_j, floor_t), init=init, jax=jax_steps,
                torch=torch_steps, worlds=(wj, wt))


@pytest.fixture(scope="module")
def runs():
    return run_both()


def check_scene_and_initial_state(runs):
    floor_j, floor_t = runs["floors"]
    np.testing.assert_array_equal(floor_t, floor_j)
    fl_j, bd_j, fl_t, bd_t = runs["init"]
    for mine, theirs in ((fl_t, fl_j), (bd_t, bd_j)):
        ported = state_from_numpy(theirs, device="cpu")
        assert type(ported) is type(mine)
        for f in dataclasses.fields(mine):
            torch.testing.assert_close(getattr(mine, f.name),
                                       getattr(ported, f.name),
                                       rtol=0, atol=0, msg=f.name)


def check_resolved_layout(runs):
    wj, wt = runs["worlds"]
    assert wt._auto_caps == wj._auto_caps
    assert wt._fitted_dims == wj._fitted_dims
    assert wt._fb_cols_cache == wj._fb_cols_cache
    for j, t in zip(runs["jax"], runs["torch"]):
        assert t["layout"] == j["layout"]


def check_iteration_counts(runs):
    got = [(s["p_iters"], s["d_iters"]) for s in runs["torch"]]
    want = [(s["p_iters"], s["d_iters"]) for s in runs["jax"]]
    assert got == want


def check_contact_and_overflow_counts(runs):
    keys = ("ncontacts_ff", "ncontacts_fb", "neighbor_overflow",
            "candidate_overflow")
    for j, t in zip(runs["jax"], runs["torch"]):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    # The block reaches the floor inside the run (fb contacts grow).
    assert runs["torch"][-1]["ncontacts_fb"] > runs["torch"][0]["ncontacts_fb"]


def check_positions_and_velocities(runs, vel_atol=2e-6, state_atol=2e-6):
    """Positions within 2e-6, velocities within ``vel_atol``, and the
    solver state (DFSPH: velocity changes and stiffness sums; IISPH:
    pressures) within ``state_atol`` x max(1, its peak): IISPH pressures
    reach ~5e4 Pa, where one float32 ulp is 4e-3, so their tolerance is
    taken relative to their own scale (the DFSPH state's peak is below 1,
    so for it the bound is ``state_atol`` itself)."""
    for j, t in zip(runs["jax"], runs["torch"]):
        alive = j["fluids"]["alive"]
        np.testing.assert_array_equal(t["fluids"]["alive"], alive)
        for name, atol in (("positions", 2e-6), ("velocities", vel_atol)):
            np.testing.assert_allclose(t["fluids"][name][alive],
                                       j["fluids"][name][alive],
                                       rtol=0, atol=atol, err_msg=name)
        want = state_from_numpy(j["solver"], device="cpu")
        peak = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(
            torch.from_numpy(t["solver"]), want, rtol=0,
            atol=state_atol * peak,
        )
        np.testing.assert_allclose(t["max_density_ratio"],
                                   j["max_density_ratio"], rtol=1e-6)


def check_boundary_volumes_and_forces(runs):
    """Volumes: the in-window dense pass and the one-time full-extent
    pass (both float32 W sums; last-ulp summation order). Forces: the
    boundary-owner feedback pass, relative to its peak magnitude."""
    for j, t in zip(runs["jax"], runs["torch"]):
        bj, bt = j["boundaries"], t["boundaries"]
        np.testing.assert_allclose(bt["volumes"], bj["volumes"], rtol=1e-5)
        scale = max(float(np.abs(bj["forces"]).max()), 1e-30)
        np.testing.assert_allclose(bt["forces"] / scale,
                                   bj["forces"] / scale, rtol=0, atol=1e-4)


def test_scene_and_initial_state_match(runs):
    check_scene_and_initial_state(runs)


def test_resolved_layout_matches(runs):
    check_resolved_layout(runs)


def test_iteration_counts_identical(runs):
    check_iteration_counts(runs)


def test_contact_and_overflow_counts_exact(runs):
    check_contact_and_overflow_counts(runs)


def test_positions_and_velocities_match(runs):
    check_positions_and_velocities(runs)


def test_boundary_volumes_and_forces_match(runs):
    check_boundary_volumes_and_forces(runs)
