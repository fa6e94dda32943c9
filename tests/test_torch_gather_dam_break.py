"""The gather layout's dam breaks, run by both packages on the CPU.

- The 7^3 3D dam break of ``tests/test_torch_dam_break.py`` (bench.py's
  scene) with no ``domain``, so ``layout="auto"`` resolves to the gather
  layout in both packages, under DFSPH and IISPH, 6 steps;
- ``tests/test_dense.py``'s 2D dam world (DFSPH, 20 steps) and its 2D
  IISPH world (15 steps) at ``layout="gather"``, with its
  ``NeighborConfig`` (``query_chunk=4096``).

Held to, on every step: identical pressure and divergence iteration
counts, exact ff / fb contact and overflow counts, positions within 2e-6
m; velocities within 2e-6 m/s under DFSPH and 1e-5 m/s under IISPH, and
the solver state within 2e-6 (DFSPH) or 2e-5 x its peak (IISPH
pressures; their Jacobi update amplifies last-ulp differences,
``ROADMAP.md`` Queue 3 item 8); boundary volumes within rtol 1e-5 and
boundary forces within rtol 1e-4 plus atol 1e-5 x their peak.

The port's own dense layout against its gather layout on the 2D worlds,
at ``tests/test_dense.py``'s bounds and step counts.

The cell-edge trap: bench.py's dam break at 12^3 (with its ``domain``)
on both layouts of both packages, one step. A column of the lattice sits
on the dense grid's cell edges, where a pair at exactly r = h spans two
cells, outside the dense stencil; the gather layout counts it. Each
layout's ff contact count is the same in both packages (44,488 gather,
43,912 dense), and each package's two layouts end the step as far apart
as the other's (the DFSPH neighbour-count gate flips on the ties).
"""

import dataclasses

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.object.state import state_from_numpy
from test_torch_dam_break import (
    DT,
    GRAVITY,
    RADIUS,
    _forces,
    _jax_fields,
    _scene,
    _snapshot,
)
from util import cube_positions

torch.set_num_threads(1)

GRAVITY_2D = (0.0, -9.81)
VEL_ATOL = {"dfsph": 2e-6, "iisph": 1e-5}
STATE_ATOL = {"dfsph": 2e-6, "iisph": 2e-5}


def _jax_dam_3d(solver, forces=(), kernels=("cubic", "cubic")):
    """The 7^3 bench scene without a domain (the gather layout)."""
    from salva_tpu import forces as force_specs
    from salva_tpu import shapes
    from salva_tpu.config import DFSPHConfig, IISPHConfig
    from salva_tpu.sampling import shape_surface_sample
    from salva_tpu.scenes import cube_fluid
    from salva_tpu.world import Boundary, Fluid, LiquidWorld

    _, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    cfg = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}[solver]()
    w = LiquidWorld(solver=cfg, particle_radius=RADIUS, dim=3)
    w.sim = w.sim.replace(kernel_density=kernels[0],
                          kernel_gradient=kernels[1])
    w.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                      nonpressure_forces=_forces(force_specs, forces)))
    w.add_boundary(Boundary(floor))
    return w


def _torch_dam_3d(solver, forces=(), kernels=("cubic", "cubic")):
    from salva_tpu_torch import forces as force_specs
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid

    _, pos, vel, floor = _scene(shapes, shape_surface_sample, cube_fluid)
    cfg = {"dfsph": st.DFSPHConfig, "iisph": st.IISPHConfig}[solver]()
    w = st.LiquidWorld(solver=cfg, particle_radius=RADIUS, dim=3,
                       device="cpu")
    w.sim = w.sim.replace(kernel_density=kernels[0],
                          kernel_gradient=kernels[1])
    w.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel,
                         nonpressure_forces=_forces(force_specs, forces)))
    w.add_boundary(st.Boundary(floor))
    return w


def _dam_2d(pkg, solver, layout, iisph_world=False):
    """``tests/test_dense.py``'s ``_dam_worlds`` (DFSPH) or the world of
    its ``test_dense_iisph_matches_gather`` (IISPH)."""
    if pkg == "jax":
        from salva_tpu.config import DFSPHConfig, IISPHConfig, NeighborConfig
        from salva_tpu.world import Boundary, Fluid, LiquidWorld

        cfgs = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}
        kw = {}
    else:
        from salva_tpu_torch import (Boundary, DFSPHConfig, Fluid,
                                     IISPHConfig, LiquidWorld, NeighborConfig)

        cfgs = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}
        kw = dict(device="cpu")
    w = LiquidWorld(
        solver=cfgs[solver](), particle_radius=RADIUS, dim=2,
        neighbors=NeighborConfig(max_neighbors=64, max_candidates=160,
                                 query_chunk=4096),
        domain=((-1.5, -0.5), (1.5, 2.0)), layout=layout, fit_grid=False,
        **kw)
    if pkg == "jax" and layout == "dense":
        w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                              dense_compact=False)
    xs = np.arange(-1.2, 1.2, 2 * RADIUS, dtype=np.float32)
    floor = np.stack([xs, np.full_like(xs, -2 * RADIUS)], axis=-1)
    if iisph_world:
        pos = cube_positions(7, RADIUS, 2, origin=(-0.5, 0.02))
        walls = floor
    else:
        pos = cube_positions(8, RADIUS, 2, origin=(-0.9, 0.02))
        ys = np.arange(0.0, 1.0, 2 * RADIUS, dtype=np.float32)
        left = np.stack([np.full_like(ys, -1.2), ys], axis=-1)
        right = np.stack([np.full_like(ys, 1.2), ys], axis=-1)
        walls = np.concatenate([floor, left, right])
    w.add_fluid(Fluid(pos, density0=1000.0))
    w.add_boundary(Boundary(walls))
    return w


def run_pair(make_jax, make_torch, steps, gravity):
    """Step a JAX and a port world side by side; per-step snapshots."""
    wj, wt = make_jax(), make_torch()
    init = (_jax_fields(wj.fluids_state), _jax_fields(wj.boundaries_state),
            wt.fluids_state, wt.boundaries_state)
    out = dict(jax=[], torch=[], init=init, worlds=(wj, wt))
    for _ in range(steps):
        wj.step(DT, gravity)
        wt.step(DT, gravity)
        out["jax"].append(_snapshot(wj, True))
        out["torch"].append(_snapshot(wt, False))
    return out


def check_gather_parity(runs, solver, vel_atol=None, state_atol=None):
    """The module docstring's per-step rules, and the initial states;
    ``vel_atol`` / ``state_atol`` override the solver's tolerances."""
    vel_atol = vel_atol or VEL_ATOL[solver]
    state_atol = state_atol or STATE_ATOL[solver]
    fl_j, bd_j, fl_t, bd_t = runs["init"]
    for mine, theirs in ((fl_t, fl_j), (bd_t, bd_j)):
        ported = state_from_numpy(theirs, device="cpu")
        for f in dataclasses.fields(mine):
            assert torch.equal(getattr(mine, f.name),
                               getattr(ported, f.name)), f.name
    keys = ("p_iters", "d_iters", "ncontacts_ff", "ncontacts_fb",
            "neighbor_overflow", "candidate_overflow")
    for j, t in zip(runs["jax"], runs["torch"]):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        alive = j["fluids"]["alive"]
        np.testing.assert_array_equal(t["fluids"]["alive"], alive)
        for name, atol in (("positions", 2e-6), ("velocities", vel_atol)):
            np.testing.assert_allclose(t["fluids"][name][alive],
                                       j["fluids"][name][alive], rtol=0,
                                       atol=atol, err_msg=name)
        peak = max(1.0, float(np.abs(j["solver"]).max()))
        np.testing.assert_allclose(t["solver"], j["solver"], rtol=0,
                                   atol=state_atol * peak)
        np.testing.assert_allclose(t["max_density_ratio"],
                                   j["max_density_ratio"], rtol=1e-6)
        bj, bt = j["boundaries"], t["boundaries"]
        np.testing.assert_allclose(bt["volumes"], bj["volumes"], rtol=1e-5)
        fpeak = max(float(np.abs(bj["forces"]).max()), 1e-30)
        np.testing.assert_allclose(bt["forces"], bj["forces"], rtol=1e-4,
                                   atol=1e-5 * fpeak)
    assert runs["torch"][-1]["ncontacts_fb"] > 0


@pytest.fixture(scope="module", params=["dfsph", "iisph"])
def runs_3d(request):
    solver = request.param
    runs = run_pair(lambda: _jax_dam_3d(solver),
                    lambda: _torch_dam_3d(solver), 6, GRAVITY)
    return solver, runs


@pytest.fixture(scope="module", params=["dfsph", "iisph"])
def runs_2d(request):
    """JAX gather, port gather and port dense worlds of one 2D world."""
    solver = request.param
    iisph = solver == "iisph"
    steps = 15 if iisph else 20
    runs = run_pair(lambda: _dam_2d("jax", solver, "gather", iisph),
                    lambda: _dam_2d("torch", solver, "gather", iisph),
                    steps, GRAVITY_2D)
    dense = _dam_2d("torch", solver, "dense", iisph)
    for _ in range(steps):
        dense.step(DT, GRAVITY_2D)
    return solver, runs, dense


def test_3d_dam_break_resolves_to_gather_and_matches(runs_3d):
    from salva_tpu_torch.step import _dense_config

    solver, runs = runs_3d
    wt = runs["worlds"][1]
    assert wt.sim.domain is None
    assert _dense_config(wt._effective_sim(), wt.solver_config,
                         wt._force_set) is None
    check_gather_parity(runs, solver)
    # The block reaches the floor inside the run.
    assert runs["torch"][-1]["ncontacts_fb"] > runs["torch"][0][
        "ncontacts_fb"]


def test_2d_dam_worlds_match(runs_2d):
    solver, runs, _ = runs_2d
    check_gather_parity(runs, solver)


def test_port_dense_matches_port_gather(runs_2d):
    """``tests/test_dense.py``'s dense-vs-gather rules, between the port's
    two layouts."""
    solver, runs, wd = runs_2d
    wg = runs["worlds"][1]
    pg, pd = wg.fluid_positions(0), wd.fluid_positions(0)
    assert np.isfinite(pd).all()
    fg = wg.boundaries_state.forces.numpy().sum(axis=0)
    fd = wd.boundaries_state.forces.numpy().sum(axis=0)
    if solver == "dfsph":
        np.testing.assert_allclose(pg, pd, atol=5e-4)
        np.testing.assert_allclose(wg.fluid_velocities(0),
                                   wd.fluid_velocities(0), atol=5e-3)
        np.testing.assert_allclose(fg, fd, rtol=2e-2, atol=1.0)
        assert int(wd.last_diagnostics.neighbor_overflow) == 0
        assert int(wd.last_diagnostics.ncontacts_ff) == int(
            wg.last_diagnostics.ncontacts_ff)
    else:
        np.testing.assert_allclose(pg, pd, atol=1e-3)
        np.testing.assert_allclose(fg, fd, rtol=5e-2, atol=1.0)


def _bench_world_jax(layout, n_side=12):
    """bench.py's dam break at n_side^3 (``chip_smoke.dam_break_world``'s
    scene) in the JAX package."""
    from salva_tpu import shapes
    from salva_tpu.config import DFSPHConfig
    from salva_tpu.sampling import shape_surface_sample
    from salva_tpu.scenes import cube_fluid
    from salva_tpu.world import Boundary, Fluid, LiquidWorld

    half = n_side * RADIUS
    wall = max(1.5 * half, half + 0.5)
    domain = ((-wall - 0.3, -0.4, -wall - 0.3),
              (wall + 0.3, 2.0 * half + 1.0, wall + 0.3))
    w = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=3,
                    domain=domain, layout=layout)
    if layout == "dense":
        w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                              dense_compact=False)
    pos = cube_fluid((n_side,) * 3, RADIUS)
    pos[:, 1] += half + RADIUS
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    w.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), RADIUS, 3)
    floor[:, 1] -= 0.1
    w.add_boundary(Boundary(floor))
    return w


def test_cell_edge_ties_split_the_layouts_in_both_packages():
    import chip_smoke

    seen = {}
    for layout in ("gather", "dense"):
        wj = _bench_world_jax(layout)
        wt = chip_smoke.dam_break_world("cpu", n_target=12 ** 3,
                                        layout=layout)
        for pkg, w in (("jax", wj), ("torch", wt)):
            w.step(DT, GRAVITY)
            d = w.last_diagnostics
            alive = np.asarray(w.fluids_state.alive)
            seen[pkg, layout] = (
                int(d.ncontacts_ff),
                (int(d.solver.pressure_iters),
                 int(d.solver.divergence_iters)),
                np.asarray(w.fluids_state.positions)[alive],
                np.asarray(w.fluids_state.velocities)[alive])
    for layout in ("gather", "dense"):
        assert seen["torch", layout][:2] == seen["jax", layout][:2]
        np.testing.assert_allclose(seen["torch", layout][2],
                                   seen["jax", layout][2], rtol=0, atol=2e-6)
    assert seen["jax", "gather"][0] == 44488
    assert seen["jax", "dense"][0] == 43912
    for pkg in ("jax", "torch"):
        g, d = seen[pkg, "gather"], seen[pkg, "dense"]
        dpos = float(np.abs(g[2] - d[2]).max())
        dvel = float(np.abs(g[3] - d[3]).max())
        # Far beyond the 5e-4 m / 5e-3 m/s dense-vs-gather bounds.
        assert dpos > 1e-3 and dvel > 0.1, (pkg, dpos, dvel)
