"""The compact active-cell layout (``dense_compact=True``), run by both
packages on the CPU.

Mirrors ``tests/test_dense.py::test_dense_grid_mode_matches_compact`` and
``tests/test_fb_sparse.py::test_fb_sparse_gate``: the 2D dam break of
``test_dense.py`` on the compact layout steps in ``salva_tpu`` and in the
port from the same seeded inputs, held to identical iteration counts,
exact contact and overflow counts, positions within ``atol=2e-6`` (the
tolerance of ``tests/test_brute.py``), velocities and the solver state
within 2e-6 x max(1, their peak) and, under IISPH, velocities within 1e-5
and pressures within 2e-5 x their peak (ROADMAP Queue 3, item 8).
The JAX side pins ``use_pallas=False`` and ``dense_spill_auto=False``
(its auto tiers read the JAX backend). In the port the compact layout
runs the full-stencil plain folds over its neighbour tables on every
device, as the JAX package does.

Tier-1 holds the compact layout to the port's grid in 3D (the grid is
held to the JAX package by ``tests/test_torch_dam_break.py``), steps
each dense force under it, and checks its active-table overflow against
a count of the occupied cells; the 3D world against the JAX package is
``slow``. The helpers here (``layout_world``, ``run_pair``,
``check_against_jax``) also serve ``tests/test_torch_frozen_pairs.py`` and
``tests/test_torch_spill.py``.
"""

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.object.state import state_to_numpy

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

RADIUS = 0.05
DOMAIN_2D = ((-1.5, -0.5), (1.5, 2.0))
DOMAIN_3D = ((-0.6, -0.3, -0.6), (0.6, 1.0, 0.6))
DT = 1.0 / 200.0
STEPS = 6


def gravity(dim):
    return (0.0, -9.81) if dim == 2 else (0.0, -9.81, 0.0)


def block(dim, n, spacing, origin):
    """An n^dim lattice (or n[0] x n[1] ...) of the given spacing at
    ``origin`` (float32)."""
    n = [n] * dim if np.isscalar(n) else n
    grid = np.meshgrid(*[(np.arange(k) * spacing).astype(np.float32)
                         for k in n], indexing="ij")
    return np.stack(grid, -1).reshape(-1, dim) + np.float32(origin)


def floor(dim):
    """The 2D floor of ``tests/test_dense.py`` or the 3D floor of
    ``tests/test_spill.py``, one particle per 2 r, at y = -2 r."""
    if dim == 2:
        xs = np.arange(-1.2, 1.2, 2 * RADIUS, dtype=np.float32)
        return np.stack([xs, np.full_like(xs, -2 * RADIUS)], axis=-1)
    xs = np.arange(-0.5, 0.5, 2 * RADIUS, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    return np.stack([gx.ravel(), np.full(gx.size, -2 * RADIUS, np.float32),
                     gz.ravel()], axis=-1)


def layout_world(pkg, pos, solver="dfsph", caps=(None, None), fit_grid=True,
                 forces=(), **sim):
    """A dam break of the fluid ``pos`` over :func:`floor` in one package
    (``pkg``: "jax" or "torch", the port on the CPU), on the dense layout
    with ``sim`` set on its ``SimConfig``; ``forces``: the fluid's
    non-pressure forces, as (class name in ``forces.py``, kwargs) pairs.
    Returns (world, fluid handle, boundary handle)."""
    dim = pos.shape[1]
    if pkg == "jax":
        from salva_tpu import forces as force_mod
        from salva_tpu import world as mod
        from salva_tpu.config import DFSPHConfig, IISPHConfig

        sim = dict(dict(use_pallas=False, dense_spill_auto=False), **sim)
        kw = {}
    else:
        mod = force_mod = st
        from salva_tpu_torch.config import DFSPHConfig, IISPHConfig

        kw = dict(device="cpu")
        force_mod = st.forces
    cfg = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}[solver]()
    w = mod.LiquidWorld(solver=cfg, particle_radius=RADIUS, dim=dim,
                        domain=DOMAIN_2D if dim == 2 else DOMAIN_3D,
                        layout="dense", dense_cap=caps[0],
                        dense_cap_boundary=caps[1], fit_grid=fit_grid, **kw)
    w.sim = w.sim.replace(**sim)
    fl = w.add_fluid(mod.Fluid(pos, density0=1000.0, nonpressure_forces=[
        getattr(force_mod, name)(**args) for name, args in forces]))
    bd = w.add_boundary(mod.Boundary(floor(dim)))
    return w, fl, bd


def snapshot(w, fl):
    d = w.last_diagnostics
    state = w._solver_state
    return dict(
        pos=np.asarray(w.fluid_positions(fl)),
        vel=np.asarray(w.fluid_velocities(fl)),
        state=(state_to_numpy(state) if isinstance(state, torch.Tensor)
               else np.asarray(state)),
        iters=(int(d.solver.pressure_iters), int(d.solver.divergence_iters)),
        # (The gather layout reports no spill overflow: None.)
        counts={k: None if getattr(d, k) is None else int(getattr(d, k))
                for k in ("ncontacts_ff", "ncontacts_fb", "neighbor_overflow",
                          "candidate_overflow", "spill_overflow",
                          "spill_k_overflow")},
    )


def run_pair(pos, steps=STEPS, **kw):
    """Both packages' :func:`layout_world` stepped side by side; per-step
    snapshots and the two worlds."""
    wj, flj, _ = layout_world("jax", pos, **kw)
    wt, flt, _ = layout_world("torch", pos, **kw)
    out = dict(jax=[], torch=[], worlds=(wj, wt))
    g = gravity(pos.shape[1])
    for _ in range(steps):
        wj.step(DT, g)
        wt.step(DT, g)
        out["jax"].append(snapshot(wj, flj))
        out["torch"].append(snapshot(wt, flt))
    return out


def check_against_jax(runs, vel_atol=2e-6, state_atol=2e-6):
    """Identical iterations, exact contact / overflow / spill counts and
    positions within 2e-6 at every step; velocities within ``vel_atol``
    and the solver state within ``state_atol``, each x max(1, its peak)
    (a float32 ulp grows with the value)."""
    for j, t in zip(runs["jax"], runs["torch"]):
        assert t["iters"] == j["iters"]
        assert t["counts"] == j["counts"]
        np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=2e-6)
        for key, atol in (("vel", vel_atol), ("state", state_atol)):
            peak = max(1.0, float(np.abs(j[key]).max()))
            np.testing.assert_allclose(t[key], j[key], rtol=0,
                                       atol=atol * peak, err_msg=key)


def dam_block_2d():
    """``tests/test_dense.py::test_dense_grid_mode_matches_compact``'s 7 x 7
    block."""
    return block(2, 7, 2 * RADIUS, (-0.6, 0.02))


@pytest.fixture(scope="module")
def dfsph_runs():
    return run_pair(dam_block_2d(), dense_compact=True)


@pytest.fixture(scope="module")
def iisph_runs():
    return run_pair(dam_block_2d(), solver="iisph", dense_compact=True)


def test_compact_dfsph_matches_jax(dfsph_runs):
    check_against_jax(dfsph_runs)
    assert dfsph_runs["torch"][-1]["counts"]["ncontacts_fb"] > 0


def test_compact_iisph_matches_jax(iisph_runs):
    check_against_jax(iisph_runs, vel_atol=1e-5, state_atol=2e-5)


def test_compact_resolves_as_in_jax(dfsph_runs):
    """Same caps and window in both packages; no sparse fb table under the
    compact layout (``tests/test_fb_sparse.py:101``); the binning is the
    active-cell table."""
    wj, wt = dfsph_runs["worlds"]
    assert wt._auto_caps == wj._auto_caps
    assert wt._fitted_dims == wj._fitted_dims
    sim = wt._effective_sim()
    assert sim.dense_compact and sim.dense_fb_columns is None
    assert wj._effective_sim().dense_fb_columns is None
    ctx = dense_ctx(wt)
    assert ctx.compact and not ctx.sparse_b and ctx._fb_cols() == 0
    a_f = max(256, min(ctx.spec_f.num_cells,
                       int(wt.fluids_state.capacity * 0.25)))
    assert ctx.P.shape[-1] == ctx.sf.num_cells == a_f + 1


def dense_ctx(world, need_s2=True, **sim_overrides):
    """The DenseCtx the world's next step builds."""
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.step import _dense_config

    world._prepare()
    sim = world._boundary_volume_mode(world._effective_sim(), None)
    sim = sim.replace(**sim_overrides)
    spec_f, spec_b, _ = _dense_config(sim, world.solver_config,
                                      world._force_set)
    return DenseCtx(sim, spec_f, spec_b, world.fluids_state,
                    world.boundaries_state.clear_forces(), need_s2=need_s2)


@pytest.mark.parametrize("solver", ["dfsph", "iisph"])
def test_compact_matches_grid_3d(solver):
    """A 4^3 block over the 3D floor: the compact layout against the
    port's grid (same pairs, float32 summation order only), 3 steps, at
    caps that drop nothing (the auto boundary cap, 8, drops a floor entry:
    ROADMAP Queue 3, item 22)."""
    pos = block(3, 4, 2 * RADIUS, (-0.2, 0.1, -0.2))
    runs = []
    for compact in (False, True):
        w, fl, _ = layout_world("torch", pos, solver=solver, caps=(12, 16),
                                dense_compact=compact)
        snaps = []
        for _ in range(3):
            w.step(DT, gravity(3))
            snaps.append(snapshot(w, fl))
        runs.append(snaps)
    for g, c in zip(*runs):
        assert c["iters"] == g["iters"]
        assert c["counts"] == g["counts"]
        np.testing.assert_allclose(c["pos"], g["pos"], rtol=0, atol=2e-6)
        assert c["counts"]["neighbor_overflow"] == 0
    assert runs[1][-1]["counts"]["ncontacts_fb"] > 0


# The seven dense forces (as in tests/test_torch_package.py and the JAX
# package's scenes), and CustomForce, which has no dense form.
FORCES = {
    "XSPHViscosity": dict(fluid_viscosity_coefficient=0.5,
                          boundary_viscosity_coefficient=1.0),
    "ArtificialViscosity": dict(fluid_viscosity_coefficient=1.0,
                                boundary_viscosity_coefficient=0.1),
    "DFSPHViscosity": dict(viscosity_coefficient=0.5, max_viscosity_iter=1),
    "Akinci2013SurfaceTension": dict(fluid_tension_coefficient=1.0,
                                     boundary_adhesion_coefficient=10.0),
    "WCSPHSurfaceTension": dict(fluid_tension_coefficient=1.0,
                                boundary_tension_coefficient=0.5),
    "He2014SurfaceTension": dict(fluid_tension_coefficient=1.0,
                                 boundary_tension_coefficient=0.5),
    "Becker2009Elasticity": dict(young_modulus=1.0e5, poisson_ratio=0.3),
}


@pytest.mark.parametrize("force", sorted(FORCES))
def test_each_force_steps_under_compact(force):
    """Each dense force (its pair passes read the compact tables through
    ``DenseFields``; the elasticity is particle-wise) against the same
    force on the port's grid, 2 steps of the 2D block."""
    runs = []
    for compact in (False, True):
        w, fl, _ = layout_world("torch", dam_block_2d(),
                                forces=[(force, FORCES[force])],
                                dense_compact=compact)
        for _ in range(2):
            w.step(DT, gravity(2))
        runs.append(snapshot(w, fl))
        assert w._effective_sim().layout == "dense"
    grid, compact = runs
    assert compact["iters"] == grid["iters"]
    assert compact["counts"] == grid["counts"]
    assert np.isfinite(compact["pos"]).all()
    np.testing.assert_allclose(compact["pos"], grid["pos"], rtol=0,
                               atol=2e-6)


def test_custom_force_steps_with_compact_set():
    """A fluid carrying a ``CustomForce`` (no dense form) steps with
    ``dense_compact=True`` set, on the gather layout that ``auto``
    resolves it to, as the JAX package does."""
    from salva_tpu_torch.scenes import AttractorForce

    w = st.LiquidWorld(particle_radius=RADIUS, dim=2, domain=DOMAIN_2D,
                       device="cpu")
    w.sim = w.sim.replace(dense_compact=True)
    fl = w.add_fluid(st.Fluid(dam_block_2d(), density0=1000.0,
                              nonpressure_forces=[AttractorForce((1.0, 0.0))]))
    w.add_boundary(st.Boundary(floor(2)))
    for _ in range(2):
        w.step(DT, gravity(2))
    from salva_tpu_torch.step import _dense_config

    assert _dense_config(w._effective_sim(), w.solver_config,
                         w._force_set) is None
    assert np.isfinite(w.fluid_positions(fl)).all()


def test_active_table_overflow_counted():
    """An active-cell table smaller than the occupied cells: the cells past
    it are dropped and counted in ``neighbor_overflow``, with every
    particle of a dropped cell in the bin overflow (the count of occupied
    cells comes from the binning's cell ids)."""
    from salva_tpu_torch.geometry import dense_grid as tdg

    w = st.LiquidWorld(particle_radius=RADIUS, dim=2, layout="dense",
                       domain=((-3.0, -0.5), (3.0, 3.0)), device="cpu")
    w.sim = w.sim.replace(dense_compact=True, dense_active_ratio=0.1)
    # One particle a cell (spacing h): 24 x 12 = 288 occupied cells, past
    # the table's 256 columns (its floor).
    w.add_fluid(st.Fluid(block(2, [24, 12], 4 * RADIUS, (-2.3, 0.1))))
    w.add_boundary(st.Boundary(floor(2)))
    ctx = dense_ctx(w)
    cells, _ = tdg.cell_of(ctx.spec_f, w.fluids_state.positions,
                           origin=ctx.origin_dyn)
    cells = cells[w.fluids_state.alive]
    occupied = torch.unique(cells)
    A = ctx.sf.num_cells - 1
    assert len(occupied) > A
    assert int(ctx.binf.active_overflow) == len(occupied) - A
    kept = occupied[:A]
    dropped = int((~torch.isin(cells, kept)).sum())
    assert int(ctx.binf.overflow) == dropped
    assert int(ctx.bin_overflow) >= dropped + len(occupied) - A
    w.step(DT, gravity(2))
    assert int(w.last_diagnostics.neighbor_overflow) > 0


@pytest.mark.slow
def test_compact_matches_jax_3d():
    """The 5^3 block on the 3D compact layout against the JAX package."""
    check_against_jax(run_pair(block(3, 5, 2 * RADIUS, (-0.2, 0.1, -0.2)),
                               steps=4, dense_compact=True))
