"""The brute all-pairs tier of the port against the JAX package's, on the
CPU.

The brute tier (``layout="brute"``; ``geometry.dense_grid.brute_spec``)
replaces spatial binning with one exact masked capacity^2 pair block,
formulated as a 1D cyclic grid (offset k pairs cell c with cell
c + k mod C), and runs the full-stencil plain folds over it
(``solver/full_folds.py``; no hand kernel, as the JAX package runs no
Pallas kernel there). The JAX package runs the tier on the CPU only when
asked for (``tests/test_brute.py``), so both sides pin it.

The scene is ``tests/test_brute.py``'s ``_dam_world`` at ``n=5`` (a
lattice cube falling at 2 m/s onto a sampled floor in a static domain):
3D DFSPH, 3D IISPH, 3D DFSPH whose fluid carries
``ArtificialViscosity(1.0, 0.0)`` and ``XSPHViscosity(0.5, 1.0)``, and 2D
DFSPH, 10 steps each from identical inputs. Held to: the same resolved
configuration, identical pressure and divergence iterations on every
step, exact step-1 contact counts (both sides gate on ``r2 <= h^2`` over
bitwise-identical inputs), zero overflow, positions within ``atol=2e-6``
(``tests/test_brute.py``), velocities within 2e-6 (IISPH: 1e-5, the
bound ``tests/test_torch_iisph_dam_break.py`` holds them to, since its
Jacobi update divides by a difference of near-equal terms), boundary
volumes within ``rtol=1e-5``. One JAX and one port world per scenario,
shared by the module's tests.
"""

import numpy as np
import pytest
import torch

from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.object.state import state_from_numpy, state_to_numpy
from test_torch_dam_break import _jax_fields, _snapshot
from util import cube_positions

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

RADIUS = 0.05
DT = 1.0 / 200.0
STEPS = 10
N_SIDE = 5
FORCES = (("ArtificialViscosity", (1.0, 0.0)),
          ("XSPHViscosity", (0.5, 1.0)))
# scenario: (solver, fluid forces, dim, (velocity atol, solver-state
# atol x max(1, its peak))), the state bounds those of
# tests/test_torch_dam_break.py and tests/test_torch_iisph_dam_break.py.
SCENARIOS = {
    "dfsph_3d": ("dfsph", (), 3, (2e-6, 2e-6)),
    "iisph_3d": ("iisph", (), 3, (1e-5, 2e-5)),
    "dfsph_3d_forces": ("dfsph", FORCES, 3, (2e-6, 2e-6)),
    "dfsph_2d": ("dfsph", (), 2, (2e-6, 2e-6)),
}
# The resolved configuration fields both packages must agree on.
RESOLVED = ("layout", "dense_cap", "dense_cap_boundary", "brute_cells",
            "fitted_dims", "dense_fb_columns", "dense_spill_columns",
            "uniform_particles", "use_pallas")


def _package(jax_side):
    """(LiquidWorld, Fluid, Boundary, forces module, shapes module,
    shape_surface_sample, {solver name: config class}, world kwargs) of
    one package."""
    if jax_side:
        from salva_tpu import forces, shapes
        from salva_tpu.config import DFSPHConfig, IISPHConfig, NeighborConfig
        from salva_tpu.sampling import shape_surface_sample
        from salva_tpu.world import Boundary, Fluid, LiquidWorld

        kw = dict(neighbors=NeighborConfig(max_neighbors=64,
                                           max_candidates=224,
                                           query_chunk=65536))
    else:
        from salva_tpu_torch import forces, shapes
        from salva_tpu_torch.config import DFSPHConfig, IISPHConfig
        from salva_tpu_torch.sampling import shape_surface_sample
        from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

        kw = dict(device="cpu")
    return (LiquidWorld, Fluid, Boundary, forces, shapes,
            shape_surface_sample,
            {"dfsph": DFSPHConfig, "iisph": IISPHConfig}, kw)


def _dam_world(jax_side, layout="brute", solver="dfsph", forces=(), dim=3,
               n=N_SIDE):
    """``tests/test_brute.py``'s ``_dam_world`` in either package."""
    (LiquidWorld, Fluid, Boundary, force_mod, shapes, sample, solvers,
     kw) = _package(jax_side)
    if dim == 3:
        domain = ((-1.0, -0.4, -1.0), (1.0, 2.0, 1.0))
    else:
        domain = ((-1.0, -0.4), (1.0, 2.0))
    w = LiquidWorld(solver=solvers[solver](), particle_radius=RADIUS,
                    dim=dim, domain=domain, layout=layout, fit_grid=False,
                    **kw)
    pos = cube_positions(n, RADIUS, dim)
    pos[:, 1] += 0.4
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    w.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                      nonpressure_forces=[getattr(force_mod, name)(*args)
                                          for name, args in forces]))
    box = shapes.Cuboid((0.8, 0.1, 0.8) if dim == 3 else (0.8, 0.1))
    s = sample(box, RADIUS, dim)
    s[:, 1] -= 0.1
    w.add_boundary(Boundary(s))
    return w


@pytest.fixture(scope="module", params=list(SCENARIOS))
def runs(request):
    solver, forces, dim, tol = SCENARIOS[request.param]
    wj = _dam_world(True, solver=solver, forces=forces, dim=dim)
    wt = _dam_world(False, solver=solver, forces=forces, dim=dim)
    init = (_jax_fields(wj.fluids_state), _jax_fields(wj.boundaries_state),
            wt.fluids_state, wt.boundaries_state)
    resolved = (wj._effective_sim(), wt._effective_sim())
    g = (0.0, -9.81, 0.0)[:dim]
    jax_steps, torch_steps = [], []
    for _ in range(STEPS):
        wj.step(DT, g)
        wt.step(DT, g)
        jax_steps.append(_snapshot(wj, True))
        torch_steps.append(_snapshot(wt, False))
    return dict(init=init, resolved=resolved, jax=jax_steps,
                torch=torch_steps, tol=tol)


def test_initial_state_and_resolution_match(runs):
    fl_j, bd_j, fl_t, bd_t = runs["init"]
    for mine, theirs in ((fl_t, fl_j), (bd_t, bd_j)):
        ported = state_from_numpy(theirs, device="cpu")
        for name in theirs:
            torch.testing.assert_close(getattr(mine, name),
                                       getattr(ported, name), rtol=0,
                                       atol=0, msg=name)
    sim_j, sim_t = runs["resolved"]
    assert sim_t.layout == "brute"
    assert {k: getattr(sim_t, k) for k in RESOLVED} == {
        k: getattr(sim_j, k) for k in RESOLVED}


def test_iteration_counts_identical(runs):
    got = [(s["p_iters"], s["d_iters"]) for s in runs["torch"]]
    want = [(s["p_iters"], s["d_iters"]) for s in runs["jax"]]
    assert got == want


def test_contact_counts_exact_and_no_overflow(runs):
    keys = ("ncontacts_ff", "ncontacts_fb")
    j0, t0 = runs["jax"][0], runs["torch"][0]
    assert {k: t0[k] for k in keys} == {k: j0[k] for k in keys}
    assert t0["ncontacts_ff"] > 0
    for j, t in zip(runs["jax"], runs["torch"]):
        assert t["neighbor_overflow"] == j["neighbor_overflow"] == 0
        assert t["candidate_overflow"] == j["candidate_overflow"] == 0
        # Later steps: the lattice keeps pairs exactly at r = h (W(h) = 0),
        # where last-bit differences of the two trajectories round the
        # gate either way; tests/test_brute.py's tolerance.
        for k in keys:
            assert abs(t[k] - j[k]) <= max(16, 0.03 * max(t[k], j[k])), k


def test_positions_and_velocities_match(runs):
    vel_atol, state_atol = runs["tol"]
    for j, t in zip(runs["jax"], runs["torch"]):
        alive = j["fluids"]["alive"]
        np.testing.assert_array_equal(t["fluids"]["alive"], alive)
        for name, atol in (("positions", 2e-6),
                           ("velocities", vel_atol)):
            np.testing.assert_allclose(t["fluids"][name][alive],
                                       j["fluids"][name][alive],
                                       rtol=0, atol=atol, err_msg=name)
        want = state_from_numpy(j["solver"], device="cpu")
        peak = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(torch.from_numpy(t["solver"]), want,
                                   rtol=0, atol=state_atol * peak)
        np.testing.assert_allclose(t["max_density_ratio"],
                                   j["max_density_ratio"], rtol=1e-6)


def test_boundary_volumes_match(runs):
    for j, t in zip(runs["jax"], runs["torch"]):
        bj, bt = j["boundaries"], t["boundaries"]
        assert float(bj["volumes"].max()) > 0
        np.testing.assert_allclose(bt["volumes"], bj["volumes"], rtol=1e-5)
        np.testing.assert_allclose(bt["forces"], bj["forces"], rtol=0,
                                   atol=1e-4 * max(
                                       float(np.abs(bj["forces"]).max()),
                                       1e-30))


def test_brute_bin_roundtrip():
    """``tests/test_brute.py::test_brute_bin_roundtrip``, with the port's
    binding held to the JAX one field by field."""
    import jax.numpy as jnp
    from salva_tpu.geometry import dense_grid as jdg

    spec = tdg.brute_spec(100, cells=8)
    assert spec.brute and spec.dims == (8,) and spec.cap == 13
    jspec = jdg.brute_spec(100, cells=8)
    for name in ("origin", "dims", "cap", "cell_width", "brute"):
        assert getattr(spec, name) == getattr(jspec, name), name
    alive_np = np.arange(100) % 3 != 0
    alive = torch.from_numpy(alive_np)
    binned = tdg.bin_particles_brute(spec, alive)
    ref = jdg.bin_particles_brute(jspec, jnp.asarray(alive_np))
    for name in ("slot_of", "in_grid", "mask", "overflow", "clamped",
                 "grid_src"):
        np.testing.assert_array_equal(getattr(binned, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(binned.overflow) == 0 and int(binned.clamped) == 0
    assert int(binned.mask.sum()) == int(alive.sum())
    vals = torch.arange(100, dtype=torch.float32)
    grid = tdg.to_grid(spec, binned, vals, fill=-1.0)
    np.testing.assert_array_equal(
        grid.numpy(), np.asarray(jdg.to_grid(jspec, ref,
                                             jnp.asarray(vals.numpy()),
                                             fill=-1.0)))
    back = tdg.from_grid(spec, binned, grid, default=-7.0)
    kept = binned.in_grid.numpy()
    np.testing.assert_array_equal(back.numpy()[kept], vals.numpy()[kept])
    np.testing.assert_array_equal(kept, alive_np)
    (multi,) = tdg.to_grid_multi(spec, binned, [(vals, -1.0)])
    assert torch.equal(multi, grid)
    # A mis-sized spec (cap below capacity / cells) surfaces as overflow.
    tiny = tdg.DenseGridSpec(origin=(0.0,), dims=(8,), cap=2,
                             cell_width=1.0, brute=True)
    over = tdg.bin_particles_brute(tiny, torch.ones(100, dtype=torch.bool))
    assert int(over.overflow) == 100 - 16


def test_brute_determinism():
    """Bitwise reproducibility: identical inputs, identical bits (the
    identity binding has no sort, no scatter)."""
    runs = []
    for _ in range(2):
        w = _dam_world(False)
        for _ in range(5):
            w.step(DT, (0.0, -9.81, 0.0))
        runs.append(state_to_numpy(w.fluids_state))
    for name in ("positions", "velocities"):
        np.testing.assert_array_equal(runs[0][name], runs[1][name])


def test_brute_auto_resolution():
    """Explicit ``layout="brute"`` resolves with capacity-derived cyclic
    caps and no grid machinery, as in the JAX package; ``"auto"``
    resolves to brute only for a CUDA world under the ceilings (a CPU
    world keeps the grid, as the JAX package does on its CPU backend)."""
    w = _dam_world(False)
    sim = w._effective_sim()
    assert sim.layout == "brute"
    cells = sim.brute_cells
    assert sim.dense_cap == -(-w.fluids_state.capacity // cells)
    assert sim.dense_cap_boundary * cells >= w.boundaries_state.capacity
    assert sim.fitted_dims is None and sim.use_pallas is False
    wj = _dam_world(True)
    assert {k: getattr(sim, k) for k in RESOLVED} == {
        k: getattr(wj._effective_sim(), k) for k in RESOLVED}
    auto = _dam_world(False, layout="auto")
    assert auto._effective_sim().layout != "brute"
    assert not auto._brute_active()
    # The ceilings, on a world that names a CUDA device (only its device
    # type is read; nothing runs there).
    auto.device = torch.device("cuda")
    assert auto._brute_active()
    assert auto.fluids_state.capacity <= auto.sim.brute_max_particles
    auto.sim = auto.sim.replace(
        brute_max_particles=auto.fluids_state.capacity - 1)
    assert not auto._brute_active()
    auto.sim = auto.sim.replace(
        brute_max_particles=4096,
        brute_max_boundary=auto.boundaries_state.capacity - 1)
    assert not auto._brute_active()
