"""Adaptive CFL substepping and the debug checks of the PyTorch port,
against the JAX package on the CPU.

- ``_cfl_vmax`` on seeded velocities with dead slots, in the first-substep
  (gravity) and the velocity-change form, 2D and 3D: equal to the JAX
  package's bit for bit (both cast ``inv_prev_dt`` and the remaining time
  to float32 before the fold).
- ``LiquidWorld(adaptive_timestep=True)``: the 7^3 dense dam break of
  ``tests/test_torch_dam_break.py`` at dt = 1/30 and a 2D block thrown at
  4 m/s on the gather layout at dt = 1/60: identical substep counts
  (``counters.nsubsteps``) and iterations on every step, at least one step
  split, positions within 2e-6 m.
- ``debug_checks``: a planted NaN raises ``FloatingPointError``; an
  undersized neighbour table warns with the JAX package's text on every
  step, and an overflowing auto cap tier warns that it grew.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import world as tworld
from test_torch_dam_break import RADIUS, _scene

torch.set_num_threads(1)

POS_ATOL = 2e-6
GRAVITY3 = (0.0, -9.81, 0.0)


def _vmax_inputs(dim, seed):
    rng = np.random.default_rng(seed)
    n = 257
    vel = rng.normal(0.0, 2.0, (n, dim)).astype(np.float32)
    prev = (vel + rng.normal(0.0, 0.05, (n, dim))).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    # The fastest slot is dead: it must not count.
    vel[np.flatnonzero(~alive)[0]] = 100.0
    gravity = np.array([0.0, -9.81, 0.0][:dim], np.float32)
    return vel, prev, alive, gravity


@pytest.mark.parametrize("first_substep", [True, False],
                         ids=["gravity", "velocity_change"])
@pytest.mark.parametrize("dim", [2, 3])
def test_cfl_vmax_matches_jax(dim, first_substep):
    from salva_tpu.world import _cfl_vmax as jax_vmax

    vel, prev, alive, gravity = _vmax_inputs(dim, seed=dim)
    # inv_prev_dt and the remaining time as the step loop makes them
    # (Python doubles of a CFL substep that float32 does not hold).
    inv_prev_dt = 0.0 if first_substep else 1.0 / (0.0123456789 / 3.0)
    t_rem = 1.0 / 60.0 - 0.0041152263
    want = float(jax_vmax(jnp.asarray(vel), jnp.asarray(prev),
                          jnp.asarray(alive), jnp.asarray(gravity),
                          jnp.float32(inv_prev_dt), jnp.float32(t_rem)))
    got = float(tworld._cfl_vmax(torch.tensor(vel), torch.tensor(prev),
                                 torch.tensor(alive), torch.tensor(gravity),
                                 inv_prev_dt, t_rem))
    assert got == want
    assert got < 100.0  # the dead slot is excluded


def _dam_worlds(adaptive=True):
    """The 7^3 dense dam break of test_torch_dam_break in both packages."""
    from salva_tpu import shapes as jshapes
    from salva_tpu.config import DFSPHConfig
    from salva_tpu.sampling import shape_surface_sample as jsample
    from salva_tpu.scenes import cube_fluid as jcube
    from salva_tpu.world import Boundary, Fluid, LiquidWorld

    domain, pos, vel, floor = _scene(jshapes, jsample, jcube)
    jw = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=3,
                     domain=domain, layout="dense",
                     adaptive_timestep=adaptive)
    jw.sim = jw.sim.replace(use_pallas=False, dense_spill_auto=False,
                            dense_compact=False)
    jw.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    jw.add_boundary(Boundary(floor))
    tw = st.LiquidWorld(solver=st.DFSPHConfig(), particle_radius=RADIUS,
                        dim=3, domain=domain, layout="dense",
                        adaptive_timestep=adaptive, device="cpu")
    tw.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel))
    tw.add_boundary(st.Boundary(floor))
    return jw, tw


def _thrown_block_worlds():
    """A 2D 6x6 block thrown sideways at 4 m/s, no domain (the gather
    layout), as tests/test_timestep.py's adaptive world."""
    from salva_tpu.config import DFSPHConfig, NeighborConfig
    from salva_tpu.world import Fluid, LiquidWorld

    xs = (np.arange(6) * 2.0 * RADIUS).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    vel = np.tile(np.array([4.0, 0.0], np.float32), (len(pos), 1))
    nb = dict(max_neighbors=40, max_candidates=128, query_chunk=4096)
    jw = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=2,
                     neighbors=NeighborConfig(**nb), adaptive_timestep=True)
    jw.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    tw = st.LiquidWorld(particle_radius=RADIUS, dim=2,
                        neighbors=st.NeighborConfig(**nb),
                        adaptive_timestep=True, device="cpu")
    tw.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel))
    return jw, tw


def _step_record(w):
    s = w.last_diagnostics.solver
    return (w.counters.nsubsteps, int(s.pressure_iters),
            int(s.divergence_iters))


@pytest.mark.parametrize("case", ["dense_3d", "gather_2d"])
def test_adaptive_steps_match_jax(case):
    if case == "dense_3d":
        (jw, tw), dt, gravity, steps = _dam_worlds(), 1.0 / 30.0, GRAVITY3, 2
    else:
        (jw, tw), dt, gravity, steps = (_thrown_block_worlds(), 1.0 / 60.0,
                                        (0.0, -9.81), 3)
    assert tw.timestep_manager.adaptive
    rec_j, rec_t = [], []
    for _ in range(steps):
        jw.step(dt, gravity)
        tw.step(dt, gravity)
        rec_j.append(_step_record(jw))
        rec_t.append(_step_record(tw))
        np.testing.assert_allclose(
            tw.fluids_state.positions.numpy(),
            np.asarray(jw.fluids_state.positions), rtol=0, atol=POS_ATOL)
    assert rec_t == rec_j
    assert max(r[0] for r in rec_t) > 1, rec_t  # a step split
    # The last CFL substep from speeds that agree to float32 rounding.
    assert tw.timestep_manager.dt == pytest.approx(
        jw.timestep_manager.dt, rel=1e-5)


def test_debug_checks_raise_on_nan():
    """A planted NaN in a live position raises after the step; the check
    reads live slots only."""
    w = st.LiquidWorld(particle_radius=RADIUS, dim=2, device="cpu")
    xs = (np.arange(5) * 0.1).astype(np.float32)
    w.add_fluid(st.Fluid(np.stack(np.meshgrid(xs, xs, indexing="ij"),
                                  -1).reshape(-1, 2)))
    w.debug_checks = True
    w.step(1.0 / 200.0, (0.0, -9.81))
    fl = w.fluids_state
    dead = int(torch.nonzero(~fl.alive)[0])
    for slot, raises in ((dead, False), (0, True)):
        w.fluids_state = fl.replace(positions=st.world.set_rows(
            fl.positions, torch.tensor([slot]), float("nan")))
        if raises:
            with pytest.raises(FloatingPointError, match="non-finite"):
                w.step(1.0 / 200.0, (0.0, -9.81))
        else:
            w._run_debug_checks()


def _caught(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught
            if "overflow" in str(w.message)]


def test_debug_checks_warn_on_overflow_as_jax():
    """An undersized neighbour table (max_neighbors=2) warns on every
    debug-checked step with the JAX package's text; the interval checks
    (debug off) warn on the first step only."""
    from salva_tpu.config import NeighborConfig
    from salva_tpu.world import Fluid, LiquidWorld

    xs = (np.arange(6) * 2.0 * RADIUS).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    nb = dict(max_neighbors=2, max_candidates=16, query_chunk=4096)
    jw = LiquidWorld(particle_radius=RADIUS, dim=2,
                     neighbors=NeighborConfig(**nb))
    jw.add_fluid(Fluid(pos, density0=1000.0))
    tw = st.LiquidWorld(particle_radius=RADIUS, dim=2,
                        neighbors=st.NeighborConfig(**nb), device="cpu")
    tw.add_fluid(st.Fluid(pos, density0=1000.0))
    for w in (jw, tw):
        w.debug_checks = True
    for _ in range(2):
        got = _caught(lambda: tw.step(1.0 / 200.0, (0.0, -9.81)))
        want = _caught(lambda: jw.step(1.0 / 200.0, (0.0, -9.81)))
        assert got == want and any("neighbor capacity" in m for m in got)
    tw.debug_checks = False
    assert _caught(lambda: tw.step(1.0 / 200.0, (0.0, -9.81))) == []


def test_debug_checks_grow_the_auto_cap():
    """On the dense layout an overflow of the auto cap tier warns that the
    cap grew (the JAX package's ``_bump_auto_dense_cap`` and text), and
    the next step resolves the larger tier."""
    w = st.LiquidWorld(particle_radius=RADIUS, dim=2,
                       domain=((-1.0, -0.4), (1.0, 1.5)), layout="dense",
                       device="cpu")
    # 25 particles packed into each 0.2 m cell: over the tier of 16.
    xs = (np.arange(10) * 0.04 + 0.001).astype(np.float32)
    w.add_fluid(st.Fluid(np.stack(np.meshgrid(xs, xs, indexing="ij"),
                                  -1).reshape(-1, 2)))
    w.debug_checks = True
    msgs = _caught(lambda: w.step(1e-4, (0.0, 0.0)))
    assert int(w.last_diagnostics.neighbor_overflow) > 0
    assert msgs[0].endswith(" entries dropped — auto-grew the dense "
                            "cap/spill sizing for subsequent steps"), msgs
    assert w._auto_caps[0] == 24
    w.step(1e-4, (0.0, 0.0))
    assert w._effective_sim().dense_cap >= 24
