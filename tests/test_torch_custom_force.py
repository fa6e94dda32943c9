"""``CustomForce`` on the PyTorch port, against the JAX package on the CPU.

- custom_forces3's attractor (``scenes.AttractorForce``, two of them at
  (+-1, 0, 0), `examples3d/custom_forces3.rs:67-90`) on a fluid block
  without boundaries or gravity, in 2D and 3D, both packages' worlds 6
  steps: the world runs the gather layout (a custom force has no dense
  form), iterations identical on every step, positions within 2e-6 m and
  velocities within 2e-6 m/s.
- Layout resolution, as in the JAX package: with a ``domain``,
  ``layout="auto"`` resolves to the gather layout when a fluid carries a
  custom force, and ``layout="dense"`` (and ``"brute"``) raise.
- The mask: in a two-fluid world, a custom force on fluid 0 moves fluid 0
  only (``MaskedCustomForce``), and a force returning
  ``(accel, boundary_forces)`` feeds its boundary forces back.
"""

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.scenes import AttractorForce
from salva_tpu_torch.solver.nonpressure import CustomForce
from salva_tpu_torch.step import _dense_config

torch.set_num_threads(1)

RADIUS = 0.025  # custom_forces3's
DT = 1.0 / 200.0


def _world(pkg, dim, n=5):
    """custom_forces3's scene at n^dim particles (no boundary)."""
    if pkg == "jax":
        from salva_tpu.scenes import AttractorForce as Attractor
        from salva_tpu.scenes import cube_fluid
        from salva_tpu.world import Fluid, LiquidWorld

        w = LiquidWorld(particle_radius=RADIUS, dim=dim)
    else:
        from salva_tpu_torch.scenes import cube_fluid

        Attractor, Fluid = AttractorForce, st.Fluid
        w = st.LiquidWorld(particle_radius=RADIUS, dim=dim, device="cpu")
    pos = cube_fluid((n,) * dim, RADIUS)
    origins = [(1.0, 0.0, 0.0)[:dim], (-1.0, 0.0, 0.0)[:dim]]
    w.add_fluid(Fluid(pos, density0=1000.0, nonpressure_forces=[
        Attractor(o) for o in origins]))
    return w


@pytest.mark.parametrize("dim", [2, 3])
def test_attractor_world_matches_jax(dim):
    wj, wt = _world("jax", dim), _world("torch", dim)
    g = (0.0,) * dim
    for _ in range(6):
        wj.step(DT, g)
        wt.step(DT, g)
        sj, stt = wj.last_diagnostics.solver, wt.last_diagnostics.solver
        assert (stt.pressure_iters, stt.divergence_iters) == (
            int(sj.pressure_iters), int(sj.divergence_iters))
        np.testing.assert_allclose(wt.fluid_positions(0),
                                   wj.fluid_positions(0), rtol=0, atol=2e-6)
        np.testing.assert_allclose(wt.fluid_velocities(0),
                                   wj.fluid_velocities(0), rtol=0,
                                   atol=2e-6)
    # The attractors pulled the block apart along x.
    assert float(np.abs(wt.fluid_velocities(0)[:, 0]).max()) > 1e-3
    assert _dense_config(wt._effective_sim(), wt.solver_config,
                         wt._force_set) is None


def _domain_world(layout, forces, dim=2, second=False):
    w = st.LiquidWorld(particle_radius=0.05, dim=dim, layout=layout,
                       domain=((-1.5, -0.5), (1.5, 2.0)), device="cpu")
    ax = np.arange(4) * 0.1
    pos = np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)
    w.add_fluid(st.Fluid(pos.astype(np.float32) + np.float32(0.3),
                         nonpressure_forces=forces))
    if second:
        w.add_fluid(st.Fluid(pos.astype(np.float32) - np.float32(0.6)))
    xs = np.arange(-1.2, 1.2, 0.1, dtype=np.float32)
    w.add_boundary(st.Boundary(np.stack([xs, np.full_like(xs, -0.1)], -1)))
    return w


def test_custom_force_resolves_to_gather_and_refuses_dense():
    w = _domain_world("auto", [AttractorForce((1.0, 0.0))])
    w.step(DT, (0.0, -9.81))
    assert _dense_config(w._effective_sim(), w.solver_config,
                         w._force_set) is None
    assert int(w.last_diagnostics.ncontacts_ff) > 0
    assert np.isfinite(w.fluid_positions(0)).all()
    for layout in ("dense", "brute"):
        w = _domain_world(layout, [AttractorForce((1.0, 0.0))])
        with pytest.raises(ValueError, match="no dense implementation"):
            w.step(DT, (0.0, -9.81))
    # Without the custom force the same world runs the dense layout.
    w = _domain_world("dense", [])
    w.step(DT, (0.0, -9.81))
    assert _dense_config(w._effective_sim(), w.solver_config,
                         w._force_set) is not None


class _Push(CustomForce):
    """A constant push on every particle, with a boundary force."""

    def apply(self, ctx):
        accel = torch.zeros_like(ctx.fluids.positions)
        accel[:, 0] = 3.0
        bforces = torch.full_like(ctx.boundaries.forces, 0.5)
        return accel, bforces


def test_mask_restricts_the_force_to_its_fluid():
    g = (0.0, 0.0)
    pushed = _domain_world("gather", [_Push()], second=True)
    plain = _domain_world("gather", [], second=True)
    pushed.step(DT, g)
    plain.step(DT, g)
    # Fluid 1 is far from fluid 0 and the boundary moves nobody: fluid 1
    # steps exactly as without the force; fluid 0 moves 3 m/s^2 x dt^2
    # further along x (DFSPH integrates x += (v + dv) dt).
    np.testing.assert_array_equal(pushed.fluid_positions(1),
                                  plain.fluid_positions(1))
    dx = pushed.fluid_positions(0) - plain.fluid_positions(0)
    np.testing.assert_allclose(dx[:, 0], 3.0 * DT * DT, rtol=1e-2)
    np.testing.assert_allclose(dx[:, 1], 0.0, atol=1e-7)
    alive = pushed.boundaries_state.alive
    f_push = pushed.boundaries_state.forces[alive]
    f_plain = plain.boundaries_state.forces[alive]
    torch.testing.assert_close(f_push - f_plain,
                               torch.full_like(f_push, 0.5))
