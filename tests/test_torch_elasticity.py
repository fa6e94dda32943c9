"""The Becker 2009 elasticity of the PyTorch port against the JAX package,
on the CPU.

- ``build_elasticity_state``: each package's world captures the rest
  state of an elasticity3-like pair of blocks (2D and 3D, with a third,
  inelastic fluid and dead slots): the rest table ``j`` / ``valid`` and
  ``positions0`` exact, ``volumes0``, ``rest_w`` and ``rest_grad`` within
  1e-6 of their peaks.
- ``_polar_rotation`` on rest (symmetric, repeated singular values),
  rotated, sheared and near-zero APQ matrices: the rotations within 1e-5,
  each orthonormal with determinant 1 (``torch.linalg.svd`` and JAX's SVD
  choose other singular-vector signs; the rotation does not depend on
  them).
- ``apply_particles``, linear and Green strain, 2D and 3D, on the rest
  state moved by a rigid rotation plus a seeded deformation: within 1e-4
  of the peak acceleration (the float32 SVD and the packages' einsum
  orders), and zero on the inelastic fluid.
- The two-block world (elasticity3's two Young moduli, Green strain, the
  elasticity scenes' XSPH; 3D, blocks of 6 x 3 x 6) on the dense layout
  (``ParticleWiseForce`` beside the pair passes) and on the gather layout
  against JAX, 4 steps: identical iterations, positions within 2e-6 m.
- ``tests/test_dense.py``'s elasticity case (``_force_world``, 10 steps)
  between the port's two layouts, at that test's bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.solver import elasticity as jel
from salva_tpu_torch.object.state import state_from_numpy
from salva_tpu_torch.solver import elasticity as tel
from util import cube_positions

torch.set_num_threads(1)

RADIUS = 0.05
DT = 1.0 / 200.0
BLOCKS = ((500_000.0, 1.0), (100_000.0, 4.0))  # elasticity3's blocks


def _world(pkg, dim, layout, n=3, nonlinear=True, third=True):
    """Two elastic blocks over a floor (elasticity3's arrangement, cut to
    blocks of 2n x n (x 2n)), and optionally a small inelastic block."""
    lo, hi = (-0.8, -0.2, -0.8), (0.8, 1.8, 0.8)
    domain = (lo[:dim], hi[:dim])
    if pkg == "jax":
        from salva_tpu import forces as fz
        from salva_tpu.scenes import cube_fluid
        from salva_tpu.world import Boundary, Fluid, LiquidWorld

        w = LiquidWorld(particle_radius=RADIUS, dim=dim, domain=domain,
                        layout=layout)
        if layout == "dense":
            w.sim = w.sim.replace(use_pallas=False, dense_spill_auto=False,
                                  dense_compact=False)
    else:
        from salva_tpu_torch import Boundary, Fluid, LiquidWorld
        from salva_tpu_torch import forces as fz
        from salva_tpu_torch.scenes import cube_fluid

        w = LiquidWorld(particle_radius=RADIUS, dim=dim, domain=domain,
                        layout=layout, device="cpu")
    shape = (2 * n, n, 2 * n)[:dim] if dim == 3 else (2 * n, n)
    for young, lift in BLOCKS:
        pos = cube_fluid(shape, RADIUS)
        pos[:, 1] += 0.2 + RADIUS * n * lift + 0.1
        w.add_fluid(Fluid(pos, density0=1000.0, nonpressure_forces=[
            fz.Becker2009Elasticity(young, 0.3, nonlinear),
            fz.XSPHViscosity(0.5, 1.0),
        ]))
    if third:
        pos = cube_positions(2, RADIUS, dim, origin=(0.8,) + (0.5,) * (
            dim - 1))
        w.add_fluid(Fluid(pos, density0=1000.0))
    xs = np.arange(-0.6, 0.6, 2 * RADIUS, dtype=np.float32)
    if dim == 3:
        g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
        floor = np.stack([g[:, 0], np.full(len(g), 0.1, np.float32),
                          g[:, 1]], -1)
    else:
        floor = np.stack([xs, np.full_like(xs, 0.1)], -1)
    w.add_boundary(Boundary(floor.astype(np.float32)))
    return w


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * peak,
                               err_msg=what)


@pytest.fixture(scope="module")
def rest_states():
    out = {}
    for dim in (2, 3):
        wj, wt = _world("jax", dim, "gather"), _world("torch", dim, "gather")
        wj._prepare()
        wt._prepare()
        out[dim] = (wj, wt)
    return out


@pytest.mark.parametrize("dim", [2, 3])
def test_rest_state_matches(rest_states, dim):
    wj, wt = rest_states[dim]
    ej, et = wj._elasticity_state, wt._elasticity_state
    for f in ("rest_j", "rest_valid", "positions0"):
        np.testing.assert_array_equal(_np(getattr(et, f)),
                                      _np(getattr(ej, f)), err_msg=f)
    for f in ("volumes0", "rest_w", "rest_grad"):
        _close(getattr(et, f), getattr(ej, f), 1e-6, f)
    # The inelastic fluid and the dead slots have empty rows.
    fid = wt.fluids_state.fluid_id.numpy()
    alive = wt.fluids_state.alive.numpy()
    empty = ~et.rest_valid.numpy().any(axis=1)
    assert empty[(fid == 2) | ~alive].all() and not empty[
        (fid < 2) & alive].any()
    assert (et.volumes0.numpy()[(fid < 2) & alive] > 0).all()


def _rotation(dim, angle):
    c, s = np.cos(angle), np.sin(angle)
    if dim == 2:
        return np.array([[c, -s], [s, c]])
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)],
         [0.0, np.sin(0.3), np.cos(0.3)]])


@pytest.mark.parametrize("dim", [2, 3])
def test_polar_rotation_matches(dim):
    rng = np.random.default_rng(dim)
    eye = np.eye(dim)
    shear = eye.copy()
    shear[0, 1] = 0.4
    mats = [
        0.37 * eye,  # rest: repeated singular values
        np.diag(np.arange(1.0, dim + 1.0)),  # symmetric, distinct
        _rotation(dim, 0.7) @ np.diag(np.linspace(0.8, 1.3, dim)),
        _rotation(dim, -1.1) @ shear,
        -eye,  # a reflection: the det fix
        1e-8 * rng.normal(size=(dim, dim)),  # near zero: identity
    ] + [rng.normal(size=(dim, dim)) for _ in range(20)]
    a = np.stack(mats).astype(np.float32)
    got = tel._polar_rotation(torch.tensor(a), dim).numpy()
    want = np.asarray(jel._polar_rotation(jnp.asarray(a), dim))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], eye, atol=1e-6)
    np.testing.assert_allclose(got[5], eye, atol=0)
    for r in got:
        np.testing.assert_allclose(r @ r.T, eye, atol=1e-5)
        assert abs(np.linalg.det(r) - 1.0) < 1e-5


@pytest.mark.parametrize("nonlinear", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_apply_particles_matches(rest_states, dim, nonlinear):
    wj, wt = rest_states[dim]
    fl = wt.fluids_state
    rng = np.random.default_rng(dim + 2 * nonlinear)
    pos = fl.positions.numpy().astype(np.float64)
    rot = _rotation(dim, 0.4)
    moved = pos @ rot.T + 0.01 * rng.normal(size=pos.shape)
    moved = np.where(fl.alive.numpy()[:, None], moved, pos).astype(
        np.float32)
    fields = {k: _np(v) for k, v in dict(
        positions=moved, velocities=fl.velocities, volumes=fl.volumes,
        density0=fl.density0, alive=fl.alive, fluid_id=fl.fluid_id,
        memberships=fl.memberships, filter=fl.filter).items()}
    fields["memberships"] = fields["memberships"].astype(np.uint32)
    fields["filter"] = fields["filter"].astype(np.uint32)
    coeffs = [jel.elasticity_coefficients(e, 0.3) for e, _ in BLOCKS]
    kw = dict(d0=tuple(c[0] for c in coeffs) + (0.0,),
              d1=tuple(c[1] for c in coeffs) + (0.0,),
              d2=tuple(c[2] for c in coeffs) + (0.0,),
              nonlinear=(int(nonlinear),) * 2 + (0,), active=(1, 1, 0))
    from salva_tpu.object.state import FluidsState as JF

    want = jel.Becker2009ElasticityForce(**kw).apply_particles(
        JF(**{k: jnp.asarray(v) for k, v in fields.items()}),
        wj._elasticity_state, dim)
    got = tel.Becker2009ElasticityForce(**kw).apply_particles(
        state_from_numpy(fields, device="cpu"), wt._elasticity_state, dim)
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 1.0  # a real deformation
    _close(got, want, 1e-4, "accel")
    assert not np.any(got.numpy()[fields["fluid_id"] == 2])


@pytest.fixture(scope="module", params=["gather", "dense"])
def two_block_runs(request):
    layout = request.param
    wj, wt = _world("jax", 3, layout, third=False), _world(
        "torch", 3, layout, third=False)
    out = []
    for _ in range(4):
        for w in (wj, wt):
            w.step(DT, (0.0, -9.81, 0.0))
        s = [w.last_diagnostics.solver for w in (wj, wt)]
        out.append(dict(
            iters=[(int(x.pressure_iters), int(x.divergence_iters))
                   for x in s],
            pos=[_np(w.fluids_state.positions) for w in (wj, wt)],
            alive=_np(wt.fluids_state.alive)))
    return layout, wt, out


def test_two_block_world_matches_jax(two_block_runs):
    layout, wt, out = two_block_runs
    from salva_tpu_torch.step import _dense_config

    dense = _dense_config(wt._effective_sim(), wt.solver_config,
                          wt._force_set)
    assert (dense is None) == (layout == "gather")
    if dense is not None:
        assert type(dense[2][0]).__name__ == "ParticleWiseForce"
    for step in out:
        assert step["iters"][0] == step["iters"][1]
        a = step["alive"]
        np.testing.assert_allclose(step["pos"][1][a], step["pos"][0][a],
                                   rtol=0, atol=2e-6)


def test_dense_elasticity_matches_port_gather():
    """``tests/test_dense.py``'s ``_force_world`` with
    ``Becker2009Elasticity(50_000.0, 0.3, True)``, 10 steps on each of the
    port's layouts, held to that test's bounds."""
    from salva_tpu_torch import (Boundary, DFSPHConfig, Fluid, LiquidWorld,
                                 NeighborConfig)
    from salva_tpu_torch import forces as fz

    def build(layout):
        w = LiquidWorld(
            solver=DFSPHConfig(), particle_radius=RADIUS, dim=2,
            neighbors=NeighborConfig(max_neighbors=64, max_candidates=160,
                                     query_chunk=4096),
            domain=((-1.5, -0.5), (1.5, 2.0)), layout=layout,
            fit_grid=False, device="cpu")
        pos = cube_positions(6, RADIUS, 2, origin=(-0.3, 0.02))
        w.add_fluid(Fluid(pos, density0=1000.0, nonpressure_forces=[
            fz.Becker2009Elasticity(50_000.0, 0.3, True)]))
        xs = np.arange(-1.2, 1.2, 2 * RADIUS, dtype=np.float32)
        w.add_boundary(Boundary(np.stack(
            [xs, np.full_like(xs, -2 * RADIUS)], axis=-1)))
        return w

    wg, wd = build("gather"), build("dense")
    for _ in range(10):
        wg.step(DT, (0.0, -9.81))
        wd.step(DT, (0.0, -9.81))
    pd = wd.fluid_positions(0)
    assert np.isfinite(pd).all()
    np.testing.assert_allclose(wg.fluid_positions(0), pd, atol=1e-3)
    np.testing.assert_allclose(
        wg.boundaries_state.forces.numpy().sum(axis=0),
        wd.boundaries_state.forces.numpy().sum(axis=0), rtol=5e-2, atol=2.0)
