"""The dense viscosity forces of the PyTorch port against the JAX package.

- ``XSPHViscosityDense`` and ``ArtificialViscosityDense`` of both
  packages on the same numpy grids (2D and 3D; two fluids, of which only
  fluid 0 carries the force, so the same-fluid gates and the per-fluid
  coefficients are exercised; random velocities, so the artificial
  viscosity's approaching-pair gate ``v.r < 0`` goes both ways): the
  acceleration and the boundary feedback within 1e-5 of each output's
  peak (float32 summation order only; both evaluate the same pair terms).
  The cases are those of ``tests/test_dense.py``'s force tests,
  ``XSPHViscosity(0.5, 0.5)`` and ``ArtificialViscosity(0.5, 0.3)``, plus
  an artificial viscosity with a nonzero beta.
- The 7^3 dam break of ``tests/test_torch_dam_break.py`` with one fluid
  carrying ``ArtificialViscosity(1.0, 0.0)`` (the ``basic3`` scene's) and
  ``XSPHViscosity(0.5, 1.0)`` (the elasticity scenes'), whose nonzero
  boundary coefficient drives the fluid-boundary and boundary-fluid
  passes, under DFSPH and IISPH, 6 steps against JAX: identical
  iteration counts, exact contact and overflow counts, positions within
  2e-6 m, the boundary forces as ``check_boundary_volumes_and_forces``
  holds them, and for IISPH the velocity and pressure tolerances of its
  parity test (1e-5 m/s and 2e-5 x peak; its Jacobi update amplifies
  last-ulp differences). One JAX and one port world per solver, shared
  by the module's tests. Compare trajectories only from identical
  inputs: the artificial viscosity's gate flips on exact lattice ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.geometry import dense_grid as jdg
from salva_tpu.solver import forces_dense as jfd
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.solver import forces_dense as tfd
from test_torch_dam_break import (
    check_boundary_volumes_and_forces,
    check_contact_and_overflow_counts,
    check_iteration_counts,
    check_positions_and_velocities,
    check_resolved_layout,
    check_scene_and_initial_state,
    run_both,
)

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

H = 0.2
DT = 1.0 / 200.0
FIELD_ATOL = 1e-5  # x each output's peak

# (dense class, fluid 0's coefficients as the world merges them for two
# fluids: fluid 1 carries no force, so its coefficients are the defaults).
FORCE_CASES = {
    "xsph": ("XSPHViscosityDense", dict(
        fluid_coefficients=(0.5, 0.0), boundary_coefficients=(0.5, 0.0))),
    "artificial": ("ArtificialViscosityDense", dict(
        fluid_coefficients=(0.5, 0.0), boundary_coefficients=(0.3, 0.0),
        alphas=(1.0, 1.0), betas=(0.0, 0.0), speeds_of_sound=(10.0, 10.0))),
    "artificial_beta": ("ArtificialViscosityDense", dict(
        fluid_coefficients=(0.5, 0.0), boundary_coefficients=(0.3, 0.0),
        alphas=(0.8, 1.0), betas=(0.2, 0.0), speeds_of_sound=(12.0, 10.0))),
}


def _grids(dim):
    """Numpy grids of a clustered two-fluid block over a moving boundary
    layer, binned by the port (full-grid binning for both sides)."""
    rng = np.random.default_rng(31 + dim)
    lo, hi = 0.0, 0.8
    n = 160 if dim == 3 else 60
    pos = rng.uniform(lo, hi, size=(n, dim))
    # A cluster around a cell corner: cells of up to ~16 particles.
    pos[: n // 4] = 0.4 + rng.uniform(-0.08, 0.08, size=(n // 4, dim))
    vel = rng.normal(size=(n, dim))
    fid = (np.arange(n) % 3 == 0).astype(np.int32)  # fluids 0 and 1
    vol = rng.uniform(0.8e-3, 1.2e-3, size=n)
    rho0 = np.where(fid == 0, 1000.0, 800.0)
    rho = rho0 * rng.uniform(0.95, 1.1, size=n)
    ticks = np.arange(0.05, hi, 0.1)
    grid_b = np.stack(np.meshgrid(*([ticks] * (dim - 1)), indexing="ij"),
                      axis=-1).reshape(-1, dim - 1)
    bpos = np.insert(grid_b, 1, 0.3, axis=1)
    bpos = bpos + rng.uniform(-0.01, 0.01, size=bpos.shape)
    nb = len(bpos)
    bvel = rng.normal(size=(nb, dim))
    bvol = rng.uniform(1e-3, 2e-3, size=nb)

    spec = tdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=24)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    binf = tdg.bin_particles(spec, f32(pos), torch.ones(n, dtype=torch.bool))
    binb = tdg.bin_particles(spec.replace(cap=8), f32(bpos),
                             torch.ones(nb, dtype=torch.bool))
    assert int(binf.overflow) == 0 and int(binb.overflow) == 0
    P, V, VOL, R0, RHO = tdg.to_grid_multi(spec, binf, [
        (f32(pos), tdg.POS_SENTINEL), (f32(vel), 0.0), (f32(vol), 0.0),
        (f32(rho0), 1.0), (f32(rho), 1.0)])
    Pb, Vbvel, Volb = tdg.to_grid_multi(spec, binb, [
        (f32(bpos), tdg.POS_SENTINEL), (f32(bvel), 0.0), (f32(bvol), 0.0)])
    FID = tdg.to_grid(spec, binf, torch.from_numpy(fid), fill=-1)
    g = dict(P=P, V=V, M=VOL * R0, VOL=VOL, R0=R0, RHO=RHO, FID=FID,
             maskf=binf.mask, Pb=Pb, Vbvel=Vbvel, Volb=Volb,
             maskb=binb.mask)
    return spec, {k: v.numpy() for k, v in g.items()}


def _fields(pkg, spec, g, kernels=("cubic", "cubic")):
    """``pkg``'s DenseFields over the numpy grids ``g`` (roll views), with
    the SPH kernels ``kernels`` (density, gradient)."""
    if pkg == "jax":
        dg, fd, arr = jdg, jfd, jnp.asarray
        spec = jdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                                 spec.cell_width)
    else:
        dg, fd, arr = tdg, tfd, torch.from_numpy
    offs = dg.neighbor_offsets(spec.dim)

    def roll(a, o):
        return dg.shift_j(spec, a, offs[o])

    return fd.DenseFields(
        jff=roll, jfb=roll, jbf=roll, n_offsets=len(offs),
        **{k: arr(v) for k, v in g.items()}, h=H, dim=spec.dim,
        dt=arr(np.array(DT, np.float32)),
        inv_dt=arr(np.array(1.0 / DT, np.float32)),
        kernel_density=kernels[0], kernel_gradient=kernels[1],
    )


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def grids(request):
    return _grids(request.param)


@pytest.mark.parametrize("case", list(FORCE_CASES))
def test_dense_force_matches_jax(grids, case):
    spec, g = grids
    cls, kw = FORCE_CASES[case]
    want = getattr(jfd, cls)(**kw).apply(_fields("jax", spec, g))
    got = getattr(tfd, cls)(**kw).apply(_fields("torch", spec, g))
    for name, a, b in zip(("accel", "boundary feedback"), got, want):
        b = np.asarray(b)
        peak = float(np.abs(b).max())
        assert peak > 0, f"{name} is zero: the case exercises nothing"
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=FIELD_ATOL * peak, err_msg=name)
    # Only fluid 0 carries the force: fluid 1's live slots get nothing.
    other = g["FID"] == 1
    assert other.any()
    assert not np.abs(got[0].numpy()[:, other]).any()


# The dam break's fluid forces: basic3's artificial viscosity and the
# elasticity scenes' XSPH, as (class name in forces.py, kwargs).
DAM_BREAK_FORCES = (
    ("ArtificialViscosity", dict(fluid_viscosity_coefficient=1.0,
                                 boundary_viscosity_coefficient=0.0)),
    ("XSPHViscosity", dict(fluid_viscosity_coefficient=0.5,
                           boundary_viscosity_coefficient=1.0)),
)
# solver: check_positions_and_velocities tolerances
SOLVER_TOL = {"dfsph": {}, "iisph": dict(vel_atol=1e-5, state_atol=2e-5)}


@pytest.fixture(scope="module", params=list(SOLVER_TOL))
def runs(request):
    run = run_both(request.param, True, DAM_BREAK_FORCES)
    return dict(run, tol=SOLVER_TOL[request.param])


def test_dam_break_scene_and_initial_state_match(runs):
    check_scene_and_initial_state(runs)


def test_dam_break_force_set_matches(runs):
    """Both worlds merge the fluid's forces into the same configurations,
    and the port's resolved layout is the JAX world's."""
    wj, wt = runs["worlds"]
    assert [type(f).__name__ for f in wt._force_set] == [
        type(f).__name__ for f in wj._force_set
    ] == ["ArtificialViscosityForce", "XSPHViscosityForce"]
    for a, b in zip(wt._force_set, wj._force_set):
        assert vars(a) == vars(b)
    check_resolved_layout(runs)


def test_dam_break_iteration_counts_identical(runs):
    check_iteration_counts(runs)


def test_dam_break_contact_and_overflow_counts_exact(runs):
    check_contact_and_overflow_counts(runs)


def test_dam_break_positions_and_velocities_match(runs):
    check_positions_and_velocities(runs, **runs["tol"])


def test_dam_break_boundary_volumes_and_forces_match(runs):
    check_boundary_volumes_and_forces(runs)
