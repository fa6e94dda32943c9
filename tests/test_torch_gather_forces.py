"""The gather layout's six non-pressure forces of the PyTorch port against
the JAX package, on the CPU.

Field level: ``XSPHViscosityForce``, ``ArtificialViscosityForce``,
``Akinci2013SurfaceTensionForce``, ``WCSPHSurfaceTensionForce``,
``He2014SurfaceTensionForce`` and ``DFSPHViscosityForce`` of both
packages ``apply(ctx)`` on step contexts that each package builds with
its own neighbour search, contacts, boundary volumes and densities from
the same seeded numpy state (2D and 3D): two fluids, of which only fluid
0 carries the force, random velocities (so the artificial viscosity's
approaching-pair gate goes both ways), and a moving boundary layer
through the fluid (the boundary terms and their feedback run), under the
cubic spline and under poly6 (density) / spiky (gradient). The contact
tables are equal index for index (``test_torch_gather_neighbors.py``);
the acceleration and the boundary feedback are held within 1e-5 of each
output's peak, the DFSPH viscosity (one update, ``max_viscosity_iter=1``;
its batched float32 inverse of near-singular [S, S] systems) within
1e-3 of its peak, the bound of ``tests/test_torch_tension_forces.py``.

World level: the 7^3 gather dam break of
``tests/test_torch_gather_dam_break.py`` with faucet3's XSPH viscosity and
Akinci tension (``salva_tpu/scenes.py:428-429``), 6 DFSPH steps, held to
that file's rules, with the velocities within 1e-5 m/s and the solver
state within 2e-5, as ``tests/test_torch_tension_dam_break.py`` holds the
same scene on the dense layout: the Akinci adhesion kernel's slope is
unbounded at the ends of its support, so a last-ulp difference in a
boundary pair's distance moves that particle's velocity (here, up to
4.0e-6 in the DFSPH stiffness sums, with identical iterations and
positions within 2e-6 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.geometry import contacts as jc
from salva_tpu.geometry import grid as jg
from salva_tpu.geometry import neighbors as jn
from salva_tpu.kernels import sph as jsph
from salva_tpu.object.state import BoundariesState as JB
from salva_tpu.object.state import FluidsState as JF
from salva_tpu.solver import common as jcommon
from salva_tpu.solver import surface_tension as jst
from salva_tpu.solver import viscosity as jvisc
from salva_tpu_torch.geometry import contacts as tc
from salva_tpu_torch.geometry import grid as tg
from salva_tpu_torch.geometry import neighbors as tn
from salva_tpu_torch.kernels import sph as tsph
from salva_tpu_torch.object.state import state_from_numpy
from salva_tpu_torch.solver import common as tcommon
from salva_tpu_torch.solver import surface_tension as tst
from salva_tpu_torch.solver import viscosity as tvisc
from test_torch_dam_break import GRAVITY
from test_torch_gather_dam_break import (
    _jax_dam_3d,
    _torch_dam_3d,
    check_gather_parity,
    run_pair,
)

torch.set_num_threads(1)

H = 0.2
DT = 1.0 / 200.0
FIELD_ATOL = 1e-5  # x each output's peak
VISC_ATOL = 1e-3  # x the peak: the DFSPH viscosity (module docstring)
FAUCET3 = (("XSPHViscosity", dict(fluid_viscosity_coefficient=0.5,
                                  boundary_viscosity_coefficient=0.0)),
           ("Akinci2013SurfaceTension",
            dict(fluid_tension_coefficient=1.0,
                 boundary_adhesion_coefficient=10.0)))
# (class name, fluid 0's coefficients as the world merges them for two
# fluids; fluid 1 carries no force).
FORCE_CASES = {
    "xsph": ("viscosity", "XSPHViscosityForce", dict(
        fluid_coefficients=(0.5, 0.0), boundary_coefficients=(0.5, 0.0))),
    "artificial": ("viscosity", "ArtificialViscosityForce", dict(
        fluid_coefficients=(0.5, 0.0), boundary_coefficients=(0.3, 0.0),
        alphas=(1.0, 1.0), betas=(0.5, 0.0), speeds_of_sound=(10.0, 10.0))),
    "akinci": ("tension", "Akinci2013SurfaceTensionForce", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_adhesion_coefficients=(10.0, 0.0))),
    "wcsph": ("tension", "WCSPHSurfaceTensionForce", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_tension_coefficients=(0.5, 0.0))),
    "he2014": ("tension", "He2014SurfaceTensionForce", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_tension_coefficients=(0.5, 0.0))),
    "dfsph_viscosity_1": ("viscosity", "DFSPHViscosityForce", dict(
        viscosity_coefficients=(0.5, 0.0), participating=(1, 0),
        max_viscosity_iter=1)),
}
KERNEL_PAIRS = {"cubic": ("cubic", "cubic"), "poly6_spiky": ("poly6", "spiky")}


def _state(dim, seed=0):
    """Numpy fields of a jittered lattice of two fluids and a moving
    boundary layer through it."""
    rng = np.random.default_rng(seed + dim)
    n_side = 8 if dim == 2 else 5
    ax = np.arange(n_side) * 0.1
    pos = np.stack(np.meshgrid(*([ax] * dim), indexing="ij"), -1).reshape(
        -1, dim)
    pos = (pos + rng.uniform(-0.02, 0.02, pos.shape)).astype(np.float32)
    n = len(pos)
    fid = (pos[:, 0] > 0.35).astype(np.int32)
    vol = np.float32(0.8 * 0.1 ** dim)
    fluids = dict(
        positions=pos,
        velocities=rng.normal(0.0, 0.3, (n, dim)).astype(np.float32),
        volumes=np.full(n, vol, np.float32),
        density0=np.where(fid == 0, 1000.0, 800.0).astype(np.float32),
        alive=rng.uniform(size=n) > 0.05,
        fluid_id=fid,
        memberships=np.ones(n, np.uint32),
        filter=np.full(n, 0xFFFFFFFF, np.uint32),
    )
    bx = np.arange(-1, n_side + 1) * 0.1
    grid = np.stack(np.meshgrid(*([bx] * (dim - 1)), indexing="ij"),
                    -1).reshape(-1, dim - 1)
    bpos = np.concatenate([grid, np.full((len(grid), 1), 0.22)],
                          axis=1).astype(np.float32)
    m = len(bpos)
    bounds = dict(
        positions=bpos,
        velocities=rng.normal(0.0, 0.5, (m, dim)).astype(np.float32),
        volumes=np.zeros(m, np.float32),
        forces=np.zeros((m, dim), np.float32),
        alive=np.ones(m, bool),
        boundary_id=np.zeros(m, np.int32),
        memberships=np.ones(m, np.uint32),
        filter=np.full(m, 0xFFFFFFFF, np.uint32),
    )
    return fluids, bounds


def _contexts(pkg, dim, fluids, bounds):
    """The package's StepContext of the state under each of
    KERNEL_PAIRS, built as its gather substep builds one (the neighbour
    tables once, the kernels' values per pair)."""
    if pkg == "jax":
        mods = (jg, jn, jc, jsph, jcommon)
        fl = JF(**{k: jnp.asarray(v) for k, v in fluids.items()})
        bd = JB(**{k: jnp.asarray(v) for k, v in bounds.items()})
        as_t = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    else:
        mods = (tg, tn, tc, tsph, tcommon)
        fl = state_from_numpy(fluids, device="cpu")
        bd = state_from_numpy(bounds, device="cpu")
        as_t = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    g, nbr, con, sph, common = mods
    fgrid = g.build_grid(fl.positions, fl.alive, H, dim)
    bgrid = g.build_grid(bd.positions, bd.alive, H, dim)
    ff = nbr.find_neighbors(fl.positions, fl.alive, fl.groups(), fgrid,
                            fl.positions, fl.alive, fl.groups(), H, dim, 64,
                            288, True)
    fb = nbr.find_neighbors(fl.positions, fl.alive, fl.groups(), bgrid,
                            bd.positions, bd.alive, bd.groups(), H, dim, 64,
                            288, False)
    out = {}
    for name, (kd, kg) in KERNEL_PAIRS.items():
        w_fn, dw_fn = sph.get_kernel(kd)[0], sph.get_kernel(kg)[1]
        wsum, _ = nbr.weighted_sum_over_neighbors(
            bd.positions, bd.alive, bd.groups(), bgrid, bd.positions,
            bd.alive, bd.groups(), H, dim, 288, True, w_fn)
        bd_k = bd.replace(volumes=common.boundary_volumes(wsum, bd.alive))
        ctx = common.StepContext(
            fluids=fl, boundaries=bd_k,
            ff=con.evaluate_contacts(fl.positions, fl.positions, ff, H, dim,
                                     w_fn=w_fn, dw_fn=dw_fn),
            fb=con.evaluate_contacts(fl.positions, bd.positions, fb, H, dim,
                                     w_fn=w_fn, dw_fn=dw_fn),
            densities=as_t(np.zeros(len(fluids["alive"]))), dt=as_t(DT),
            inv_dt=as_t(1.0 / DT), dim=dim, h=H, num_fluids=2)
        out[name] = ctx.replace(densities=common.compute_densities(ctx))
    return out


@pytest.fixture(scope="module")
def contexts():
    out = {}
    for dim in (2, 3):
        fluids, bounds = _state(dim)
        jctx = _contexts("jax", dim, fluids, bounds)
        tctx = _contexts("torch", dim, fluids, bounds)
        for name in KERNEL_PAIRS:
            out[dim, name] = (jctx[name], tctx[name])
    return out


@pytest.mark.parametrize("kernels", sorted(KERNEL_PAIRS))
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", sorted(FORCE_CASES))
def test_gather_force_matches_jax(contexts, case, dim, kernels):
    jctx, tctx = contexts[dim, kernels]
    np.testing.assert_allclose(tctx.densities.numpy(),
                               np.asarray(jctx.densities), rtol=1e-6)
    module, cls, kw = FORCE_CASES[case]
    jmod, tmod = {"viscosity": (jvisc, tvisc),
                  "tension": (jst, tst)}[module]
    want = getattr(jmod, cls)(**kw).apply(jctx)
    got = getattr(tmod, cls)(**kw).apply(tctx)
    atol = VISC_ATOL if case.startswith("dfsph") else FIELD_ATOL
    for what, a, b in zip(("accel", "boundary feedback"), got, want):
        a, b = a.numpy(), np.asarray(b)
        peak = float(np.abs(b).max())
        if case.startswith("dfsph") and what != "accel":
            assert peak == 0.0 and not np.any(a)  # no boundary term
            continue
        assert peak > 0.0, what
        np.testing.assert_allclose(a, b, rtol=0, atol=atol * peak,
                                   err_msg=what)
    # Fluid 1 carries no force: its acceleration is exactly zero.
    fid1 = tctx.fluids.fluid_id.numpy() == 1
    assert not np.any(got[0].numpy()[fid1])


def test_faucet3_forces_dam_break():
    runs = run_pair(lambda: _jax_dam_3d("dfsph", FAUCET3),
                    lambda: _torch_dam_3d("dfsph", FAUCET3), 6, GRAVITY)
    assert len(runs["worlds"][1]._force_set.forces) == 2
    check_gather_parity(runs, "dfsph", vel_atol=1e-5, state_atol=2e-5)
