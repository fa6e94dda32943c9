"""The slab decomposition of ``salva_tpu_torch.parallel`` on the CPU.

- The building blocks against the JAX package: ``bin_particles_slab``
  (a seeded cloud with particles on cell edges, every rank of 2 and 4
  slabs), ``pad_spec_for_devices`` and ``Halo.exchange`` (the JAX side in
  a ``shard_map`` on the virtual 8-device CPU mesh).
- The slab step (2 and 4 slabs under ``LocalHalos``) against the port's
  single-device dense step, itself held to the JAX package by the dam
  break parity tests. The world is ``tests/test_domain.py``'s 216-particle
  block with its forces and solvers (the DFSPH viscosity at one
  iteration: ROADMAP Queue 3, item 15), cut to a floor and a domain
  around the block and lowered onto the floor, so that the fluid-boundary
  passes and the boundary forces act from the first step: the CPU's
  plain folds walk every cell of the domain, and test_domain's domain
  costs ~12 s a step and run. Held at ``tests/test_domain.py``'s bounds
  (positions 1e-5, velocities 1e-4, boundary forces 5e-3) with identical
  iterations and contacts at every step and no overflow; and, on the
  CPU, bitwise to the single-device step on the full domain without the
  half stencil, whose arithmetic each slab repeats. The slab and the
  single-device grids differ only on the ghost columns, which every
  reader refreshes first (``Halo.exchange``), so only interior columns
  count.
- The refusals of ``test_sharded_rejects_unsupported_force`` and the
  other ``build_sharded_step_fn`` refusals, with the JAX messages.
- One 2-rank gloo run (``DistributedHalos``) of DFSPH and of IISPH, each
  with every halo-aware force at once, bitwise equal to
  ``LocalHalos``'s. Its ranks are spawned processes that import this
  module, so it imports JAX only inside the tests that compare with the
  JAX package.

The force cases of the slab step are in
``tests/test_torch_parallel_forces.py``; the slab step against the JAX
package's sharded step in ``tests/test_torch_parallel_jax.py`` (``slow``:
minutes of XLA compile).
"""

import datetime
import functools
import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

from salva_tpu_torch import forces, shapes
from salva_tpu_torch.config import DFSPHConfig, IISPHConfig
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.parallel import (
    DistributedHalos,
    LocalHalos,
    build_sharded_step_fn,
    get_sharded_step_fn,
    pad_spec_for_devices,
)
from salva_tpu_torch.sampling import shape_surface_sample
from salva_tpu_torch.scenes import cube_fluid
from salva_tpu_torch.step import build_step_fn
from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

# One intra-op thread (see tests/test_torch_dam_break.py); the slabs run
# in threads of their own.
torch.set_num_threads(1)

RADIUS = 0.05
DT = 1.0 / 200.0
GRAVITY = (0.0, -9.81, 0.0)
# The block of tests/test_domain.py (6^3 at 2 r spacing), lowered so that
# its bottom layer lies within h of the floor's top samples.
LIFT = 0.40
FLOOR = (0.4, 0.1, 0.4)
DOMAIN = ((-0.45, -0.2, -0.45), (0.45, 0.8, 0.45))
POS_ATOL, VEL_ATOL, FORCE_ATOL = 1e-5, 1e-4, 5e-3

# (solver, forces, steps): the forces' exchanges run inside every step, so
# their cases take one step; the force-free cases take two, carrying the
# merged state (the solver state among it) into a second step.
CASES = {
    "pressure-only": ("dfsph", (), 2),
    "xsph": ("dfsph", (forces.XSPHViscosity(0.5, 0.5),), 1),
    "akinci": ("dfsph", (forces.Akinci2013SurfaceTension(1.0, 0.5),), 1),
    "he2014": ("dfsph", (forces.He2014SurfaceTension(1.0, 0.5),), 1),
    "iisph": ("iisph", (), 2),
    "dfsph-viscosity": ("dfsph", (forces.DFSPHViscosity(
        0.05, max_viscosity_iter=1),), 1),
}
# Every halo-aware force at once, under each solver: what the gloo run
# drives (and the slab tests hold to the single-device step too).
ALL_FORCES = (
    forces.XSPHViscosity(0.5, 1.0), forces.ArtificialViscosity(1.0, 0.0),
    forces.WCSPHSurfaceTension(1.0, 0.5),
    forces.Akinci2013SurfaceTension(1.0, 0.5),
    forces.He2014SurfaceTension(1.0, 0.5),
    forces.DFSPHViscosity(0.05, max_viscosity_iter=1),
    forces.Becker2009Elasticity(100_000.0, 0.3, True),
)
CASES["all-forces"] = ("dfsph", ALL_FORCES, 1)
CASES["iisph-all-forces"] = ("iisph", ALL_FORCES, 1)
GLOO_CASES = ("all-forces", "iisph-all-forces")
# The force-free cases run here; the others in
# tests/test_torch_parallel_forces.py (one file per test worker each).
BASE_CASES = ("pressure-only", "iisph")


def slab_world(case="pressure-only", domain=DOMAIN, floor=FLOOR, lift=LIFT):
    solver, np_forces, _ = CASES[case]
    cfg = DFSPHConfig() if solver == "dfsph" else IISPHConfig()
    world = LiquidWorld(solver=cfg, particle_radius=RADIUS, dim=3,
                        domain=domain, layout="dense", device="cpu")
    pos = cube_fluid((6, 6, 6), RADIUS)
    pos[:, 1] += lift
    world.add_fluid(Fluid(pos, density0=1000.0,
                          nonpressure_forces=list(np_forces)))
    world.add_boundary(Boundary(shape_surface_sample(
        shapes.Cuboid(floor), RADIUS, 3)))
    world._prepare()
    return world


def resolved_sim(world):
    """The configuration the world's next step runs."""
    return world._boundary_volume_mode(world._effective_sim(), None)


def run(world, step_fn, steps):
    """(final fluids, final boundaries, per-step (pressure iterations,
    divergence iterations, ff contacts, fb contacts, overflow))."""
    fl, bd, ss = world.fluids_state, world.boundaries_state, world._solver_state
    g = torch.tensor(GRAVITY, dtype=torch.float32)
    record = []
    for _ in range(steps):
        fl, bd, ss, d = step_fn(fl, bd, ss, world._elasticity_state, DT, g)
        record.append((d.solver.pressure_iters, d.solver.divergence_iters,
                       int(d.ncontacts_ff), int(d.ncontacts_fb),
                       int(d.neighbor_overflow)))
    return fl, bd, record


@functools.lru_cache(maxsize=None)
def runs(case, key):
    """One run of ``case``, cached across tests: ``"single"`` (the
    world's own single-device step), ``"full"`` (single-device on the full
    domain without the half stencil or the sparse boundary), or the
    number of slabs."""
    world = slab_world(case)
    sim = resolved_sim(world)
    args = (world.solver_config, world._force_set, 1)
    if key == "single":
        fn = build_step_fn(sim, *args)
    elif key == "full":
        fn = build_step_fn(sim.replace(fitted_dims=None,
                                       dense_half_stencil=False,
                                       dense_sparse_boundary=False), *args)
    else:
        fn = build_sharded_step_fn(sim, *args, LocalHalos(key))
    return run(world, fn, CASES[case][2])


def check_slab_step(case, n_slabs):
    """The slab step of ``case`` on ``n_slabs`` slabs against the world's
    single-device step."""
    fs, bs, rs = runs(case, n_slabs)
    f1, b1, r1 = runs(case, "single")
    # Identical psum'd termination and contacts at every step.
    assert rs == r1
    assert all(r[-1] == 0 for r in rs), "neighbor overflow"
    assert all(r[3] > 0 for r in rs), "the block never met the floor"
    torch.testing.assert_close(fs.positions, f1.positions, rtol=0,
                               atol=POS_ATOL)
    torch.testing.assert_close(fs.velocities, f1.velocities, rtol=0,
                               atol=VEL_ATOL)
    torch.testing.assert_close(bs.forces, b1.forces, rtol=0,
                               atol=FORCE_ATOL)
    assert float(bs.forces.abs().max()) > 0.0


@pytest.mark.parametrize("n_slabs", [2, 4])
@pytest.mark.parametrize("case", BASE_CASES)
def test_slab_step_matches_single_device(case, n_slabs):
    check_slab_step(case, n_slabs)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_step_is_the_full_grid_step_bitwise(n_slabs):
    fs, bs, rs = runs("pressure-only", n_slabs)
    ff, bf, rf = runs("pressure-only", "full")
    assert rs == rf
    assert torch.equal(fs.positions, ff.positions)
    assert torch.equal(fs.velocities, ff.velocities)
    assert torch.equal(bs.forces, bf.forces)
    assert torch.equal(bs.volumes, bf.volumes)


def test_get_sharded_step_fn_is_cached():
    world = slab_world()
    halos = LocalHalos(2)
    args = (resolved_sim(world), world.solver_config, world._force_set, 1)
    assert get_sharded_step_fn(*args, halos) is get_sharded_step_fn(
        *args, halos)


# -- the building blocks against the JAX package ------------------------------


def _cloud(spec, n, seed):
    """A seeded cloud over the spec's interior and beyond it (escapees),
    a third of it on cell edges, a tenth dead."""
    rng = np.random.default_rng(seed)
    dims = np.asarray(spec.dims)
    lo = np.asarray(spec.origin)
    pos = lo + rng.uniform(-0.5, dims + 0.5, size=(n, 3)) * spec.cell_width
    edges = lo + rng.integers(0, dims + 1, size=(n // 3, 3)) * spec.cell_width
    pos[: n // 3] = edges
    alive = rng.random(n) > 0.1
    return pos.astype(np.float32), alive


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_bin_particles_slab_matches_jax(n_slabs):
    import jax
    import jax.numpy as jnp
    from salva_tpu.geometry import dense_grid as jdg
    from salva_tpu.parallel.domain import pad_spec_for_devices as jpad

    kw = dict(mins=(-0.31, -0.2, -0.27), maxs=(0.43, 0.5, 0.3), h=0.1,
              cap=4)
    tspec = pad_spec_for_devices(tdg.spec_for_aabb(**kw), n_slabs)
    jspec = jpad(jdg.spec_for_aabb(**kw), n_slabs)
    assert tspec.dims == jspec.dims and tspec.clamp_nx == jspec.clamp_nx
    nxl = tspec.dims[0] // n_slabs
    pos, alive = _cloud(tspec, 1200, seed=n_slabs)
    binned = jax.jit(functools.partial(jdg.bin_particles_slab, jspec, nxl))
    totals = np.zeros(3, np.int64)
    for rank in range(n_slabs):
        j = binned(jnp.int32(rank * nxl), jnp.asarray(pos),
                   jnp.asarray(alive))
        t = tdg.bin_particles_slab(tspec, nxl, rank * nxl,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(alive))
        for name in ("slot_of", "in_grid", "in_interior", "mask",
                     "overflow", "clamped"):
            np.testing.assert_array_equal(
                getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                err_msg=f"rank {rank}: {name}")
        totals += [int(t.overflow), int(t.clamped), int(t.in_interior.sum())]
        # The run table feeds every slot from the particle slot_of names.
        src = torch.full(t.mask.shape, -1, dtype=torch.int64)
        live = t.in_grid.nonzero()[:, 0]
        slot = t.slot_of[live].long()
        src[slot % tspec.cap, slot // tspec.cap] = live
        (got,) = tdg.to_grid_multi(None, t, [(torch.arange(
            len(pos), dtype=torch.float32), -1.0)])
        assert torch.equal(got.long(), src)
    # Full cells, escapees, and each live particle owned by one slab.
    assert totals[0] > 0 and totals[1] > 0
    assert totals[2] + totals[0] == int(alive.sum())


@pytest.mark.parametrize("nx", [16, 17, 18])
@pytest.mark.parametrize("n_slabs", [1, 2, 4, 8])
def test_pad_spec_for_devices_matches_jax(nx, n_slabs):
    from salva_tpu.geometry import dense_grid as jdg
    from salva_tpu.parallel.domain import pad_spec_for_devices as jpad

    args = ((0.0, -0.2, 0.1), (nx, 5, 6), 16, 0.1)
    t = pad_spec_for_devices(tdg.DenseGridSpec(*args), n_slabs)
    j = jpad(jdg.DenseGridSpec(*args), n_slabs)
    assert (t.dims, t.clamp_nx, t.origin, t.cap) == (j.dims, j.clamp_nx,
                                                     j.origin, j.cap)
    assert t.dims[0] % n_slabs == 0


@pytest.mark.parametrize("n_slabs", [2, 4, 8])
def test_local_halo_exchange_matches_jax(n_slabs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from salva_tpu.parallel import make_mesh
    from salva_tpu.parallel.domain import Halo as JaxHalo

    nxl, nyz = 3, 5
    rng = np.random.default_rng(n_slabs)
    data = rng.normal(size=(n_slabs, 2, 8, (nxl + 2) * nyz)).astype(
        np.float32)
    mesh = make_mesh(n_slabs, axis_name="x")

    def body(a):
        return JaxHalo("x", n_slabs, nxl, nyz).exchange(a[0])[None]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
        check_vma=False))(jnp.asarray(data)))
    got = LocalHalos(n_slabs).run(
        nxl, nyz, lambda halo: halo.exchange(torch.from_numpy(
            data[halo.rank])))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got]), want)


def test_local_halos_collectives_in_rank_order():
    vals = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, -1e8]),
            torch.tensor([-1e8, 1e8]), torch.tensor([1.0, 1.0])]
    out = LocalHalos(4).run(1, 1, lambda h: (h.psum(vals[h.rank]),
                                             h.pmax(vals[h.rank])))
    want = ((vals[0] + vals[1]) + vals[2]) + vals[3]
    for s, m in out:
        assert torch.equal(s, want)
        assert torch.equal(m, torch.tensor([1e8, 1e8]))


def test_local_halos_raise_in_every_rank():
    def body(halo):
        if halo.rank == 1:
            raise KeyError("rank 1 failed")
        return halo.psum(torch.ones(()))

    with pytest.raises(KeyError, match="rank 1 failed"):
        LocalHalos(3).run(1, 1, body)


# -- refusals ------------------------------------------------------------------


def test_sharded_rejects_unsupported_force():
    """A force without a dense form cannot run on slabs (no dense layout
    at all), as in ``tests/test_domain.py``."""
    from salva_tpu_torch.solver.nonpressure import CustomForce

    class _F(CustomForce):
        def apply(self, ctx):
            return torch.zeros_like(ctx.fluids.positions)

    world = slab_world()
    world.add_fluid(Fluid(cube_fluid((2, 2, 2), RADIUS),
                          nonpressure_forces=[_F()]))
    world._prepare()
    with pytest.raises(ValueError, match="dense"):
        build_sharded_step_fn(world.sim, world.solver_config,
                              world._force_set, 2, LocalHalos(2))


def test_sharded_step_refusals(monkeypatch):
    import types

    from salva_tpu_torch.solver import forces_dense

    world = slab_world()
    sim, cfg, fs = resolved_sim(world), world.solver_config, world._force_set
    halos = LocalHalos(2)
    with pytest.raises(ValueError,
                       match="domain decomposition requires "
                             "dense_compact=False"):
        build_sharded_step_fn(sim.replace(dense_compact=True), cfg, fs, 1,
                              halos)
    with pytest.raises(ValueError, match="unsupported solver 'pcisph'"):
        build_sharded_step_fn(sim, types.SimpleNamespace(kind="pcisph"), fs,
                              1, halos)
    with pytest.raises(ValueError, match="requires the dense layout"):
        build_sharded_step_fn(sim.replace(layout="gather"), cfg, fs, 1,
                              halos)
    monkeypatch.setattr(forces_dense, "to_dense_forces",
                        lambda force_set: (forces_dense.ParticleWiseForce(
                            None), object()))
    with pytest.raises(ValueError, match="object is not halo-aware yet"):
        build_sharded_step_fn(sim, cfg, fs, 1, halos)


# -- the gloo backend ------------------------------------------------------------


def _gloo_rank(rank, port, out):
    """One rank of the 2-rank gloo run: the slab step of each of
    GLOO_CASES through ``DistributedHalos``; rank 0 saves the results to
    ``out``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        results = {}
        for case in GLOO_CASES:
            world = slab_world(case)
            fn = build_sharded_step_fn(resolved_sim(world),
                                       world.solver_config, world._force_set,
                                       1, DistributedHalos())
            fl, bd, record = run(world, fn, CASES[case][2])
            results[case] = dict(positions=fl.positions,
                                 velocities=fl.velocities, forces=bd.forces,
                                 volumes=bd.volumes, record=record)
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_run_is_bitwise_local_halos(tmp_path):
    out = os.fspath(tmp_path / "rank0.pt")
    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    # The ranks' collectives time out after 60 s (init_process_group);
    # this bounds the whole run, spawn and imports included, on a loaded
    # host.
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    got = torch.load(out)
    for case in GLOO_CASES:
        fs, bs, rs = runs(case, 2)
        g = got[case]
        assert g["record"] == rs, case
        assert torch.equal(g["positions"], fs.positions), case
        assert torch.equal(g["velocities"], fs.velocities), case
        assert torch.equal(g["forces"], bs.forces), case
        assert torch.equal(g["volumes"], bs.volumes), case
