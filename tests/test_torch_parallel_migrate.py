"""Sharded binning (particle migration) of ``salva_tpu_torch.parallel``
on the CPU.

- The building blocks against the JAX package: ``shard_interleave_perm``
  / ``shard_interleave``; ``_slab_targets`` against JAX's under
  ``jax.jit`` (where XLA multiplies by the reciprocal of the width, as
  the port does), on 2 and 4 slabs, with and without the ``clamp_nx``
  padding, a third of the particles on cell edges; ``_route_out`` /
  ``_route_back`` against a numpy reckoning of
  ``salva_tpu/parallel/domain.py:169-222``.
- The migrated step (``sharded_binning=True``, 2 and 4 slabs under
  ``LocalHalos``) on ``tests/test_torch_parallel.py``'s block over its
  floor, pressure-only DFSPH and IISPH: identical per-step records and
  positions, velocities and boundary forces bitwise the replicated slab
  step's (the received blocks keep their senders' row order, so the
  slab grids are the replicated path's), and within
  ``tests/test_domain.py``'s bounds (positions 1e-5, velocities 1e-4,
  boundary forces 5e-3) of the single-device step. The elasticity
  (``Becker2009Elasticity(50_000, 0.3, True)``, evaluated on the home
  rows and routed as ``a_pw``) against the single-device step, as
  ``tests/test_domain.py:179-235`` holds it. A small ``send_cap`` counted
  exactly in ``candidate_overflow``; the refusal of a capacity the slabs
  do not divide; ``dryrun(2, device="cpu")``.
- One 2-rank gloo run: ``sharding.make_mesh`` / ``shard_states`` (each
  rank's local block against the block JAX's ``shard_states`` puts on the
  device of the same index), then the migrated elasticity step on those
  blocks through ``DistributedHalos``, bitwise ``LocalHalos``'s. Its
  ranks are spawned processes that import this module, so it imports JAX
  only inside the tests that compare with the JAX package.

The migrated step against JAX's ``sharded_binning=True`` step is in
``tests/test_torch_parallel_jax.py`` (``slow``).
"""

import datetime
import functools
import multiprocessing
import os

import numpy as np
import pytest
import torch

from salva_tpu_torch import forces
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.object.state import (
    map_state,
    state_leaves,
    state_to_numpy,
)
from salva_tpu_torch.parallel import (
    DistributedHalos,
    LocalHalos,
    build_sharded_step_fn,
    dryrun,
    make_mesh,
    pad_spec_for_devices,
    shard_interleave,
    shard_interleave_perm,
    shard_states,
    state_shardings,
)
from salva_tpu_torch.parallel import domain
from salva_tpu_torch.step import _dense_config, build_step_fn
from test_torch_parallel import (
    FORCE_ATOL,
    POS_ATOL,
    VEL_ATOL,
    _cloud,
    _free_port,
    resolved_sim,
    slab_world,
)

# One intra-op thread (see tests/test_torch_dam_break.py); the slabs run
# in threads of their own.
torch.set_num_threads(1)

ELASTIC = (forces.Becker2009Elasticity(50_000.0, 0.3, True),)
ELASTIC_STEPS = 2
# (world case, steps). The solver state crosses the migration there and
# back in each step; the elasticity case's second step carries a nonzero
# one (DFSPH's velocity changes and warm-start sums) into the migration.
MIGRATE_CASES = {"pressure-only": 1, "iisph": 1}


def _world(case):
    if case == "elastic":
        return slab_world("pressure-only", np_forces=ELASTIC)
    return slab_world(case)


@functools.lru_cache(maxsize=None)
def runs(case, key):
    """One run of ``case`` (a MIGRATE_CASES key or ``"elastic"``), cached
    across tests: ``"single"`` (the world's single-device step), ``("rep",
    n)`` (the replicated slab step on n slabs) or ``("mig", n)``."""
    world = _world(case)
    sim = resolved_sim(world)
    args = (world.solver_config, world._force_set, 1)
    steps = ELASTIC_STEPS if case == "elastic" else MIGRATE_CASES[case]
    if key == "single":
        fn = build_step_fn(sim, *args)
    else:
        kind, n = key
        fn = build_sharded_step_fn(sim, *args, LocalHalos(n),
                                   sharded_binning=kind == "mig")
    return _run_full(world, fn, steps)


def _run_full(world, step_fn, steps):
    """:func:`test_torch_parallel.run` with the last diagnostics too."""
    fl, bd, ss = (world.fluids_state, world.boundaries_state,
                  world._solver_state)
    g = torch.tensor([0.0, -9.81, 0.0], dtype=torch.float32)
    record, d = [], None
    for _ in range(steps):
        fl, bd, ss, d = step_fn(fl, bd, ss, world._elasticity_state,
                                1.0 / 200.0, g)
        record.append((d.solver.pressure_iters, d.solver.divergence_iters,
                       int(d.ncontacts_ff), int(d.ncontacts_fb),
                       int(d.neighbor_overflow), int(d.candidate_overflow)))
    return fl, bd, ss, record


def _close_to_single(got, single):
    fm, bm, _, rm = got
    f1, b1, _, r1 = single
    assert rm == r1
    torch.testing.assert_close(fm.positions, f1.positions, rtol=0,
                               atol=POS_ATOL)
    torch.testing.assert_close(fm.velocities, f1.velocities, rtol=0,
                               atol=VEL_ATOL)
    torch.testing.assert_close(bm.forces, b1.forces, rtol=0,
                               atol=FORCE_ATOL)


# -- the building blocks ------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_shard_interleave_matches_jax(n_dev):
    import jax.numpy as jnp
    from salva_tpu.parallel.domain import shard_interleave as jinterleave
    from salva_tpu.parallel.domain import shard_interleave_perm as jperm

    np.testing.assert_array_equal(shard_interleave_perm(64, n_dev),
                                  jperm(64, n_dev))
    world = slab_world()
    fl, ss = world.fluids_state, world._solver_state
    got = state_to_numpy(shard_interleave(fl, n_dev))
    want = jinterleave({k: jnp.asarray(v)
                        for k, v in state_to_numpy(fl).items()}, n_dev)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(
        shard_interleave(ss, n_dev).numpy(),
        np.asarray(jinterleave(jnp.asarray(ss.numpy()), n_dev)))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_targets_match_jax_jit(n_slabs, padded):
    """Against JAX's ``_slab_targets`` under ``jax.jit``, where XLA bins by
    the float32 reciprocal of the width, as the port does. The x-cells of
    basic3's domain (origin -3.3, h = 0.2) hold a lattice of float32(k *
    0.1), every other plane on a cell edge, where that rule and JAX's
    eager division differ; and a seeded cloud with escapees and dead rows
    (``test_torch_parallel._cloud``). Each slab's interior rows are the
    rows it owns (``bin_particles_slab``), and every row it bins was sent
    to it."""
    import jax
    import jax.numpy as jnp
    from salva_tpu.geometry import dense_grid as jdg
    from salva_tpu.parallel.domain import _slab_targets as jtargets
    from salva_tpu.parallel.domain import pad_spec_for_devices as jpad

    # 36 x-cells: divisible by 2 and 4 slabs; 35 are padded for both.
    args = ((-3.3, -0.2, -0.2), (35 if padded else 36, 5, 5), 64, 0.2)
    tspec = pad_spec_for_devices(tdg.DenseGridSpec(*args), n_slabs)
    jspec = jpad(jdg.DenseGridSpec(*args), n_slabs)
    assert tspec.dims == jspec.dims
    assert (tspec.clamp_nx is not None) == padded
    nxl = tspec.dims[0] // n_slabs
    pos, alive = _cloud(tspec, 600, seed=10 * n_slabs + padded)
    rng = np.random.default_rng(n_slabs)
    lattice = (np.arange(-33, 39) * 0.1).astype(np.float32)
    edge = np.stack([lattice, *rng.uniform(0.0, 0.4, (2, len(lattice)))],
                    -1).astype(np.float32)
    pos = np.concatenate([pos, edge])
    alive = np.concatenate([alive, np.ones(len(edge), bool)])
    jit_t = np.asarray(jax.jit(functools.partial(
        jtargets, jspec, nxl, n_slabs))(jnp.asarray(pos),
                                        jnp.asarray(alive)))
    tpos, talive = torch.from_numpy(pos), torch.from_numpy(alive)
    got = domain._slab_targets(tspec, nxl, n_slabs, tpos, talive)
    np.testing.assert_array_equal(got.numpy(), jit_t)
    # The fixture tells the two roundings apart, and has ghost targets.
    eager = np.asarray(jtargets(jspec, nxl, n_slabs, jnp.asarray(pos),
                                jnp.asarray(alive)))
    assert (eager != jit_t).any()
    assert ((jit_t[:, 1] >= 0) | (jit_t[:, 2] >= 0)).any()
    for rank in range(n_slabs):
        b = tdg.bin_particles_slab(tspec, nxl, rank * nxl, tpos, talive)
        assert torch.equal(b.in_interior, (got[:, 0] == rank) & b.in_grid)
        assert not bool((b.in_grid & ~(got == rank).any(dim=1)).any())


def test_route_out_and_back_match_numpy():
    """``_route_out`` on 3 ranks: each (row, target) in row order takes the
    next free slot of its target's buffer, up to ``cap``; the rest count as
    overflow; rank r receives block s = what rank s sent it, in order, then
    zero rows. ``_route_back`` returns each row's owner reply, or the row
    itself where the owner slot was never filled."""
    n_dev, nl, cap = 3, 40, 12
    rng = np.random.default_rng(5)
    targets = rng.integers(-1, n_dev, size=(n_dev, nl, 3)).astype(np.int32)
    targets[:, ::7] = -1  # dead rows
    rows = rng.integers(0, 256, size=(n_dev, nl, 5)).astype(np.uint8)

    def body(halo):
        r = halo.rank
        recv, dst, over = domain._route_out(
            halo, torch.from_numpy(rows[r]), torch.from_numpy(targets[r]),
            cap)
        reply = (recv.to(torch.int32) + 1).to(torch.uint8)  # reply = row + 1
        back = domain._route_back(halo, reply, dst,
                                  torch.from_numpy(rows[r]), 3, cap)
        return recv.numpy(), dst.numpy(), int(over), back.numpy()

    out = LocalHalos(n_dev).run(1, 1, body)
    want_recv = np.zeros((n_dev, n_dev * cap, 5), np.uint8)
    for s in range(n_dev):
        fill = [0] * n_dev
        dst = np.full(nl * 3, n_dev * cap)
        over = 0
        for i, t in enumerate(targets[s].reshape(-1)):
            if t < 0:
                continue
            if fill[t] < cap:
                want_recv[t, s * cap + fill[t]] = rows[s, i // 3]
                dst[i] = t * cap + fill[t]
            else:
                over += 1
            fill[t] += 1
        assert over == out[s][2] and over > 0
        np.testing.assert_array_equal(out[s][1], dst)
        owner = dst.reshape(nl, 3)[:, 0]
        want_back = np.where((owner < n_dev * cap)[:, None],
                             rows[s] + np.uint8(1), rows[s])
        np.testing.assert_array_equal(out[s][3], want_back)
    for r in range(n_dev):
        np.testing.assert_array_equal(out[r][0], want_recv[r])


# -- the migrated step --------------------------------------------------------


@pytest.mark.parametrize("n_slabs", [2, 4])
@pytest.mark.parametrize("case", list(MIGRATE_CASES))
def test_migrated_step_matches_replicated_and_single(case, n_slabs):
    fm, bm, sm, rm = got = runs(case, ("mig", n_slabs))
    fr, br, sr, rr = runs(case, ("rep", n_slabs))
    assert rm == rr
    assert all(r[4] == 0 and r[5] == 0 for r in rm), "overflow"
    assert all(r[3] > 0 for r in rm), "the block never met the floor"
    for a, b in zip(state_leaves(fm) + state_leaves(bm) + [sm],
                    state_leaves(fr) + state_leaves(br) + [sr]):
        assert torch.equal(a, b)
    _close_to_single(got, runs(case, "single"))


def test_migrated_elasticity_matches_single_device():
    """The elasticity's acceleration, evaluated on the home rows before the
    migration and routed with them (``a_pw``), gives the single-device
    step's."""
    got = runs("elastic", ("mig", 2))
    single = runs("elastic", "single")
    _close_to_single(got, single)
    assert float(got[0].velocities.abs().max()) > 0.0


def test_small_send_cap_is_counted_in_candidate_overflow():
    """Every (row, target) past ``send_cap`` in its rank's bucket, counted
    from the initial state, adds to ``candidate_overflow``."""
    n_slabs, cap = 4, 16
    world = slab_world()
    sim = resolved_sim(world)
    step = build_sharded_step_fn(sim, world.solver_config, world._force_set,
                                 1, LocalHalos(n_slabs), sharded_binning=True,
                                 send_cap=cap)
    fl = world.fluids_state
    spec_f, _, _ = _dense_config(sim.replace(fitted_dims=None),
                                 world.solver_config, world._force_set)
    spec_f = pad_spec_for_devices(spec_f, n_slabs)
    nxl = spec_f.dims[0] // n_slabs
    tgt = domain._slab_targets(spec_f, nxl, n_slabs, fl.positions,
                               fl.alive).numpy()
    nl = tgt.shape[0] // n_slabs
    want = 0
    for s in range(n_slabs):
        t = tgt[s * nl:(s + 1) * nl]
        want += sum(max(0, int((t == r).sum()) - cap) for r in range(n_slabs))
    assert want > 0
    *_, record = _run_full(world, step, 1)
    replicated = runs("pressure-only", ("rep", n_slabs))[3][0]
    assert record[0][5] == replicated[5] + want


def test_migrated_step_refuses_a_capacity_the_slabs_do_not_divide():
    world = slab_world()
    cap = world.fluids_state.capacity
    assert cap % 3
    step = build_sharded_step_fn(resolved_sim(world), world.solver_config,
                                 world._force_set, 1, LocalHalos(3),
                                 sharded_binning=True)
    with pytest.raises(ValueError, match=f"fluid capacity {cap} is not "
                                         f"divisible by the 3 slabs"):
        _run_full(world, step, 1)


def test_dryrun_on_the_cpu():
    dryrun(2, device="cpu")


# -- the gloo backend ---------------------------------------------------------


def _gloo_rank(rank, port, out_dir):
    """One rank of the 2-rank gloo run: the elastic world's states placed
    by ``shard_states`` on ``make_mesh(2)``, then ELASTIC_STEPS migrated
    steps from this rank's blocks through ``DistributedHalos``; saves the
    blocks and the results to ``out_dir``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        world = _world("elastic")
        mesh = make_mesh(2)
        states = (world.fluids_state, world.boundaries_state,
                  world._solver_state)
        placed = shard_states(mesh, *states)
        shardings = state_shardings(mesh, world.fluids_state)
        blocks = [map_state(lambda a: a.to_local(), p) for p in placed]
        step = build_sharded_step_fn(
            resolved_sim(world), world.solver_config, world._force_set, 1,
            DistributedHalos(), sharded_binning=True)
        fl, bd, ss = blocks
        g = torch.tensor([0.0, -9.81, 0.0], dtype=torch.float32)
        record = []
        for _ in range(ELASTIC_STEPS):
            fl, bd, ss, d = step(fl, bd, ss, world._elasticity_state,
                                 1.0 / 200.0, g)
            record.append((d.solver.pressure_iters,
                           d.solver.divergence_iters, int(d.ncontacts_ff),
                           int(d.ncontacts_fb), int(d.neighbor_overflow),
                           int(d.candidate_overflow)))
        torch.save(dict(blocks=[state_leaves(b) for b in blocks],
                        out=[state_leaves(s) for s in (fl, bd, ss)],
                        record=record,
                        placements=[repr(p) for p in state_leaves(
                            shardings)]),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_gloo_migrated_step_and_shard_states(tmp_path):
    import jax.numpy as jnp
    from salva_tpu.parallel import make_mesh as jmake_mesh
    from salva_tpu.parallel import shard_states as jshard_states

    port = _free_port()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank,
                         args=(r, port, os.fspath(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    # The ranks' collectives time out after 60 s (init_process_group).
    for p in procs:
        p.join(timeout=240)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    # Each rank's local blocks: the blocks JAX's shard_states puts on the
    # device of the same index of make_mesh(2).
    world = _world("elastic")
    states = (world.fluids_state, world.boundaries_state,
              world._solver_state)
    jmesh = jmake_mesh(2)

    def as_jax(a):
        # The u32 bitmasks, held as int64 (object/state.py).
        a = a.numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a

    for i, st in enumerate(states):
        for k, leaf in enumerate(state_leaves(st)):
            placed = jshard_states(jmesh, jnp.asarray(as_jax(leaf)))
            by_device = {s.device: np.asarray(s.data)
                         for s in placed.addressable_shards}
            for r in range(2):
                np.testing.assert_array_equal(
                    as_jax(got[r]["blocks"][i][k]),
                    by_device[jmesh.devices[r]], err_msg=f"{i}.{k}")
    assert all("Shard(dim=0)" in p for p in got[0]["placements"])

    # The migrated step through DistributedHalos: bitwise LocalHalos's.
    fl, bd, ss, record = runs("elastic", ("mig", 2))
    assert got[0]["record"] == got[1]["record"] == record
    for i, st in enumerate((fl, bd, ss)):
        for k, leaf in enumerate(state_leaves(st)):
            joined = torch.cat([got[r]["out"][i][k] for r in range(2)])
            assert torch.equal(joined, leaf), f"{i}.{k}"
