"""``z_sort``, the particle queries and the gather search's cell rounding of
the PyTorch port, against the JAX package on the CPU.

- The gather search on a lattice with particles on cell edges (float32
  multiples of h / 2 at h = 0.2, where ``p / h`` and ``p * (1 / h)`` floor
  apart): the port's Morton keys, order, cells and neighbour tables equal
  the JAX package's *jitted* search (its step's: XLA multiplies by the
  float32 reciprocal of the constant ``h``), and the port's ``z_sort``
  equals the JAX package's *eager* ``z_sort`` (a true division) on the
  same lattice.
- ``z_sort`` on the multi-fluid, dead-slot world of
  ``tests/test_world.py`` and on a world with a Becker 2009 elastic block:
  the sorted state, slot mirrors, solver state and elasticity rest state
  (``rest_j`` remapped) equal JAX's exactly, and the next steps agree
  within 2e-6 m with identical iterations.
- ``particles_intersecting_aabb`` / ``_shape``: the (kind, handle, index)
  tuples equal JAX's, in order, for boxes, posed analytic shapes and a
  ``TriMesh`` (through its voxelized field).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import shapes as tshapes

torch.set_num_threads(1)

H = 0.2
RADIUS = 0.05
POS_ATOL = 2e-6
NB = dict(max_neighbors=40, max_candidates=128, query_chunk=4096)
ALL = 0xFFFFFFFF


def _edge_lattice(dim):
    """float32(k * 0.1) for k in [-10, 40): 99 of the 2D lattice's 2,500
    points floor to another cell under ``p * (1 / h)`` than ``p / h``."""
    ax = (np.arange(-10, 40) * 0.1).astype(np.float32)
    if dim == 3:
        ax = ax[::3]
    return np.stack(np.meshgrid(*([ax] * dim), indexing="ij"),
                    -1).reshape(-1, dim).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
def test_gather_search_on_cell_edges_matches_jitted_jax(dim):
    from salva_tpu.geometry import grid as jg
    from salva_tpu.geometry import neighbors as jn
    from salva_tpu_torch.geometry import grid as tg
    from salva_tpu_torch.geometry import neighbors as tn

    pos = _edge_lattice(dim)
    n = len(pos)
    alive = np.ones(n, bool)
    alive[::7] = False
    mem, flt = np.ones(n, np.uint32), np.full(n, ALL, np.uint32)
    model = np.zeros(n, np.int32)

    def jax_search(p):
        a = jnp.asarray(alive)
        grp = jn.GroupInfo(jnp.asarray(mem), jnp.asarray(flt),
                           jnp.asarray(model))
        g = jg.build_grid(p, a, H, dim)
        return g, jn.find_neighbors(p, a, grp, g, p, a, grp, H, dim,
                                    NB["max_neighbors"],
                                    NB["max_candidates"], True,
                                    query_chunk=NB["query_chunk"])

    jgrid, jnl = jax.jit(jax_search)(jnp.asarray(pos))
    # The lattice is one where the two roundings differ.
    eager = np.asarray(jg.cell_coords(jnp.asarray(pos), H))
    assert (eager != np.asarray(jgrid.cells)).any()

    ta = torch.tensor(alive)
    grp = tn.GroupInfo(torch.tensor(mem.astype(np.int64)),
                       torch.tensor(flt.astype(np.int64)),
                       torch.tensor(model))
    tgrid = tg.build_grid(torch.tensor(pos), ta, H, dim)
    tnl = tn.find_neighbors(torch.tensor(pos), ta, grp, tgrid,
                            torch.tensor(pos), ta, grp, H, dim,
                            NB["max_neighbors"], NB["max_candidates"], True,
                            query_chunk=NB["query_chunk"])
    np.testing.assert_array_equal(tgrid.cells.numpy(), np.asarray(jgrid.cells))
    np.testing.assert_array_equal(tgrid.order.numpy(), np.asarray(jgrid.order))
    np.testing.assert_array_equal(
        tgrid.sorted_keys.numpy(), np.asarray(jgrid.sorted_keys).astype(
            np.int64))
    for f in ("idx", "valid", "count", "overflow", "cand_overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(tnl, f)),
                                      np.asarray(getattr(jnl, f)), err_msg=f)
    # A true division (the eager callers' rounding) matches the eager
    # cells instead.
    np.testing.assert_array_equal(
        tg.build_grid(torch.tensor(pos), ta, H, dim, divide=True)
        .cells.numpy(), eager)


def _pair(dim=2, domain=None, layout="auto"):
    """An empty world of each package (gather layout unless a domain)."""
    from salva_tpu.config import DFSPHConfig, NeighborConfig
    from salva_tpu.world import LiquidWorld

    jw = LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=dim,
                     neighbors=NeighborConfig(**NB), domain=domain,
                     layout=layout)
    if domain is not None:
        jw.sim = jw.sim.replace(use_pallas=False, dense_spill_auto=False,
                                dense_compact=False)
    tw = st.LiquidWorld(particle_radius=RADIUS, dim=dim,
                        neighbors=st.NeighborConfig(**NB), domain=domain,
                        layout=layout, device="cpu")
    return jw, tw


def _add(pair, fluid_args=(), boundary=None):
    """Add the same fluids (positions, kwargs) and boundary to both."""
    from salva_tpu import forces as jforces
    from salva_tpu.world import Boundary, Fluid

    from salva_tpu_torch import forces as tforces

    jw, tw = pair
    handles = []
    for pos, kw in fluid_args:
        kw = dict(kw)
        fs = kw.pop("forces", ())
        handles.append(jw.add_fluid(Fluid(pos, nonpressure_forces=[
            getattr(jforces, n)(*a) for n, a in fs], **kw)))
        assert tw.add_fluid(st.Fluid(pos, nonpressure_forces=[
            getattr(tforces, n)(*a) for n, a in fs], **kw)) == handles[-1]
    if boundary is not None:
        jw.add_boundary(Boundary(boundary))
        tw.add_boundary(st.Boundary(boundary))
    return handles


def _grid2(n, origin):
    xs = np.arange(n) * 2.0 * RADIUS
    g = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    return (g + np.asarray(origin)).astype(np.float32)


def _multi_fluid_pair():
    """tests/test_world.py's multi-fluid world with freed slots, and a
    floor."""
    pair = _pair()
    fa, fb = _add(pair, [(_grid2(4, (-0.5, 0.0)), dict(density0=1000.0)),
                         (_grid2(4, (0.3, 0.0)), dict(density0=1000.0))],
                  boundary=np.stack([np.arange(-1.0, 1.0, 0.1),
                                     np.full(20, -0.1)], -1)
                  .astype(np.float32))
    for w in pair:
        w.delete_particles(fa, [0, 3, 7])
    return pair, fa, fb


def _fields(state):
    out = {}
    for f in dataclasses.fields(state):
        arr = np.asarray(getattr(state, f.name))
        if f.name in ("memberships", "filter"):
            arr = arr.astype(np.int64)
        out[f.name] = arr
    return out


def _sort_both(jw, tw):
    """``z_sort`` both worlds: the port's permutation must be JAX's (read
    from a tag planted in the JAX world's volumes), the port's state and
    solver state its own rows in that order, and the slot mirrors JAX's."""
    before = _fields(tw.fluids_state)
    solver = tw._solver_state.clone() if tw._solver_state is not None \
        else None
    volumes = jw.fluids_state.volumes
    jw.fluids_state = jw.fluids_state.replace(
        volumes=jnp.arange(volumes.shape[0], dtype=jnp.float32))
    jw.z_sort()
    want = np.asarray(jw.fluids_state.volumes).astype(np.int64)
    jw.fluids_state = jw.fluids_state.replace(volumes=volumes[want])
    perm = tw.z_sort()
    np.testing.assert_array_equal(perm, want)
    after = _fields(tw.fluids_state)
    for name, arr in before.items():
        np.testing.assert_array_equal(after[name], arr[perm], err_msg=name)
    if solver is not None:
        assert torch.equal(tw._solver_state, solver[torch.tensor(perm)])
    np.testing.assert_array_equal(tw._fluid_alive, jw._fluid_alive)
    np.testing.assert_array_equal(tw._fluid_slot_owner, jw._fluid_slot_owner)
    return perm


def _step_both(jw, tw, steps, gravity=(0.0, -9.81)):
    for _ in range(steps):
        jw.step(1.0 / 200.0, gravity)
        tw.step(1.0 / 200.0, gravity)
        sj, stt = jw.last_diagnostics.solver, tw.last_diagnostics.solver
        assert (int(stt.pressure_iters), int(stt.divergence_iters)) == (
            int(sj.pressure_iters), int(sj.divergence_iters))
        np.testing.assert_allclose(tw.fluids_state.positions.numpy(),
                                   np.asarray(jw.fluids_state.positions),
                                   rtol=0, atol=POS_ATOL)


def test_z_sort_on_cell_edges_matches_eager_jax():
    """On the cell-edge lattice the sort's cells divide (JAX's eager
    ``z_sort``): the same permutation, which the search's rounding would
    not give."""
    pos = _edge_lattice(2)
    # Dead slots in the middle of the array.
    pair = _pair()
    (h,) = _add(pair, [(pos, dict(density0=1000.0))])
    for w in pair:
        w.delete_particles(h, np.arange(5, 2500, 11))
    perm = _sort_both(*pair)
    assert sorted(perm.tolist()) == list(range(pair[1].fluids_state.capacity))
    assert (perm != np.arange(len(perm))).any()


def test_z_sort_multi_fluid_matches_jax():
    (jw, tw), fa, fb = _multi_fluid_pair()
    _step_both(jw, tw, 3)
    _sort_both(jw, tw)
    for h in (fa, fb):
        np.testing.assert_allclose(tw.fluid_positions(h),
                                   jw.fluid_positions(h), rtol=0,
                                   atol=POS_ATOL)
    _step_both(jw, tw, 2)


def test_z_sort_carries_the_elasticity_rest_state():
    """An elastic block beside a plain one: the rest state's rows and its
    ``rest_j`` move with the sort as JAX's do, and the next steps agree."""
    pair = _pair()
    _add(pair, [(_grid2(5, (0.6, 0.3)), dict(density0=1000.0)),
                (_grid2(6, (-0.6, 0.2)), dict(
                    density0=1000.0,
                    forces=[("Becker2009Elasticity", (50_000.0, 0.3,
                                                      True))]))],
         boundary=np.stack([np.arange(-1.0, 1.2, 0.1), np.full(22, -0.1)],
                           -1).astype(np.float32))
    jw, tw = pair
    _step_both(jw, tw, 2)
    _sort_both(jw, tw)
    je, te = jw._elasticity_state, tw._elasticity_state
    np.testing.assert_array_equal(te.rest_j.numpy(), np.asarray(je.rest_j))
    np.testing.assert_array_equal(te.rest_valid.numpy(),
                                  np.asarray(je.rest_valid))
    np.testing.assert_allclose(te.positions0.numpy(),
                               np.asarray(je.positions0), rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(te.rest_w.numpy(), np.asarray(je.rest_w),
                               rtol=1e-6, atol=1e-6)
    _step_both(jw, tw, 2)


def test_aabb_queries_match_jax():
    (jw, tw), fa, fb = _multi_fluid_pair()
    _step_both(jw, tw, 2)
    boxes = [((-2.0, -1.0), (2.0, 2.0)), ((0.25, -1.0), (2.0, 2.0)),
             ((-0.3, -0.2), (0.1, 0.15)),
             (np.float32([-0.45, 0.0]), np.float32([0.0, 0.3])),
             ((5.0, 5.0), (6.0, 6.0))]
    for mins, maxs in boxes:
        got = tw.particles_intersecting_aabb(mins, maxs)
        assert got == jw.particles_intersecting_aabb(mins, maxs)
    assert {k for k, _, _ in tw.particles_intersecting_aabb(*boxes[0])} \
        == {"fluid", "boundary"}


def test_shape_queries_match_jax():
    from salva_tpu import shapes as jshapes

    (jw, tw), _, _ = _multi_fluid_pair()
    _step_both(jw, tw, 2)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    for name, args, t in (("Ball", (0.25,), (-0.35, 0.2)),
                          ("Cuboid", ((0.3, 0.1),), (0.4, 0.1)),
                          ("Capsule", (0.2, 0.1), (0.0, 0.0))):
        js, ts = getattr(jshapes, name)(*args), getattr(tshapes, name)(*args)
        for r in (np.eye(2, dtype=np.float32), rot):
            want = jw.particles_intersecting_shape(js, jnp.asarray(r),
                                                   jnp.asarray(t))
            got = tw.particles_intersecting_shape(ts, r, np.asarray(t))
            assert got == want, name
            assert got, name


def test_trimesh_query_matches_jax():
    """A 3D world queried with a cube mesh: the same tuples, through the
    voxelized field of each package."""
    from test_voxelize import cube_mesh

    pair = _pair(dim=3)
    xs = np.arange(-6, 7) * 0.09
    pos = np.stack(np.meshgrid(xs, xs, xs[:4], indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    _add(pair, [(pos, dict(density0=1000.0))])
    jw, tw = pair
    jm = cube_mesh(0.3)
    tm = tshapes.TriMesh(jm.vertices, jm.indices)
    t = np.array([0.05, 0.1, 0.0], np.float32)
    want = jw.particles_intersecting_shape(jm, jnp.eye(3), jnp.asarray(t))
    got = tw.particles_intersecting_shape(tm, np.eye(3), t)
    assert got == want and len(got) > 50
