"""The gather layout's neighbour search of the PyTorch port against the JAX
package, on the CPU.

``geometry/grid.py``, ``neighbors.py`` and ``contacts.py`` of both
packages on the same seeded numpy clouds, in 2D and 3D:

- a random cloud over negative and positive coordinates with 10% dead
  particles, two interaction groups and two models, searched in query
  blocks smaller than N (the multi-block branch), against itself and
  against a second set (the fluid-boundary form, no same-model rule);
- a lattice on the cells' edges (coordinates that are multiples of h);
- cells that alias at the key period (1024 cells per axis in 3D, 32768
  in 2D);
- a packed cluster with small K and C, so that both overflows count.

Integer outputs are held exactly: Morton keys, ``build_grid``'s order and
sorted keys, cell coordinates, the neighbour tables' ``idx``, ``valid``
and ``count`` (invalid slots included: the compaction is stable), and
``overflow`` / ``cand_overflow`` (the JAX package also counts the
candidate-window truncation of its padding rows). ``weighted_sum_over_
neighbors`` and the contacts' ``w`` / ``grad`` are held within rtol 1e-6
plus atol 1e-6 x each output's peak (float32 summation order only). The
boundary-force scatter (``Contacts.scatter_table``, the port's atomic-free
form) is held bitwise to the JAX package's scatter-add on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.geometry import contacts as jc
from salva_tpu.geometry import grid as jg
from salva_tpu.geometry import neighbors as jn
from salva_tpu.kernels import sph as jsph
from salva_tpu.solver import common as jcommon
from salva_tpu_torch.geometry import contacts as tc
from salva_tpu_torch.geometry import grid as tg
from salva_tpu_torch.geometry import neighbors as tn
from salva_tpu_torch.kernels import sph as tsph
from salva_tpu_torch.solver import common as tcommon

torch.set_num_threads(1)

H = 0.2
TOL = 1e-6  # rtol, and atol x the output's peak
ALL = 0xFFFFFFFF


def _cloud(dim, n=300, seed=0, scale=1.0):
    """(positions, alive, memberships, filter, model) as numpy."""
    rng = np.random.default_rng(seed + dim)
    pos = rng.uniform(-scale, scale, size=(n, dim)).astype(np.float32)
    alive = rng.uniform(size=n) > 0.1
    mem = rng.choice([1, 2], size=n).astype(np.uint32)
    flt = rng.choice([1, 2, ALL], size=n).astype(np.uint32)
    model = rng.integers(0, 2, size=n).astype(np.int32)
    return pos, alive, mem, flt, model


def _edge_lattice(dim):
    """Particles on the cells' edges and corners (multiples of h, some
    negative) and halfway between them."""
    ax = (np.arange(-4, 5) * 0.5 * H).astype(np.float32)
    pos = np.stack(np.meshgrid(*([ax] * dim), indexing="ij"),
                   -1).reshape(-1, dim).astype(np.float32)
    n = len(pos)
    return (pos, np.ones(n, bool), np.ones(n, np.uint32),
            np.full(n, ALL, np.uint32), np.zeros(n, np.int32))


def _aliased(dim):
    """Pairs of particles whose cells lie one key period apart (the
    Morton keys alias), plus a near cluster."""
    period = (1 << tg.MORTON_BITS[dim]) * H
    rng = np.random.default_rng(7)
    near = rng.uniform(-0.3, 0.3, size=(40, dim)).astype(np.float32)
    far = near.copy()
    far[:, 0] += np.float32(period)
    far2 = near.copy()
    far2[:, -1] -= np.float32(period)
    pos = np.concatenate([near, far, far2]).astype(np.float32)
    n = len(pos)
    return (pos, np.ones(n, bool), np.ones(n, np.uint32),
            np.full(n, ALL, np.uint32), np.zeros(n, np.int32))


def _cluster(dim):
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.15, 0.15, size=(120, dim)).astype(np.float32)
    n = len(pos)
    return (pos, np.ones(n, bool), np.ones(n, np.uint32),
            np.full(n, ALL, np.uint32), np.zeros(n, np.int32))


def _jax_set(c):
    pos, alive, mem, flt, model = c
    return (jnp.asarray(pos), jnp.asarray(alive),
            jn.GroupInfo(jnp.asarray(mem), jnp.asarray(flt),
                         jnp.asarray(model)))


def _torch_set(c):
    pos, alive, mem, flt, model = c
    return (torch.tensor(pos), torch.tensor(alive),
            tn.GroupInfo(torch.tensor(mem.astype(np.int64)),
                         torch.tensor(flt.astype(np.int64)),
                         torch.tensor(model)))


# (scene, K, C, query_chunk, expect overflow, expect candidate overflow)
CASES = {
    "random": (_cloud, 64, 288, 97, False, False),
    "edge_lattice": (_edge_lattice, 64, 288, 128, False, False),
    "aliased": (_aliased, 64, 288, 50, False, False),
    "overflow": (_cluster, 12, 40, 64, True, True),
}


def _search(q, s, same_model, K, C, chunk, dim, torch_side):
    mod, grid_mod = (tn, tg) if torch_side else (jn, jg)
    qp, qa, qg = q
    sp, sa, sg = s
    grid = grid_mod.build_grid(sp, sa, H, dim)
    nl = mod.find_neighbors(qp, qa, qg, grid, sp, sa, sg, H, dim, K, C,
                            same_model, query_chunk=chunk)
    return grid, nl


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what):
    got, want = _np(got), _np(want)
    peak = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * peak,
                               err_msg=what)


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_keys_and_cells_exact(dim):
    rng = np.random.default_rng(dim)
    # Negative cells and cells past the key period wrap alike.
    cells = rng.integers(-70000, 70000, size=(500, dim)).astype(np.int32)
    np.testing.assert_array_equal(
        tg.morton_key(torch.tensor(cells), dim).numpy(),
        np.asarray(jg.morton_key(jnp.asarray(cells), dim)).astype(np.int64))
    for pos in (_edge_lattice(dim)[0], _cloud(dim, scale=50.0)[0]):
        np.testing.assert_array_equal(
            tg.cell_coords(torch.tensor(pos), H).numpy(),
            np.asarray(jg.cell_coords(jnp.asarray(pos), H)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_and_neighbor_tables_exact(dim, case):
    scene, K, C, chunk, want_over, want_cand = CASES[case]
    c = scene(dim)
    src = _cloud(dim, n=150, seed=11)
    for s_c, same_model in ((c, True), (src, False)):
        jg_, jnl = _search(_jax_set(c), _jax_set(s_c), same_model, K, C,
                           chunk, dim, torch_side=False)
        tg_, tnl = _search(_torch_set(c), _torch_set(s_c), same_model, K, C,
                           chunk, dim, torch_side=True)
        np.testing.assert_array_equal(tg_.order.numpy(),
                                      np.asarray(jg_.order))
        np.testing.assert_array_equal(
            tg_.sorted_keys.numpy(),
            np.asarray(jg_.sorted_keys).astype(np.int64))
        np.testing.assert_array_equal(tg_.cells.numpy(),
                                      np.asarray(jg_.cells))
        for f in ("idx", "valid", "count", "overflow", "cand_overflow"):
            np.testing.assert_array_equal(_np(getattr(tnl, f)),
                                          _np(getattr(jnl, f)), err_msg=f)
        if same_model:
            assert (int(tnl.overflow) > 0) == want_over
            assert (int(tnl.cand_overflow) > 0) == want_cand
            assert int(tnl.valid.sum()) > 0
            self_nl = tnl
    if case == "aliased":
        # The far copies share the near particles' keys but never pass
        # the distance test.
        n = len(c[0]) // 3
        keys = tg.morton_key(tg.cell_coords(torch.tensor(c[0]), H), dim)
        assert torch.equal(keys[:n], keys[n:2 * n])
        assert torch.equal(keys[:n], keys[2 * n:])
        near_rows = self_nl.idx[:n][self_nl.valid[:n]]
        assert bool((near_rows < n).all())


@pytest.mark.parametrize("kernels", [("cubic", "cubic"), ("poly6", "spiky")])
@pytest.mark.parametrize("dim", [2, 3])
def test_weighted_sums_and_contacts(dim, kernels):
    c = _cloud(dim, seed=5)
    q_j, q_t = _jax_set(c), _torch_set(c)
    kd, kg = kernels
    jw, jdw = jsph.get_kernel(kd)[0], jsph.get_kernel(kg)[1]
    tw, tdw = tsph.get_kernel(kd)[0], tsph.get_kernel(kg)[1]
    grid_j = jg.build_grid(q_j[0], q_j[1], H, dim)
    grid_t = tg.build_grid(q_t[0], q_t[1], H, dim)
    ws_j, co_j = jn.weighted_sum_over_neighbors(
        *q_j, grid_j, *q_j, H, dim, 40, True, jw,
        query_chunk=128)
    ws_t, co_t = tn.weighted_sum_over_neighbors(
        *q_t, grid_t, *q_t, H, dim, 40, True, tw,
        query_chunk=128)
    _close(ws_t, ws_j, "wsum")
    assert int(co_t) == int(co_j)

    _, nl_j = _search(q_j, q_j, True, 64, 288, 128, dim, False)
    _, nl_t = _search(q_t, q_t, True, 64, 288, 128, dim, True)
    cj = jc.evaluate_contacts(q_j[0], q_j[0], nl_j, H, dim, w_fn=jw,
                              dw_fn=jdw)
    ct = tc.evaluate_contacts(q_t[0], q_t[0], nl_t, H, dim, w_fn=tw,
                              dw_fn=tdw)
    for f in ("j", "valid", "count"):
        np.testing.assert_array_equal(_np(getattr(ct, f)),
                                      _np(getattr(cj, f)), err_msg=f)
    _close(ct.w, cj.w, "w")
    _close(ct.grad, cj.grad, "grad")
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))


@pytest.mark.parametrize("dim", [2, 3])
def test_boundary_scatter_matches_the_jax_scatter(dim):
    """``scatter_boundary_forces`` sums each boundary particle's
    contributions in flat table order, which is the JAX package's CPU
    scatter-add order: bitwise equal, onto a nonzero accumulator."""
    fl, bd = _cloud(dim, seed=21), _cloud(dim, n=90, seed=22)
    _, nl_j = _search(_jax_set(fl), _jax_set(bd), False, 64, 288, 128, dim,
                      False)
    _, nl_t = _search(_torch_set(fl), _torch_set(bd), False, 64, 288, 128,
                      dim, True)
    cj = jc.evaluate_contacts(jnp.asarray(fl[0]), jnp.asarray(bd[0]), nl_j,
                              H, dim)
    ct = tc.evaluate_contacts(torch.tensor(fl[0]), torch.tensor(bd[0]),
                              nl_t, H, dim)
    rng = np.random.default_rng(dim)
    contrib = (rng.normal(size=ct.grad.shape).astype(np.float32)
               * ct.mask.numpy()[..., None])
    start = rng.normal(size=(len(bd[0]), dim)).astype(np.float32)
    got = tcommon.scatter_boundary_forces(torch.tensor(start), ct,
                                          torch.tensor(contrib))
    want = jcommon.scatter_boundary_forces(jnp.asarray(start), cj,
                                           jnp.asarray(contrib))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Every valid slot lands once in the table, in flat order per row.
    table = ct.scatter_table(len(bd[0]))
    flat = table[table < ct.j.numel()]
    assert flat.numel() == int(ct.valid.sum())
    assert torch.equal(torch.sort(flat).values,
                       torch.nonzero(ct.valid.reshape(-1)).squeeze(1))
