"""Dense-grid binning of the PyTorch port against
``salva_tpu.geometry.dense_grid``: identical slot assignment (``slot_of``,
``mask``, ``grid_src``), exact overflow / clamp counts, identical active
tables and neighbor tables, on a clustered random fixture whose clusters
overflow the cell cap."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.geometry import dense_grid as jdg
from salva_tpu_torch.geometry import dense_grid as tdg

H = 0.2


# The JAX side runs jitted: one compile per function and shape instead of
# one per eager op (same numbers; the grid spec and flags are static).
@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


def _jbin(spec, pos, alive, **kw):
    return _jit(jdg.bin_particles, "spec", "drop_clamped")(
        spec=spec, positions=pos, alive=alive, **kw)


def _jbin_active(spec, max_active, pos, alive, **kw):
    return _jit(jdg.bin_particles_active, "spec", "max_active", "cap",
                "drop_clamped")(spec=spec, max_active=max_active,
                                positions=pos, alive=alive, **kw)


def _fixture(dim, seed=0):
    """Uniform background + dense clusters (> cap particles per cell in
    places) + a few escapees outside the box, ~1/7 dead."""
    rng = np.random.default_rng(seed)
    lo, hi = 0.0, 1.2
    bg = rng.uniform(lo, hi, size=(300, dim))
    centers = rng.uniform(lo + 0.2, hi - 0.2, size=(8, dim))
    clusters = (centers[:, None, :]
                + rng.uniform(-0.04, 0.04, size=(8, 24, dim))).reshape(-1, dim)
    escapees = rng.uniform(-0.6, 1.8, size=(12, dim))
    pos = np.concatenate([bg, clusters, escapees]).astype(np.float32)
    alive = rng.random(len(pos)) > 1.0 / 7.0
    return pos, alive, ((lo,) * dim, (hi,) * dim)


def _both(pos, alive):
    return (jnp.asarray(pos), jnp.asarray(alive),
            torch.from_numpy(pos), torch.from_numpy(alive))


def _assert_same(jb, tb, fields):
    for f in fields:
        j = np.asarray(getattr(jb, f))
        t = getattr(tb, f).numpy()
        assert j.shape == t.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("cap", [8, 16])
def test_bin_particles_matches(dim, cap):
    pos, alive, (mins, maxs) = _fixture(dim)
    js = jdg.spec_for_aabb(mins, maxs, H, cap)
    ts = tdg.spec_for_aabb(mins, maxs, H, cap)
    assert (ts.origin, ts.dims, ts.cap) == (js.origin, js.dims, js.cap)
    pj, aj, pt, at = _both(pos, alive)
    jb = _jbin(js, pj, aj)
    tb = tdg.bin_particles(ts, pt, at)
    _assert_same(jb, tb, ("slot_of", "in_grid", "mask", "grid_src",
                          "overflow", "clamped"))
    assert int(tb.overflow) > 0  # the clusters overflow the cap
    assert int(tb.clamped) > 0  # the escapees clamp into the border ring


@pytest.mark.parametrize("dim", [2, 3])
def test_bin_particles_window_origin_matches(dim):
    """Fitted-window binning: a smaller window with a traced origin, and
    out-of-window particles dropped instead of clamped."""
    pos, alive, (mins, maxs) = _fixture(dim, seed=1)
    js = jdg.spec_for_aabb(mins, maxs, H, 16)
    js = js.replace(dims=tuple(max(3, d - 3) for d in js.dims))
    ts = tdg.DenseGridSpec(js.origin, js.dims, js.cap, js.cell_width)
    origin = np.asarray(js.origin, np.float32) + np.float32(H)
    pj, aj, pt, at = _both(pos, alive)
    for drop in (False, True):
        jb = _jbin(js, pj, aj, drop_clamped=drop,
                   origin=jnp.asarray(origin))
        tb = tdg.bin_particles(ts, pt, at, drop_clamped=drop,
                               origin=torch.from_numpy(origin))
        _assert_same(jb, tb, ("slot_of", "in_grid", "mask", "grid_src",
                              "overflow", "clamped"))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("max_active", [12, 400])
def test_bin_particles_active_and_neighbor_table_match(dim, max_active):
    """Compact binning, including active-table overflow (12 columns are
    fewer than the occupied cells) and the void column."""
    pos, alive, (mins, maxs) = _fixture(dim, seed=2)
    js = jdg.spec_for_aabb(mins, maxs, H, 16)
    ts = tdg.spec_for_aabb(mins, maxs, H, 16)
    pj, aj, pt, at = _both(pos, alive)
    for drop in (False, True):
        jb = _jbin_active(js, max_active, pj, aj, cap=12,
                          drop_clamped=drop)
        tb = tdg.bin_particles_active(ts, max_active, pt, at, cap=12,
                                      drop_clamped=drop)
        _assert_same(jb, tb, (
            "slot_of", "in_grid", "mask", "active_cells", "cell_to_active",
            "overflow", "clamped", "active_overflow", "grid_src",
        ))
        jn = jdg.neighbor_table(js, jb.active_cells, jb.cell_to_active)
        tn = tdg.neighbor_table(ts, tb.active_cells, tb.cell_to_active)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert (int(tb.active_overflow) > 0) == (max_active == 12)


@pytest.mark.parametrize("dim", [2, 3])
def test_layout_shuffles_match(dim):
    """to_grid / to_grid_multi / from_grid / from_grid_multi round trips
    are bitwise the JAX package's."""
    pos, alive, (mins, maxs) = _fixture(dim, seed=3)
    js = jdg.spec_for_aabb(mins, maxs, H, 16)
    ts = tdg.spec_for_aabb(mins, maxs, H, 16)
    pj, aj, pt, at = _both(pos, alive)
    jb = _jbin(js, pj, aj)
    tb = tdg.bin_particles(ts, pt, at)
    vel = np.random.default_rng(4).normal(size=pos.shape).astype(np.float32)
    items_j = [(pj, jdg.POS_SENTINEL), (jnp.asarray(vel), 0.0)]
    items_t = [(pt, tdg.POS_SENTINEL), (torch.from_numpy(vel), 0.0)]
    gj = jdg.to_grid_multi(js, jb, items_j)
    gt = tdg.to_grid_multi(ts, tb, items_t)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tdg.to_grid(ts, tb, pt[:, 0], fill=-1.0).numpy(),
        np.asarray(jdg.to_grid(js, jb, pj[:, 0], fill=-1.0)),
    )
    back_j = jdg.from_grid_multi(js, jb, gj)
    back_t = tdg.from_grid_multi(ts, tb, gt)
    for a, b in zip(back_j, back_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        tdg.from_grid(ts, tb, gt[1], default=7.0).numpy(),
        np.asarray(jdg.from_grid(js, jb, gj[1], default=7.0)),
    )


def test_shift_j_and_offsets_match():
    spec = tdg.DenseGridSpec((0.0,) * 3, (4, 5, 6), 2, H)
    arr = torch.arange(2 * spec.num_cells, dtype=torch.float32).reshape(2, -1)
    jspec = jdg.DenseGridSpec((0.0,) * 3, (4, 5, 6), 2, H)
    assert tdg.neighbor_offsets(3) == jdg.neighbor_offsets(3)
    assert tdg.neighbor_offsets(2) == jdg.neighbor_offsets(2)
    for off in tdg.neighbor_offsets(3):
        np.testing.assert_array_equal(
            tdg.shift_j(spec, arr, off).numpy(),
            np.asarray(jdg.shift_j(jspec, jnp.asarray(arr.numpy()), off)),
        )
