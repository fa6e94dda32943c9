"""The dense+spill pair structure (``dense_spill_columns``), run by both
packages on the CPU.

Mirrors ``tests/test_spill.py``: ranks past the cap of an over-cap cell
land in spill columns appended to the column axis; tiny caps force the
structure to engage, so that all four pair-block classes (main / spill
x main / spill) carry real pairs.

- The binning: the JAX tests' cases (their counts), and seeded random
  inputs against the JAX package's binning (every field equal, layout
  shuffles bitwise).
- The 2D world of ``test_spill.py`` (an 8 x 8 block at 1.5 r spacing,
  ~7 a cell, cap 5, E = 128, K = 9) stepped by both packages from the
  same inputs: identical iterations, exact contact, overflow and spill
  overflow counts, positions within ``atol=2e-6`` and velocities and the
  solver state within 1e-5 x their peak at every step (the compressed
  block bursts outward at up to ~10 m/s). The port's fb fallback (no sparse fb table) against
  the same JAX run.
- Against the port's gather layout and its plain cap-16 grid (the JAX
  tests' bounds), determinism, the table overflows against independent
  counts, the auto tier (resolution beside the JAX package's, and its
  self-heal), and the 3D block against the port's cap-16 grid. The 3D
  world against the JAX package is ``slow``.
"""

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.geometry import dense_grid as tdg

from test_torch_compact import (
    DT,
    RADIUS,
    block,
    check_against_jax,
    dense_ctx,
    gravity,
    layout_world,
    run_pair,
    snapshot,
)

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

STEPS = 6
SPILL = dict(caps=(5, 16), fit_grid=False, dense_spill_columns=128,
             dense_spill_k=9)
BIN_FIELDS = ("slot_of", "in_grid", "mask", "overflow", "clamped",
              "spill_cells", "cell_to_spill", "spill_col_overflow")


def spill_block_2d():
    """``tests/test_spill.py::_dam_world_2d``'s block: 8 x 8 at 1.5 r,
    compressed past rest density (~7 a cell, 9 at worst), so with cap 5
    every occupied cell spills at t = 0."""
    return block(2, 8, 1.5 * RADIUS, (-0.9, 0.02))


def bin_spill(lo, hi, width, cap, pos, spill_cols):
    spec = tdg.spec_for_aabb(lo, hi, width, cap=cap)
    return spec, tdg.bin_particles(spec, torch.from_numpy(pos),
                                   torch.ones(len(pos), dtype=torch.bool),
                                   spill_cols=spill_cols)


def test_spill_bin_roundtrip():
    """20 particles in one cell, cap 4 (spill rows min(8, cap) = 4): ranks
    0..7 held, 12 dropped and counted (the JAX test's numbers); a round
    trip through the extended grid."""
    pos = np.zeros((20, 2), np.float32)
    spec, b = bin_spill((0.0, 0.0), (1.0, 1.0), 10.0, 4, pos, 8)
    C = spec.num_cells
    assert b.mask.shape == (4, C + 8 + 1)
    assert int(b.mask[:, :C].sum()) == int(b.mask[:, C:].sum()) == 4
    assert int(b.overflow) == 12 and int(b.spill_col_overflow) == 0
    assert int((b.spill_cells < C).sum()) == 1
    ext = tdg.ActiveSpec(C + 9, 4)
    vals = torch.arange(20, dtype=torch.float32)
    back = tdg.from_grid(ext, b, tdg.to_grid(ext, b, vals, fill=-1.0),
                         default=-7.0)
    kept = b.in_grid
    assert int(kept.sum()) == 8
    assert torch.equal(back[kept], vals[kept])
    assert bool((back[~kept] == -7.0).all())


def test_spill_col_overflow_counted():
    """Two over-cap cells and a one-column spill table: the second cell's
    over-rank particles are dropped and its column counted (the JAX
    test's numbers)."""
    pos = np.zeros((12, 2), np.float32)
    pos[6:, 0] = 2.5
    spec, b = bin_spill((0.0, 0.0), (4.0, 4.0), 1.0, 2, pos, 1)
    assert int(b.spill_col_overflow) == 1
    assert int(b.overflow) == 6
    assert int((b.spill_cells < spec.num_cells).sum()) == 1


@pytest.mark.parametrize("spill_cols", [3, 64])
def test_spill_binning_matches_jax(spill_cols):
    """Seeded random particles (some dead, some outside the box): every
    binning field equal to the JAX package's, and the layout shuffles
    (float and int channels) bitwise its ``to_grid``."""
    from salva_tpu.geometry import dense_grid as jdg

    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    pos = (rng.random((400, 2)) * 2.2 - 0.1).astype(np.float32)
    alive = rng.random(400) > 0.1
    jb = jdg.bin_particles(
        jdg.spec_for_aabb((0.0, 0.0), (2.0, 2.0), 0.25, cap=4),
        jnp.asarray(pos), jnp.asarray(alive), spill_cols=spill_cols)
    spec = tdg.spec_for_aabb((0.0, 0.0), (2.0, 2.0), 0.25, cap=4)
    tb = tdg.bin_particles(spec, torch.from_numpy(pos),
                           torch.from_numpy(alive), spill_cols=spill_cols)
    for f in BIN_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert int(tb.spill_col_overflow) > 0 if spill_cols == 3 else True
    ext = tdg.ActiveSpec(spec.num_cells + spill_cols + 1, 4)
    vals = rng.standard_normal((400, 3)).astype(np.float32)
    ids = rng.integers(0, 3, 400).astype(np.int32)
    for v, fill in ((vals, -1.0), (ids, -1)):
        np.testing.assert_array_equal(
            tdg.to_grid(ext, tb, torch.from_numpy(v), fill=fill).numpy(),
            np.asarray(jdg.to_grid(ext, jb, jnp.asarray(v), fill=fill)))


@pytest.fixture(scope="module")
def runs():
    return run_pair(spill_block_2d(), steps=STEPS, **SPILL)


def test_spill_matches_jax(runs):
    # The compressed block bursts outward at up to ~10 m/s (velocity
    # changes of ~3 m/s in the solver state), and the float32 summation
    # order of the 2e-6 m position gap grows there to 4.9e-6 of the
    # peak: velocities and the state within 1e-5 x their peak.
    check_against_jax(runs, vel_atol=1e-5, state_atol=1e-5)
    assert runs["torch"][-1]["counts"]["ncontacts_fb"] > 0


def test_spill_engaged():
    """At t = 0 every occupied cell of the block holds more than cap 5:
    the spill columns carry particles, and the extended axis is
    C + E + 1 wide."""
    w, _, _ = layout_world("torch", spill_block_2d(), **SPILL)
    ctx = dense_ctx(w)
    C = ctx.spec_f.num_cells
    assert ctx.maskf.shape[-1] == C + 128 + 1
    assert int(ctx.maskf[:, C:].sum()) > 0
    assert int((ctx.binf.spill_cells < C).sum()) > 0
    assert int(ctx.bin_overflow) == 0


def test_spill_fb_fallback_matches_jax(runs, monkeypatch):
    """Without the sparse fb table (``dense_fb_columns=None``), the
    full-roll fb hoist on the main slice plus the gathered spill-i block
    over each spill column's boundary neighborhood: still within 2e-6 of
    the JAX run, with its contact counts."""
    monkeypatch.setattr(st.LiquidWorld, "_resolved_fb_columns",
                        lambda self, sim: None)
    w, fl, _ = layout_world("torch", spill_block_2d(), **SPILL)
    for j in runs["jax"]:
        w.step(DT, gravity(2))
        assert w._effective_sim().dense_fb_columns is None
        t = snapshot(w, fl)
        assert t["iters"] == j["iters"] and t["counts"] == j["counts"]
        np.testing.assert_allclose(t["pos"], j["pos"], rtol=0, atol=2e-6)


def test_spill_matches_gather_and_plain_2d(runs):
    """``test_spill.py``'s bounds against the port's gather layout (exact
    contact counts) and against its plain cap-16 grid: the same physics,
    only summation order differs."""
    spill = runs["torch"]
    for layout, caps in (("gather", (None, None)), ("dense", (16, 16))):
        w, fl, _ = layout_world("torch", spill_block_2d(), caps=caps,
                                fit_grid=False, layout=layout)
        for s in spill:
            w.step(DT, gravity(2))
            t = snapshot(w, fl)
            assert s["counts"]["neighbor_overflow"] == 0
            assert t["counts"]["ncontacts_ff"] == s["counts"]["ncontacts_ff"]
            assert t["counts"]["ncontacts_fb"] == s["counts"]["ncontacts_fb"]
        np.testing.assert_allclose(t["pos"], s["pos"], rtol=0, atol=5e-4)
        np.testing.assert_allclose(t["vel"], s["vel"], rtol=0, atol=5e-3)


def test_spill_deterministic(runs):
    """A second run of the spill world is bitwise the first."""
    w, fl, _ = layout_world("torch", spill_block_2d(), **SPILL)
    for s in runs["torch"]:
        w.step(DT, gravity(2))
        assert np.array_equal(np.asarray(w.fluid_positions(fl)), s["pos"])


def test_spill_table_overflows_counted():
    """K = 2 and a 16-column adjacency table on the spilling block: the
    condensed-K and adjacency overflows equal independent counts (spill
    neighbours past K of each adjacent column; occupied main columns next
    to a spill cell past the table), both in ``spill_overflow`` and in
    ``neighbor_overflow``; the world reports them."""
    sim = dict(SPILL, dense_spill_k=2, dense_spill_adj_columns=16)
    w, fl, _ = layout_world("torch", spill_block_2d(), **sim)
    ctx = dense_ctx(w)
    spec, C, E = ctx.spec_f, ctx.spec_f.num_cells, 128
    c2s = ctx.binf.cell_to_spill.numpy()
    occ = (ctx.maskf[:, :C] > 0).any(0).numpy()
    shifts = tdg.flat_shifts(spec)
    n_sp = np.zeros(C, int)
    for s in shifts:
        n_sp += np.roll(c2s < E, -s)  # spill cells among c + s
    adjacent = occ & (n_sp > 0)
    assert int(ctx._spill_adj_overflow) == max(int(adjacent.sum()) - 16, 0)
    cols = np.nonzero(adjacent)[0][:16]
    assert int(ctx.spill_k_overflow) == int(np.maximum(n_sp[cols] - 2,
                                                       0).sum()) > 0
    want = (int(ctx.binf.spill_col_overflow) + int(ctx._spill_adj_overflow)
            + int(ctx.spill_k_overflow))
    assert int(ctx.spill_overflow) == want > 0
    assert int(ctx.bin_overflow) == int(ctx.binf.overflow) + int(
        ctx.binb.overflow) + int(ctx.binb.active_overflow) + int(
        ctx._fb_adj_overflow) + want
    w.step(DT, gravity(2))
    d = w.last_diagnostics
    assert int(d.spill_overflow) > 0 and int(d.spill_k_overflow) > 0
    assert int(d.neighbor_overflow) >= int(d.spill_overflow)


def auto_world(pkg, spill_auto):
    """``test_spill.py::test_auto_tier_picks_spill``'s 3D lattice
    (occupancy 8 > 5), at the auto caps."""
    w, _, _ = layout_world(pkg, block(3, 5, 2 * RADIUS, (-0.2, 0.1, -0.2)),
                           fit_grid=False, dense_spill_auto=spill_auto)
    return w


@pytest.mark.parametrize("spill_auto", [False, True])
def test_auto_tier_picks_spill(spill_auto):
    """Plain 16 by default; 12 with an auto-sized spill table (512) when
    opted in: both packages resolve the same configuration."""
    got = []
    for pkg in ("jax", "torch"):
        sim = auto_world(pkg, spill_auto)._effective_sim()
        got.append((sim.dense_cap, sim.dense_cap_boundary,
                    sim.dense_spill_columns, sim.dense_spill_k))
    assert got[0] == got[1]
    assert (got[1][0], got[1][2]) == ((12, 512) if spill_auto else (16, None))


def overflow_diagnostics(pkg, spill, spill_k):
    """Step diagnostics of one package that report ``spill`` spill-table
    entries (``spill_k`` of them in the K table) and one dropped rank."""
    counts = dict(spill_overflow=spill + spill_k, spill_k_overflow=spill_k,
                  neighbor_overflow=spill + spill_k + 1)
    if pkg == "jax":
        from salva_tpu.step import StepDiagnostics

        return StepDiagnostics.zeros().replace(**counts)
    from salva_tpu_torch.step import StepDiagnostics

    zero = torch.zeros((), dtype=torch.int32)
    return StepDiagnostics(None, zero, zero, zero, zero, zero).replace(
        **{k: torch.tensor(v) for k, v in counts.items()})


def test_auto_tier_self_heals():
    """The world's self-heal on each overflow, beside the JAX package's on
    the same diagnostics: a K overflow widens K toward 3^dim (then leaves
    for the plain 16 tier), a table overflow doubles E, a rank overflow on
    the spill tier takes cap 16 and keeps the table."""
    worlds = {pkg: auto_world(pkg, True) for pkg in ("jax", "torch")}
    cap_b = worlds["torch"]._resolved_dense_caps()[1]

    def bump(spill=0, spill_k=0):
        out = {}
        for pkg, w in worlds.items():
            w._effective_sim()
            w.last_diagnostics = overflow_diagnostics(pkg, spill, spill_k)
            healed = w._bump_auto_dense_cap()
            sim = w._effective_sim()
            out[pkg] = (healed, w._auto_caps, sim.dense_spill_columns,
                        sim.dense_spill_k)
        assert out["torch"] == out["jax"]
        return out["torch"]

    assert bump(spill_k=1) == (True, (12, cap_b), 512, 16)
    assert bump(spill_k=1) == (True, (12, cap_b), 512, 27)
    assert bump(spill=3) == (True, (12, cap_b), 1024, 27)
    assert bump() == (True, (16, cap_b), 1024, 27)
    assert bump(spill_k=1) == (True, (16, cap_b), None, 8)


def test_spill_matches_plain_dense_3d():
    """A 4^3 block at cap 6 (8 a cell: every cell spills 2; E = 256,
    K = 27) against the port's plain cap-16 grid, one step."""
    runs = []
    for sim in (dict(caps=(16, 32)),
                dict(caps=(6, 32), dense_spill_columns=256,
                     dense_spill_k=27)):
        w, fl, _ = layout_world("torch", block(3, 4, 2 * RADIUS,
                                               (-0.2, 0.1, -0.2)),
                                fit_grid=False, **sim)
        snaps = []
        for _ in range(1):
            w.step(DT, gravity(3))
            snaps.append(snapshot(w, fl))
        runs.append(snaps)
    for p, s in zip(*runs):
        assert s["iters"] == p["iters"]
        assert s["counts"] == p["counts"]
        assert s["counts"]["neighbor_overflow"] == 0
        np.testing.assert_allclose(s["pos"], p["pos"], rtol=0, atol=2e-6)


@pytest.mark.slow
def test_spill_matches_jax_3d():
    """``test_spill.py::test_spill_matches_gather_3d``'s world (cap 6,
    E = 256, K = 27) against the JAX package."""
    check_against_jax(run_pair(block(3, 5, 2 * RADIUS, (-0.2, 0.1, -0.2)),
                               steps=4, caps=(6, 32), fit_grid=False,
                               dense_spill_columns=256, dense_spill_k=27))
