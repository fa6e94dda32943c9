"""The binning's sorted-to-slot expansion (``salva_tpu_torch.ops.binning``)
against the JAX package.

``expand_plain`` (the run-table index arithmetic the CUDA kernel
``expand`` shares) is held, exactly (it only moves data), against

- the Pallas prototype the kernel ports, ``tools/exp_pallas_expand.py``'s
  ``build_expand``, run in interpret mode on the CPU (its
  ``pl.pallas_call`` wrapped with ``interpret=True``), on fixtures within
  its DMA window (a block of ``bc`` cells never holds more sorted rows
  than the window; the port has no such limit), with empty and over-cap
  cells and a distinct fill per channel;
- ``salva_tpu.geometry.dense_grid.to_grid_multi`` on the JAX package's own
  ``bin_particles`` and ``bin_particles_active`` of a clustered fixture
  with over-cap cells, dead particles, escapees and (compact binning)
  dropped cells, with fills ``POS_SENTINEL``, 1.0 and 0.0; the port's run
  tables come from its own binning of the same inputs.

On the CPU the wrapper ``expand`` runs ``expand_plain`` and launches
nothing; the port's ``to_grid_multi`` and ``to_grid`` call it, and
``to_grid`` expands integer values (ids, u32 interaction bitmasks) exactly
as JAX ``to_grid`` gathers them.
The kernel itself is held against ``expand_plain`` on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.geometry import dense_grid as jdg
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import binning

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 0.2


@pytest.fixture(scope="module")
def prototype():
    """``tools/exp_pallas_expand.py`` as a module. Importing it sets the
    JAX compilation-cache options; they are put back as they were."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_expand", os.path.join(_ROOT, "tools",
                                          "exp_pallas_expand.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _run_table(cells, C):
    """Sorted cell ids -> the run table of an identity sort order:
    (monotone start [C+1] as the prototype takes it, the port's
    order / start / count)."""
    start = np.searchsorted(cells, np.arange(C + 1), side="left")
    return start.astype(np.int32), types.SimpleNamespace(
        order=torch.arange(len(cells), dtype=torch.int32),
        start=torch.from_numpy(start[:C].astype(np.int32)),
        count=torch.from_numpy(np.diff(start).astype(np.int32)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_plain_matches_the_pallas_prototype(prototype, monkeypatch,
                                                   seed):
    C, cap, ch, n, bc = 64, 4, 8, 150, 16
    rng = np.random.default_rng(seed)
    # Sorted cells with runs of 0..7 particles: empty and over-cap cells.
    cells = np.sort(rng.integers(0, C, n))
    vals = rng.normal(size=(n, ch)).astype(np.float32)
    fills = np.array([tdg.POS_SENTINEL, 1.0, 0.0, -2.5, 3.0, 0.0, 7.0, -1.0],
                     np.float32)
    start, table = _run_table(cells, C)
    assert (np.diff(start) > cap).any() and (np.diff(start) == 0).any()
    monkeypatch.setattr(prototype.pl, "pallas_call", functools.partial(
        prototype.pl.pallas_call, interpret=True))
    expand = prototype.build_expand(cap, ch, bc=bc)
    want = np.asarray(expand(jnp.asarray(vals.T), jnp.asarray(start),
                             jnp.asarray(fills), C))[: C * cap]
    table.mask = torch.zeros((cap, C))
    got = binning.expand_plain(
        table, [(torch.from_numpy(vals[:, k]), float(fills[k]))
                for k in range(ch)])
    # [ch, cap, C] -> the prototype's rows (cell-major, c * cap + r).
    got = torch.stack(got).permute(2, 1, 0).reshape(C * cap, ch).numpy()
    np.testing.assert_array_equal(got, want)


def _fixture(dim, seed=3):
    """Uniform background + clusters over the cap + escapees, ~1/7 dead."""
    rng = np.random.default_rng(seed)
    lo, hi = 0.0, 1.2
    bg = rng.uniform(lo, hi, size=(300, dim))
    centers = rng.uniform(lo + 0.2, hi - 0.2, size=(8, dim))
    clusters = (centers[:, None, :]
                + rng.uniform(-0.04, 0.04, size=(8, 24, dim))).reshape(-1, dim)
    escapees = rng.uniform(-0.6, 1.8, size=(12, dim))
    pos = np.concatenate([bg, clusters, escapees]).astype(np.float32)
    alive = rng.random(len(pos)) > 1.0 / 7.0
    n = len(pos)
    vel = rng.normal(size=(n, dim)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    state = rng.normal(size=(n, dim + 2)).astype(np.float32)
    spec = jdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=8)
    items = [(pos, jdg.POS_SENTINEL), (vel, 0.0), (mass, 1.0), (state, 0.0)]
    return spec, pos, alive, items


@functools.lru_cache(maxsize=None)
def _jit(fn, *static):
    return jax.jit(fn, static_argnames=static)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("layout", ["full", "active"])
def test_expand_plain_matches_jax_to_grid_multi(dim, layout):
    spec, pos, alive, items = _fixture(dim)
    tspec = tdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                              spec.cell_width)
    jpos, jalive = jnp.asarray(pos), jnp.asarray(alive)
    tpos, talive = torch.from_numpy(pos), torch.from_numpy(alive)
    if layout == "full":
        jb = _jit(jdg.bin_particles, "spec")(spec=spec, positions=jpos,
                                             alive=jalive)
        tb = tdg.bin_particles(tspec, tpos, talive)
        js = spec
        assert int(tb.overflow) > 0  # over-cap cells
    else:
        A = 24  # fewer than the occupied cells: some are dropped
        jb = _jit(jdg.bin_particles_active, "spec", "max_active")(
            spec=spec, max_active=A, positions=jpos, alive=jalive)
        tb = tdg.bin_particles_active(tspec, A, tpos, talive)
        js = jdg.ActiveSpec(A + 1, spec.cap)
        assert int(tb.active_overflow) > 0
    want = jdg.to_grid_multi(js, jb, [(jnp.asarray(v), f) for v, f in items])
    t_items = [(torch.from_numpy(v), f) for v, f in items]
    got = binning.expand_plain(tb, t_items)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The CPU wrapper and to_grid_multi (which calls it) give the same
    # bits and launch no kernel.
    before = dict(binning.LAUNCHES)
    for a, b, c in zip(got, binning.expand(tb, t_items),
                       tdg.to_grid_multi(tspec, tb, t_items)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert binning.LAUNCHES == before


@pytest.mark.parametrize("layout", ["full", "active"])
def test_to_grid_of_integer_values_matches_jax(layout):
    """Ids with fill -1, u32 bitmasks (high bits set) and bools expand
    through two float32 channels each, bitwise as JAX gathers them."""
    spec, pos, alive, _ = _fixture(3)
    tspec = tdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                              spec.cell_width)
    jpos, jalive = jnp.asarray(pos), jnp.asarray(alive)
    tpos, talive = torch.from_numpy(pos), torch.from_numpy(alive)
    if layout == "full":
        jb = _jit(jdg.bin_particles, "spec")(spec=spec, positions=jpos,
                                             alive=jalive)
        tb = tdg.bin_particles(tspec, tpos, talive)
        js = spec
    else:
        jb = _jit(jdg.bin_particles_active, "spec", "max_active")(
            spec=spec, max_active=24, positions=jpos, alive=jalive)
        tb = tdg.bin_particles_active(tspec, 24, tpos, talive)
        js = jdg.ActiveSpec(25, spec.cap)
    rng = np.random.default_rng(7)
    n = len(pos)
    ids = rng.integers(0, 5, n).astype(np.int32)
    masks = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    masks[:3] = (0xFFFFFFFF, 0x80000000, 0x0001FFFF)
    flags = rng.random(n) > 0.5
    for vals, t_vals, fill in (
        (ids, torch.from_numpy(ids), -1),
        (masks, torch.from_numpy(masks.astype(np.int64)), 0),
        (flags, torch.from_numpy(flags), False),
    ):
        want = np.asarray(jdg.to_grid(js, jb, jnp.asarray(vals), fill=fill))
        got = tdg.to_grid(tspec, tb, t_vals, fill=fill)
        assert got.dtype == t_vals.dtype
        np.testing.assert_array_equal(got.numpy(), want.astype(
            got.numpy().dtype))


def test_expand_refuses_bad_operands():
    spec, pos, alive, items = _fixture(3)
    tspec = tdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                              spec.cell_width)
    tb = tdg.bin_particles(tspec, torch.from_numpy(pos),
                           torch.from_numpy(alive))
    vel = torch.from_numpy(items[1][0])
    binning.expand(tb, [(vel, 0.0)])  # accepted
    with pytest.raises(TypeError):
        binning.expand(tb, [(vel.double(), 0.0)])
    with pytest.raises(ValueError):
        binning.expand(tb, [(vel[1:], 0.0)])  # not one row per particle
    with pytest.raises(ValueError):
        binning.expand(tb._replace(order=None), [(vel, 0.0)])
    with pytest.raises(ValueError):
        binning.expand(tb._replace(start=tb.start.long()), [(vel, 0.0)])
    with pytest.raises(ValueError):
        binning.expand(tb, [])
