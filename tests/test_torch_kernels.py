"""The hand CUDA kernels of ``salva_tpu_torch.ops.pair`` (the pair
passes), ``salva_tpu_torch.ops.binning`` (the sorted-to-slot
expansion) and ``salva_tpu_torch.ops.rigid`` (the rigid bodies' contact
solve) against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without
one. The file imports torch and the port only (no JAX), so it runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Fixture: a clustered random fluid binned by the port's dense grid, in 2D
and 3D, with cells over 8 particles; for ``hoist_fb``, a moving boundary
layer through it, binned both ways (full grid, compact table with the
adjacency columns, unused entries among them). The tiled ``k_pass`` /
``t_pass`` / ``hoist_ff`` kernels are also held on grids cut to their
tiles (``_tiled_grid``: caps 8 to 48, inner extents that are no multiple
of a tile or shorter than one, the fullest cells on tile edges, an
all-air grid). Tolerances as in
``tests/test_torch_pair_passes.py`` (the kernels walk the full stencil,
the plain versions the half stencil: float32 summation order only);
``expand`` moves data only and must equal ``expand_plain`` bitwise.
"""

import numpy as np
import pytest
import torch

from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import binning, pair

pytestmark = pytest.mark.gpu

H = 0.2
KT_TOL = dict(rtol=1e-4, atol=1e-5)
HOIST_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only there)")
    return torch.device("cuda")


def _grid(dim, device):
    rng = np.random.default_rng(11 + dim)
    lo, hi = 0.0, 1.6
    bg = rng.uniform(lo, hi, size=(600 if dim == 3 else 150, dim))
    centers = (rng.integers(1, 7, size=(12, dim)) + 0.5) * H
    clusters = (centers[:, None, :]
                + rng.uniform(-0.06, 0.06, size=(12, 9, dim))).reshape(-1, dim)
    pos = torch.from_numpy(
        np.concatenate([bg, clusters]).astype(np.float32)
    ).to(device)
    n = pos.shape[0]
    alive = (torch.arange(n, device=device) % 7) != 3
    spec = tdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=24)
    binf = tdg.bin_particles(spec, pos, alive)
    vel = torch.from_numpy(
        rng.normal(size=(n, dim)).astype(np.float32)
    ).to(device)
    P, V = tdg.to_grid_multi(spec, binf, [(pos, tdg.POS_SENTINEL),
                                          (vel, 0.0)])
    M = binf.mask * 0.8
    counts = (binf.mask > 0).sum(dim=0, dtype=torch.int32)
    assert int(counts.max()) > 8
    K = (torch.rand(M.shape, generator=torch.Generator().manual_seed(dim))
         .to(device) * binf.mask * 1e-3)
    return spec, P, M, V, K, counts


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)


def _tiled_grid(dim, cap, window, device):
    """A grid cut for the tiled ``k_pass`` / ``t_pass`` / ``hoist_ff``
    kernels: the inner (z in 3D, y in 2D) extent ``"ragged"`` (2 k_pass
    tiles + 1 cell: no multiple of the tile) or ``"short"`` (one cell less
    than a k_pass tile, at least 3); every interior cell filled to a random
    count below cap - 1, and the first and last cell of a k_pass, a t_pass
    and a hoist_ff tile (interior cells, where the short grid has them) at
    the cap and at cap - 1, so the fullest cells sit on tile edges.
    ``"air"``: the ragged
    grid with no particle. Masses, ``K`` and ``Q`` are scaled so that the
    outputs stay of order 1. Returns (spec, P, M, Q, K, counts, fullest
    cells)."""
    rng = np.random.default_rng(100 * dim + cap)
    other = (5, 4) if dim == 3 else (7,)
    t_k = pair.tiling("k_pass", dim, cap, 1)["tile"]
    inner = 2 * t_k + 1 if window in ("ragged", "air") else max(3, t_k - 1)
    dims = other + (inner,)
    spec = tdg.DenseGridSpec(origin=(0.0,) * dim, dims=dims, cap=cap,
                             cell_width=H)
    C = spec.num_cells
    coords = np.stack(np.unravel_index(np.arange(C), dims), -1)
    interior = np.all((coords >= 1) & (coords <= np.array(dims) - 2), -1)
    if window == "air":
        P = torch.full((dim, cap, C), tdg.POS_SENTINEL, device=device)
        M, K = (torch.zeros((cap, C), device=device) for _ in range(2))
        return (spec, P, M, torch.zeros_like(P), K,
                torch.zeros(C, dtype=torch.int32, device=device), [])
    n_cell = np.where(interior, rng.integers(0, cap - 1, size=C), 0)
    full = []
    for name in TILED:
        tile = pair.tiling(name, dim, cap, C)["tile"]
        for edge in (0, tile - 1):
            cand = [c for c in np.flatnonzero(interior)
                    if c % tile == edge and c not in full]
            if cand:
                full.append(int(cand[len(cand) // 2]))
    n_cell[full] = cap - 1
    n_cell[full[0]] = cap
    cell = np.repeat(np.arange(C), n_cell)
    n = len(cell)
    pos = (coords[cell] + rng.uniform(0.02, 0.98, size=(n, dim))) * H
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    pos = t(pos)
    binf = tdg.bin_particles(spec, pos, torch.ones(n, dtype=torch.bool,
                                                    device=device))
    P, M, Q, K = tdg.to_grid_multi(spec, binf, [
        (pos, tdg.POS_SENTINEL), (t(rng.uniform(0.5, 1.5, size=n)), 0.0),
        (t(rng.normal(size=(n, dim)) * 1e-5), 0.0),
        (t(rng.uniform(0.0, 1e-5, size=n)), 0.0)])
    counts = (binf.mask > 0).sum(dim=0, dtype=torch.int32)
    assert counts.cpu().numpy().tolist() == n_cell.tolist()
    return spec, P, M, Q, K, counts, full


# The kernels of tile_pass_kernel.
TILED = ("k_pass", "t_pass", "hoist_ff")
# (dim, cap, window): the tiled grids of _tiled_grid at every cap the
# world's auto cap reaches, and the clustered fixture of _grid (cap 24).
KT_CASES = ([(dim, cap, window) for dim in (2, 3) for cap in (8, 16, 24, 48)
             for window in ("ragged", "short")]
            + [(dim, 16, "air") for dim in (2, 3)]
            + [(dim, 24, "clustered") for dim in (2, 3)])


@pytest.mark.parametrize("dim,cap,window", KT_CASES)
def test_k_and_t_kernels_match_plain(cuda, dim, cap, window):
    if window == "clustered":
        spec, P, M, Q, K, counts = _grid(dim, cuda)
        full = []
    else:
        spec, P, M, Q, K, counts, full = _tiled_grid(dim, cap, window, cuda)
    C, inner = spec.num_cells, spec.dims[-1]
    for name in ("k_pass", "t_pass"):
        tile = pair.tiling(name, dim, cap, C)["tile"]
        if name == "k_pass" and window == "ragged":
            assert inner % tile != 0
        if name == "k_pass" and window == "short":
            assert inner < tile or inner == 3
        if full:
            assert int(counts[full[0]]) == cap == int(counts.max())
        if window == "ragged":
            assert {c % tile for c in full} >= {0, tile - 1}
    args = (spec, H, dim, "cubic", P, M)
    for name, X in (("k_pass", K), ("t_pass", Q)):
        kern, plain = getattr(pair, name), getattr(pair, name + "_plain")
        # Garbage in the allocator's cached blocks: every output slot must
        # be written by the kernel.
        junk = torch.full((dim + 1,) + tuple(P.shape[1:]), float("nan"),
                          device=cuda)
        del junk
        before = pair.LAUNCHES[name]
        out = kern(*args, X, counts)
        assert pair.LAUNCHES[name] == before + 1
        want = plain(*args, X, counts)
        _assert_close(out, want, KT_TOL)
        assert torch.equal(out, kern(*args, X, counts))  # bitwise rerun
        if window == "air":
            assert int(torch.count_nonzero(out)) == 0
        else:
            assert float(want.abs().max()) > 1e-3  # the sums are not empty


@pytest.mark.parametrize("need_s2", [False, True])
@pytest.mark.parametrize("dim,cap,window", KT_CASES)
def test_hoist_kernel_matches_plain(cuda, dim, cap, window, need_s2):
    if window == "clustered":
        spec, P, M, V, K, counts = _grid(dim, cuda)
        full = []
    else:
        spec, P, M, Q, K, counts, full = _tiled_grid(dim, cap, window, cuda)
    C = spec.num_cells
    t = pair.tiling("hoist_ff", dim, cap, C, need_s2=need_s2)
    assert t["blocks"] == -(-C // t["tile"]) and t["per_sm"] >= 1
    assert 0 < t["smem"] <= 100 * 1024
    if window == "ragged":
        assert {c % t["tile"] for c in full} >= {0, t["tile"] - 1}
    args = (spec, H, dim, "cubic", "cubic", P, M, counts)
    # Garbage in the allocator's cached blocks: every output slot must be
    # written by the kernel (the outputs are views of one allocation).
    junk = torch.full((dim + 4,) + tuple(M.shape), float("nan"),
                      device=cuda)
    del junk
    before = pair.LAUNCHES["hoist_ff"]
    out = pair.hoist_ff(*args, need_s2=need_s2)
    assert pair.LAUNCHES["hoist_ff"] == before + 1
    ref = pair.hoist_ff_plain(*args, need_s2=need_s2)
    for o, r in zip(out, ref):
        assert o.is_contiguous() and o.shape == r.shape and o.dtype == r.dtype
    for o, r in zip(out[:4], ref[:4]):
        _assert_close(o, r, HOIST_TOL)
    assert torch.equal(out[4], ref[4])  # pair counts exact
    again = pair.hoist_ff(*args, need_s2=need_s2)
    assert all(torch.equal(a, b) for a, b in zip(out, again))  # bitwise
    if window == "air":
        assert all(int(torch.count_nonzero(o)) == 0 for o in out)
    else:
        assert int(out[4].sum()) > 0
    assert bool((out[3] != 0).any()) == (need_s2 and window != "air")


def _boundary(spec, device, layout, through=None, counts=None):
    """A jittered moving boundary layer at y ~ 0.5 (or through the centre
    of fluid cell ``through``) through the fluid of :func:`_grid`, as
    ``hoist_fb`` takes it: ``"full"`` binned into the fluid grid's cells
    (identity map, every column), ``"sparse"`` binned into the compact
    occupied-cell table and visited through its boundary-adjacency
    columns, with unused entries in the middle and at the end of the
    table and the 5 last adjacent columns (never ``through``; holding
    fluid, given the fluid's ``counts``) left out, as an overflowing
    table drops them."""
    dim = spec.dim
    rng = np.random.default_rng(23 + dim)
    ticks = np.arange(0.05, 1.6, 0.1)
    grid = np.stack(np.meshgrid(*([ticks] * (dim - 1)), indexing="ij"),
                    axis=-1).reshape(-1, dim - 1)
    y = 0.5
    if through is not None:
        iy = np.unravel_index(through, spec.dims)[1]
        y = spec.origin[1] + (iy + 0.5) * spec.cell_width
    bpos = np.insert(grid, 1, y, axis=1)
    bpos = bpos + rng.uniform(-0.02, 0.02, size=bpos.shape)
    nb = len(bpos)
    bpos = torch.from_numpy(bpos.astype(np.float32)).to(device)
    bvel = torch.from_numpy(
        rng.normal(size=(nb, dim)).astype(np.float32)).to(device)
    vol = torch.from_numpy(
        rng.uniform(1e-3, 2e-3, size=nb).astype(np.float32)).to(device)
    alive = torch.ones(nb, dtype=torch.bool, device=device)
    bspec = spec.replace(cap=8)
    if layout == "full":
        binb = tdg.bin_particles(bspec, bpos, alive)
        sb, cell_to_col, cols = bspec, None, None
    else:
        binb = tdg.bin_particles_active(bspec, 256, bpos, alive)
        sb = tdg.ActiveSpec(257, bspec.cap)
        cell_to_col = binb.cell_to_active
        C = spec.num_cells
        occ = torch.zeros(C + 1, dtype=torch.bool, device=device)
        occ[binb.active_cells.long()] = True
        adj = torch.zeros(C, dtype=torch.bool, device=device)
        for s_ in tdg.flat_shifts(spec):
            adj |= torch.roll(occ[:C], s_)
        ids = torch.nonzero(adj)[:, 0]
        keep = torch.ones_like(ids, dtype=torch.bool)
        drop = ids != (-1 if through is None else through)
        if counts is not None:
            drop &= counts[ids] > 0
        keep[torch.nonzero(drop)[-5:, 0]] = False
        ids = ids[keep]
        half = ids.numel() // 2
        unused = torch.tensor([C, -1, C + 5], device=device)
        cols = torch.cat([ids[:half], unused, ids[half:],
                          torch.full((7,), C, device=device)]).to(torch.int32)
    Pb, Vb, Volb = tdg.to_grid_multi(sb, binb, [(bpos, tdg.POS_SENTINEL),
                                                (bvel, 0.0), (vol, 0.0)])
    counts_b = (binb.mask > 0).sum(dim=0, dtype=torch.int32)
    assert int(counts_b.sum()) == nb
    return (Pb, Volb, Vb, counts_b), dict(cell_to_col=cell_to_col, cols=cols)


@pytest.mark.parametrize("layout", ["full", "sparse"])
@pytest.mark.parametrize("need_s2", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_hoist_fb_kernel_matches_plain(cuda, dim, need_s2, layout):
    spec, P, M, V, K, counts = _grid(dim, cuda)
    C = spec.num_cells
    # The boundary layer runs through the fullest cell, whose last 8-slot
    # group is the fullest rank group of the grid.
    fullest = int(torch.argmax(counts))
    n_full = int(counts[fullest])
    bnd, kw = _boundary(spec, cuda, layout, through=fullest, counts=counts)
    listed = torch.zeros(C, dtype=torch.bool, device=cuda)
    if kw["cols"] is None:
        listed[:] = True
    else:
        cols = kw["cols"].long()
        listed[cols[(cols >= 0) & (cols < C)]] = True
        assert int((~((cols >= 0) & (cols < C))).sum()) == 10
        assert bool(listed[fullest])
    args = (spec, H, dim, "cubic", "cubic", P, counts, *bnd)
    junk = torch.full((dim + 5,) + tuple(P.shape[1:]), float("nan"),
                      device=cuda)
    del junk
    before = pair.LAUNCHES["hoist_fb"]
    out = pair.hoist_fb(*args, need_s2=need_s2, **kw)
    assert pair.LAUNCHES["hoist_fb"] == before + 1
    ref = pair.hoist_fb_plain(*args, need_s2=need_s2, **kw)
    for o, r in zip(out, ref):
        assert o.is_contiguous() and o.shape == r.shape and o.dtype == r.dtype
    for o, r in zip(out[:5], ref[:5]):
        _assert_close(o, r, HOIST_TOL)
    assert torch.equal(out[5], ref[5])  # pair counts exact
    assert int(out[5].sum()) > 0
    assert bool((out[3] != 0).any()) == need_s2
    # Every particle of the fullest rank group pairs with the layer;
    # unlisted columns (dropped from the table) come back zero.
    top = (n_full - 1) // 8 * 8
    assert bool((out[5][top:n_full, fullest] > 0).all())
    for o in out:
        assert int(torch.count_nonzero(o[..., ~listed])) == 0
    if layout == "sparse":  # the dropped columns had pairs to drop
        every = pair.hoist_fb_plain(*args, need_s2=need_s2,
                                    cell_to_col=kw["cell_to_col"])
        assert int(every[5][:, ~listed].sum()) > 0
    # Two launches a call: the zero fill of the packed outputs and the
    # kernel (device activities recorded by the profiler).
    assert 1 <= _device_launches(
        lambda: pair.hoist_fb(*args, need_s2=need_s2, **kw)) <= 2


def _device_launches(fn, tries=3):
    """Device activities (kernels and memory fills) of one ``fn()``, as
    ``torch.profiler`` records them: the most over ``tries`` profiled
    calls (a profile of one short call now and then comes back without
    its device events: an undercount, never an overcount)."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts)


@pytest.mark.parametrize("dim", [2, 3])
def test_k_pass_v2_kernel_matches_plain(cuda, dim):
    spec, P, M, V, K, counts = _grid(dim, cuda)
    args = (spec, H, dim, "cubic", P, M, K, counts)
    before = pair.LAUNCHES["k_pass_v2"]
    out = pair.k_pass_v2(*args)
    assert pair.LAUNCHES["k_pass_v2"] == before + 1
    _assert_close(out, pair.k_pass_plain(*args), KT_TOL)
    # Slots of dead groups are written (zeros), not left uninitialized.
    dead = torch.arange(P.shape[1], device=cuda)[:, None] >= (
        (counts[None, :] + 7) // 8 * 8)
    assert not bool(out[:, dead].any())


def _expand_case(dim, device, layout):
    """A clustered fluid with over-cap cells, dead particles and escapees,
    binned into the full grid or the compact occupied-cell table (with
    dropped cells), and the channels of ``DenseCtx``'s calls (a strided
    [N, D] solver state among them)."""
    rng = np.random.default_rng(41 + dim)
    n = 900 if dim == 3 else 300
    pos = rng.uniform(-0.2, 1.8, size=(n, dim))
    pos[: n // 3] = 0.8 + rng.uniform(-0.05, 0.05, size=(n // 3, dim))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    pos = t(pos)
    alive = torch.from_numpy(rng.random(n) > 0.15).to(device)
    spec = tdg.spec_for_aabb((0.0,) * dim, (1.6,) * dim, H, cap=16)
    if layout == "full":
        binned = tdg.bin_particles(spec, pos, alive)
        assert int(binned.overflow) > 0
    else:
        binned = tdg.bin_particles_active(spec, 48, pos, alive)
        assert int(binned.active_overflow) > 0
    items = [(pos, tdg.POS_SENTINEL), (t(rng.normal(size=(n, dim))), 0.0),
             (t(rng.uniform(size=n)), 1.0),
             (t(rng.normal(size=(n, dim + 2))), 0.0)]
    return binned, items


@pytest.mark.parametrize("layout", ["full", "active"])
@pytest.mark.parametrize("dim", [2, 3])
def test_expand_kernel_equals_plain(cuda, dim, layout):
    binned, items = _expand_case(dim, cuda, layout)
    before = binning.LAUNCHES["expand"]
    out = binning.expand(binned, items)
    assert binning.LAUNCHES["expand"] == before + 1  # one launch, 4 items
    ref = binning.expand_plain(binned, items)
    for o, r in zip(out, ref):
        assert o.is_contiguous() and o.shape == r.shape
        assert torch.equal(o, r)


def test_expand_with_an_empty_grid_launches_nothing(cuda):
    binned, items = _expand_case(3, cuda, "full")
    empty = binned._replace(mask=binned.mask[:0])  # cap 0: no slot at all
    before = binning.LAUNCHES["expand"]
    out = binning.expand(empty, items)
    assert binning.LAUNCHES["expand"] == before
    assert [tuple(o.shape[-2:]) for o in out] == [(0, binned.mask.shape[1])] * 4


def test_kernels_are_bitwise_deterministic(cuda):
    spec, P, M, V, K, counts = _grid(3, cuda)
    args = (spec, H, 3, "cubic", P, M)
    assert torch.equal(pair.k_pass(*args, K, counts),
                       pair.k_pass(*args, K, counts))
    assert torch.equal(pair.t_pass(*args, V, counts),
                       pair.t_pass(*args, V, counts))
    a = pair.hoist_ff(spec, H, 3, "cubic", "cubic", P, M, counts)
    b = pair.hoist_ff(spec, H, 3, "cubic", "cubic", P, M, counts)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    bnd, kw = _boundary(spec, cuda, "sparse")
    fb = (spec, H, 3, "cubic", "cubic", P, counts, *bnd)
    a = pair.hoist_fb(*fb, **kw)
    b = pair.hoist_fb(*fb, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(pair.k_pass_v2(*args, K, counts),
                       pair.k_pass_v2(*args, K, counts))


# (kernel_density, kernel_gradient) pairs beside cubic/cubic: each
# non-cubic kernel in each role, with itself and with another kernel.
KERNEL_PAIRS = [("poly6", "spiky"), ("spiky", "viscosity"),
                ("viscosity", "poly6"), ("poly6", "poly6"),
                ("spiky", "spiky"), ("viscosity", "viscosity"),
                ("cubic", "spiky"), ("poly6", "cubic")]


def _assert_close_peak(got, want, tol, label):
    """Every element within ``atol * peak + rtol * |want|``, ``peak`` =
    max(1, max |want|) of this output (``chip_smoke.py``'s rule: an
    output is a sum of terms that cancel, and the viscosity kernel's
    dW/dr / r grows as 1 / r^3 between close pairs)."""
    peak = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * peak, msg=label)


@pytest.mark.parametrize("kd,kg", KERNEL_PAIRS)
@pytest.mark.parametrize("dim", [2, 3])
def test_non_cubic_kernels_match_plain(cuda, dim, kd, kg):
    """Every pass under non-cubic kernels: ``k_pass``, ``t_pass`` and
    ``k_pass_v2`` with ``kg`` as the gradient kernel, both hoists (with
    and without s2; ``hoist_fb`` on both boundary layouts) with ``kd`` /
    ``kg``, each a launch of its kernel, held to the plain version per
    output, pair counts exact, bitwise reruns."""
    spec, P, M, V, K, counts = _grid(dim, cuda)
    before = dict(pair.LAUNCHES)
    for name, X in (("k_pass", K), ("t_pass", V), ("k_pass_v2", K)):
        args = (spec, H, dim, kg, P, M, X, counts)
        out = getattr(pair, name)(*args)
        plain = pair.k_pass_plain if name == "k_pass_v2" else getattr(
            pair, name + "_plain")
        want = plain(*args)
        assert float(want.abs().max()) > 0
        _assert_close_peak(out, want, KT_TOL, f"{name} {kd}/{kg}")
        assert torch.equal(out, getattr(pair, name)(*args))
    for need_s2 in (False, True):
        args = (spec, H, dim, kd, kg, P, M, counts)
        out = pair.hoist_ff(*args, need_s2=need_s2)
        ref = pair.hoist_ff_plain(*args, need_s2=need_s2)
        for i, (o, r) in enumerate(zip(out[:4], ref[:4])):
            _assert_close_peak(o, r, HOIST_TOL, f"hoist_ff[{i}] {kd}/{kg}")
        assert torch.equal(out[4], ref[4])
        assert bool((out[0] != 0).any()) and int(out[4].sum()) > 0
        for layout in ("full", "sparse"):
            bnd, kw = _boundary(spec, cuda, layout)
            fb = (spec, H, dim, kd, kg, P, counts, *bnd)
            out = pair.hoist_fb(*fb, need_s2=need_s2, **kw)
            ref = pair.hoist_fb_plain(*fb, need_s2=need_s2, **kw)
            for i, (o, r) in enumerate(zip(out[:5], ref[:5])):
                _assert_close_peak(o, r, HOIST_TOL,
                                   f"hoist_fb[{i}] {layout} {kd}/{kg}")
            assert torch.equal(out[5], ref[5]) and int(out[5].sum()) > 0
            again = pair.hoist_fb(*fb, need_s2=need_s2, **kw)
            assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert {n: pair.LAUNCHES[n] - before[n] for n in before} == {
        "k_pass": 2, "t_pass": 2, "k_pass_v2": 2, "hoist_ff": 2,
        "hoist_fb": 8}


@pytest.mark.parametrize("kd,kg", KERNEL_PAIRS)
def test_non_cubic_tiled_kernels_on_tile_edges(cuda, kd, kg):
    """The tiled passes under non-cubic kernels on a grid cut to their
    tiles (the fullest cells on tile edges, cap 16)."""
    spec, P, M, Q, K, counts, full = _tiled_grid(3, 16, "ragged", cuda)
    for name, X in (("k_pass", K), ("t_pass", Q)):
        args = (spec, H, 3, kg, P, M, X, counts)
        _assert_close_peak(getattr(pair, name)(*args),
                           getattr(pair, name + "_plain")(*args), KT_TOL,
                           f"{name} {kg}")
    t = pair.tiling("hoist_ff", 3, 16, spec.num_cells, need_s2=True,
                    kernel_density=kd, kernel_gradient=kg)
    assert t == pair.tiling("hoist_ff", 3, 16, spec.num_cells, need_s2=True)
    args = (spec, H, 3, kd, kg, P, M, counts)
    out = pair.hoist_ff(*args, need_s2=True)
    ref = pair.hoist_ff_plain(*args, need_s2=True)
    for i, (o, r) in enumerate(zip(out[:4], ref[:4])):
        _assert_close_peak(o, r, HOIST_TOL, f"hoist_ff[{i}] {kd}/{kg}")
    assert torch.equal(out[4], ref[4])


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    spec, P, M, V, K, counts = _grid(3, cuda)
    before = dict(pair.LAUNCHES)
    with pytest.raises(KeyError):  # an unknown SPH kernel name
        pair.k_pass(spec, H, 3, "gaussian", P, M, K, counts)
    with pytest.raises(KeyError):
        pair.hoist_ff(spec, H, 3, "cubic", "gaussian", P, M, counts)
    assert pair.LAUNCHES == before
    with pytest.raises(ValueError):
        pair.t_pass(spec, H, 3, "cubic", P, M, V.transpose(1, 2)
                    .contiguous().transpose(1, 2), counts)
    with pytest.raises(ValueError):
        pair.k_pass(spec, H, 3, "cubic", P, M.cpu(), K, counts)
    # A cap whose staged neighbour rows fit no block's shared memory: the
    # launch is refused and the wrapper raises.
    big = tdg.DenseGridSpec(origin=(0.0,) * 3, dims=(3, 3, 3), cap=4096,
                            cell_width=H)
    Pb = torch.full((3, 4096, 27), tdg.POS_SENTINEL, device=cuda)
    Mb = torch.zeros((4096, 27), device=cuda)
    cb = torch.zeros(27, dtype=torch.int32, device=cuda)
    for name, X in (("k_pass", Mb), ("t_pass", Pb)):
        with pytest.raises(RuntimeError):
            getattr(pair, name)(big, H, 3, "cubic", Pb, Mb, X, cb)
    with pytest.raises(RuntimeError):
        pair.hoist_ff(big, H, 3, "cubic", "cubic", Pb, Mb, cb)


def test_hoist_fb_with_no_columns_is_zero_and_not_counted(cuda):
    spec, P, M, V, K, counts = _grid(3, cuda)
    bnd, kw = _boundary(spec, cuda, "sparse")
    kw["cols"] = kw["cols"][:0]
    before = pair.LAUNCHES["hoist_fb"]
    out = pair.hoist_fb(spec, H, 3, "cubic", "cubic", P, counts, *bnd, **kw)
    assert pair.LAUNCHES["hoist_fb"] == before  # nothing was launched
    assert all(int(torch.count_nonzero(o)) == 0 for o in out)


def _small_dam_world(device, layout, forces=()):
    """``tests/test_brute.py``'s ``_dam_world`` at n=5 (125 particles on
    a lattice 2 radii apart, falling at 2 m/s over a sampled floor), the
    fluid carrying ``forces``."""
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    r = 0.05
    w = LiquidWorld(particle_radius=r, dim=3, layout=layout, fit_grid=False,
                    domain=((-1.0, -0.4, -1.0), (1.0, 2.0, 1.0)),
                    device=device)
    ax = np.arange(5) * 2.0 * r
    pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    pos[:, 1] += 0.4
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    w.add_fluid(Fluid(pos, velocities=vel, nonpressure_forces=list(forces)))
    floor = shape_surface_sample(shapes.Cuboid((0.8, 0.1, 0.8)), r, 3)
    floor[:, 1] -= 0.1
    w.add_boundary(Boundary(floor))
    return w


def test_auto_resolves_small_cuda_worlds_to_brute(cuda):
    """A CUDA world under the brute ceilings resolves ``layout="auto"``
    to the brute tier and steps, launching no hand kernel (the tier runs
    the full-stencil plain folds, as the JAX package runs no Pallas
    kernel there); the CPU twin of the same world keeps the grid."""
    w = _small_dam_world(cuda, "auto")
    assert w._effective_sim().layout == "brute"
    assert _small_dam_world("cpu", "auto")._effective_sim().layout != "brute"
    pair.reset_launches()
    binning.reset_launches()
    for _ in range(3):
        w.step(1.0 / 200.0, (0.0, -9.81, 0.0))
    d = w.last_diagnostics
    assert int(d.neighbor_overflow) == 0 and int(d.ncontacts_ff) > 0
    assert bool(torch.isfinite(w.fluids_state.positions).all())
    assert not any(pair.LAUNCHES.values())
    assert binning.LAUNCHES["expand"] == 0


def test_full_stencil_grid_runs_the_kernels(cuda):
    """A grid world with ``dense_half_stencil=False`` on CUDA tensors runs
    the hand kernels (they walk the full stencil)."""
    w = _small_dam_world(cuda, "dense")
    w.sim = w.sim.replace(dense_half_stencil=False)
    pair.reset_launches()
    for _ in range(2):
        w.step(1.0 / 200.0, (0.0, -9.81, 0.0))
    for name in ("k_pass", "t_pass", "hoist_ff", "hoist_fb"):
        assert pair.LAUNCHES[name] > 0, name


def test_gather_step_repeats_bitwise_and_matches_the_cpu(cuda):
    """The gather layout on the card (plain PyTorch, no float atomics: the
    boundary-force scatter sums in table order): 24 steps of a small dam
    world with XSPH (its boundary feedback scatters once the block
    reaches the floor, after ~17 steps) are bitwise repeatable, and equal
    the same steps of a CPU copy of the world within 2e-6 m (positions)
    with identical iterations."""
    from salva_tpu_torch import forces

    runs = []
    for device in (cuda, cuda, "cpu"):
        w = _small_dam_world(device, "gather",
                             [forces.XSPHViscosity(0.5, 1.0)])
        iters = []
        for _ in range(24):
            w.step(1.0 / 200.0, (0.0, -9.81, 0.0))
            s = w.last_diagnostics.solver
            iters.append((s.pressure_iters, s.divergence_iters))
        runs.append((iters, w.fluids_state.positions.cpu(),
                     w.boundaries_state.forces.cpu()))
    (it0, p0, f0), (it1, p1, f1), (it_c, p_c, _) = runs
    assert it0 == it1 == it_c
    assert torch.equal(p0, p1) and torch.equal(f0, f1)
    assert float(f0.abs().max()) > 0.0
    torch.testing.assert_close(p0, p_c, rtol=0, atol=2e-6)


def _contact_table(dim, device, B=4, K=64, count=37, seed=5):
    """A random contact table over B bodies (body 0 fixed), with the
    rotations, inverse masses and inertias of the solve's inputs."""
    rng = np.random.default_rng(seed + dim)
    trans = rng.uniform(-1.0, 1.0, (B, dim)).astype(np.float32)
    if dim == 2:
        ang = rng.uniform(-np.pi, np.pi, B)
        rot = np.stack([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]]).transpose(2, 0, 1)
        angvel = rng.normal(size=B)
        inv_inertia = rng.uniform(0.5, 2.0, (B, 1))
    else:
        q = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0]
        rot = q * np.sign(np.linalg.det(q))[:, None, None]
        angvel = rng.normal(size=(B, 3))
        inv_inertia = rng.uniform(0.5, 2.0, (B, 3))
    inv_mass = rng.uniform(0.5, 2.0, B)
    inv_mass[0], inv_inertia[0] = 0.0, 0.0
    a = rng.integers(1, B, K)
    b = np.where(rng.random(K) < 0.4, -1, rng.integers(0, B, K))
    b = np.where(b == a, -1, b)
    n = rng.normal(size=(K, dim))
    n /= np.linalg.norm(n, axis=1, keepdims=True)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return (t(trans), t(rot), t(rng.normal(size=(B, dim))), t(angvel),
            t(inv_mass), t(inv_inertia), t(a, torch.int32),
            t(b, torch.int32), t(rng.uniform(-1.0, 1.0, (K, dim))), t(n),
            t(count, torch.int32))


@pytest.mark.parametrize("friction", [0.0, 0.5])
@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_solve_kernel_matches_plain(cuda, dim, friction):
    """The one-thread sequential-impulse kernel against its plain version
    (same arithmetic, float32; FMA contraction on the card): velocities
    within 1e-5, the launch counted once, a rerun bitwise."""
    from salva_tpu_torch.ops import rigid

    args = _contact_table(dim, cuda)
    rigid.reset_launches()
    lin, ang = rigid.solve_contacts(*args, 0.0, friction, 8)
    assert rigid.LAUNCHES["rigid_solve"] == 1
    plin, pang = rigid.solve_contacts_plain(*args, 0.0, friction, 8)
    torch.testing.assert_close(lin, plin, rtol=0, atol=1e-5)
    torch.testing.assert_close(ang, pang, rtol=0, atol=1e-5)
    assert not torch.equal(lin, args[2])  # the contacts acted
    lin2, ang2 = rigid.solve_contacts(*args, 0.0, friction, 8)
    assert torch.equal(lin2, lin) and torch.equal(ang2, ang)
    # count = 0 (read on the card): the velocities come back unchanged.
    zero = args[:-1] + (torch.zeros((), dtype=torch.int32, device=cuda),)
    lin0, ang0 = rigid.solve_contacts(*zero, 0.0, friction, 8)
    assert torch.equal(lin0, args[2]) and torch.equal(ang0, args[3])


def test_expand_serves_two_binnings_in_one_launch(cuda):
    """``expand_many``: the full-grid and the compact binning of
    :func:`_expand_case`, each with its own channels, in one launch,
    bitwise each binning's plain expansion."""
    full, items_f = _expand_case(3, cuda, "full")
    active, items_a = _expand_case(3, cuda, "active")
    before = binning.LAUNCHES["expand"]
    got_f, got_a = binning.expand_many([(full, items_f),
                                        (active, items_a[:2])])
    assert binning.LAUNCHES["expand"] == before + 1
    for got, ref in ((got_f, binning.expand_plain(full, items_f)),
                     (got_a, binning.expand_plain(active, items_a[:2]))):
        assert len(got) == len(ref)
        for o, r in zip(got, ref):
            assert o.is_contiguous() and torch.equal(o, r)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_kernels_on_slab_grids(cuda, n_slabs):
    """The pair kernels and the fused ``expand`` on each slab's local grid
    (``parallel.LocalHalos``): a 6^3 block lowered onto a floor, binned
    into ``n_slabs`` slabs with their ghost layers. The kernels treat the
    cells beyond the local grid as empty and the plain versions roll
    cyclically, so only the interior columns (what every reader of a pass
    output uses) are compared; pair counts exact, ``expand`` bitwise."""
    from salva_tpu_torch import shapes
    from salva_tpu_torch.config import DFSPHConfig
    from salva_tpu_torch.parallel import LocalHalos, pad_spec_for_devices
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    world = LiquidWorld(solver=DFSPHConfig(), particle_radius=0.05, dim=3,
                        domain=((-0.45, -0.2, -0.45), (0.45, 0.8, 0.45)),
                        layout="dense", device=cuda)
    pos = cube_fluid((6, 6, 6), 0.05)
    pos[:, 1] += 0.40
    world.add_fluid(Fluid(pos, density0=1000.0))
    world.add_boundary(Boundary(shape_surface_sample(
        shapes.Cuboid((0.4, 0.1, 0.4)), 0.05, 3)))
    world._prepare()
    sim = world._boundary_volume_mode(world._effective_sim(), None)
    spec_f, spec_b, _ = _dense_config(sim, world.solver_config, ForceSet())
    spec_f = pad_spec_for_devices(spec_f, n_slabs)
    spec_b = spec_b.replace(dims=spec_f.dims, clamp_nx=spec_f.clamp_nx)
    nxl = spec_f.dims[0] // n_slabs
    fl, bd = world.fluids_state, world.boundaries_state
    ctxs = LocalHalos(n_slabs).run(
        nxl, int(np.prod(spec_f.dims[1:])),
        lambda halo: DenseCtx(sim, spec_f, spec_b, fl, bd.clear_forces(),
                              halo=halo, need_s2=True))
    fb_pairs = 0
    for ctx in ctxs:
        own = ctx.interior[0]
        spec, h, P, M, counts = ctx.spec_f, ctx.h, ctx.P, ctx.M, ctx.counts
        K = (ctx.rho * 1e-6 * ctx.maskf).contiguous()
        Q = ctx.V.contiguous()
        pairs = [
            (pair.k_pass(spec, h, 3, "cubic", P, M, K, counts),
             pair.k_pass_plain(spec, h, 3, "cubic", P, M, K, counts),
             KT_TOL),
            (pair.t_pass(spec, h, 3, "cubic", P, M, Q, counts),
             pair.t_pass_plain(spec, h, 3, "cubic", P, M, Q, counts),
             KT_TOL),
        ]
        ff = pair.hoist_ff(spec, h, 3, "cubic", "cubic", P, M, counts)
        ff_ref = pair.hoist_ff_plain(spec, h, 3, "cubic", "cubic", P, M,
                                     counts)
        fb_args = (spec, h, 3, "cubic", "cubic", P, counts, ctx.Pb,
                   ctx.Volb, ctx.Vbvel, ctx.counts_b)
        fb = pair.hoist_fb(*fb_args)
        fb_ref = pair.hoist_fb_plain(*fb_args)
        fb_pairs += int(fb[-1][..., own].sum())
        for out, ref in ((ff, ff_ref), (fb, fb_ref)):
            assert torch.equal(out[-1][..., own], ref[-1][..., own])
            pairs += [(o, r, HOIST_TOL) for o, r in zip(out[:-1], ref[:-1])]
        for i, (out, ref, tol) in enumerate(pairs):
            _assert_close_peak(out[..., own], ref[..., own], tol,
                               f"slab output {i}")
        f_items = [(fl.positions, tdg.POS_SENTINEL), (fl.velocities, 0.0)]
        b_items = [(bd.positions, tdg.POS_SENTINEL), (bd.velocities, 0.0)]
        before = binning.LAUNCHES["expand"]
        got_f, got_b = tdg.to_grid_multi2(ctx.sf, ctx.binf, f_items, ctx.sb,
                                          ctx.binb, b_items)
        assert binning.LAUNCHES["expand"] == before + 1
        for got, ref in ((got_f, binning.expand_plain(ctx.binf, f_items)),
                         (got_b, binning.expand_plain(ctx.binb, b_items))):
            assert all(torch.equal(o, r) for o, r in zip(got, ref))
    assert fb_pairs > 0, "no fluid-boundary pair"
