"""The four pair passes of the PyTorch port against the JAX package.

The plain PyTorch versions (``k_pass_plain``, ``t_pass_plain``,
``hoist_ff_plain``, ``hoist_fb_plain``; ``k_pass_plain`` also stands for
``k_pass_v2``, the slot-group formulation) are held, on the same grid
state, against

- the JAX ``DenseCtx`` half-stencil folds (``_k_pass_half``,
  ``_t_pass_half``, ``_hoist_ff_half``), and
- the Pallas v3 kernels in interpret mode (``k_pass_pallas3``,
  ``t_pass_pallas3``, ``hoist_ff_pallas3``: the v1 lo slice plus the hi
  complement; ``hoist_fb_pallas3`` on the full-grid boundary arrays; the
  v2 slot-group kernel ``k_pass_pallas2`` for ``k_pass_v2``), as
  ``tests/test_pallas_ops.py`` runs them on the CPU,

in 2D and 3D, on a clustered fixture that puts more
than 8 particles in some cells (so the hi complement carries real
blocks), with a moving boundary layer through part of the fluid.
Tolerances follow ``tests/test_pallas_ops.py``: rtol 1e-4 / atol 1e-5 for
k and t, 1e-3 for the hoists' float outputs, exact pair counts. The
fb hoist's three forms (full-grid boundary binning, the compact boundary
table over every column, the compact table over the sparse hoist's
adjacency columns) are held against each other.

The full-stencil plain folds (``solver/full_folds.py``: ``t_pass``,
``k_pass``, ``hoist_ff``, ``hoist_fb``), which the port runs on the brute
tier and, for CPU tensors, on a grid with ``dense_half_stencil=False``,
are held on the same seeded state to the JAX ``DenseCtx`` full folds on a
3D grid with the half stencil off and on a brute spec: rtol 1e-4 / atol
1e-5 per output (``tests/test_pallas_ops.py``), exact pair counts. The
port's ``DenseCtx`` routes both configurations through them and never
through ``ops.pair``.

The CUDA kernels themselves are held against the plain versions on the
card (``tests/test_torch_kernels.py``, ``gpu``-marked; ``chip_smoke.py``
does the same at the 97k dam-break shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.config import SimConfig
from salva_tpu.geometry import dense_grid as jdg
from salva_tpu.object.state import BoundariesState, FluidsState
from salva_tpu.ops.pallas_pair2 import (
    hoist_fb_pallas3,
    hoist_ff_pallas3,
    k_pass_pallas2,
    k_pass_pallas3,
    t_pass_pallas3,
)
from salva_tpu.solver.dense_common import DenseCtx
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.object.state import state_from_numpy
from salva_tpu_torch.ops import pair
from salva_tpu_torch.solver import full_folds

# One intra-op thread: the parity tests run many tiny torch ops, and the
# suite runs several test processes at once, where torch's spinning
# thread pools oversubscribe the cores (one IISPH parity fixture took
# over 800 s with the default pool under load, 89 s with one thread).
torch.set_num_threads(1)

H = 0.2
KT_TOL = dict(rtol=1e-4, atol=1e-5)
HOIST_TOL = dict(rtol=1e-3, atol=1e-3)
# One 128-lane chunk per Pallas program: the interpret-mode hi complement
# unrolls its chunk loop, so this is the cheapest program to compile.
TILE = 128


def _particles(dim):
    """(pos, alive, vel, bpos, bvel): a uniform background + tight
    clusters in distinct cells (several cells hold 9..16 particles at
    cap 16, no overflow), and a moving boundary layer."""
    rng = np.random.default_rng(7 + dim)
    lo, hi = 0.0, 0.8
    n_bg = 100 if dim == 3 else 40
    bg = rng.uniform(lo, hi, size=(n_bg, dim))
    # Cluster centres sit mid-cell, one cluster per cell.
    grid = np.stack(np.meshgrid(*([np.arange(4)] * dim), indexing="ij"),
                    axis=-1).reshape(-1, dim)
    cells = grid[rng.choice(len(grid), size=5, replace=False)]
    centers = (cells + 0.5) * H
    clusters = (centers[:, None, :]
                + rng.uniform(-0.05, 0.05, size=(5, 10, dim))).reshape(-1, dim)
    pos = np.concatenate([bg, clusters]).astype(np.float32)
    n = len(pos)
    alive = np.arange(n) % 9 != 4
    vel = rng.normal(size=(n, dim)).astype(np.float32)
    # Boundary: a jittered layer at y ~ 0.3 (a plane in 3D, a line in
    # 2D), 0.1 apart, moving, so every fb channel is nonzero.
    ticks = np.arange(0.05, hi, 0.1)
    grid_b = np.stack(np.meshgrid(*([ticks] * (dim - 1)), indexing="ij"),
                      axis=-1).reshape(-1, dim - 1)
    bpos = np.insert(grid_b, 1, 0.3, axis=1)
    bpos = (bpos + rng.uniform(-0.01, 0.01, size=bpos.shape)).astype(
        np.float32)
    bvel = rng.normal(size=(len(bpos), dim)).astype(np.float32)
    return pos, alive, vel, bpos, bvel


def _state(dim, kernels=("cubic", "cubic")):
    """The fixture of :func:`_particles` binned through the JAX DenseCtx
    and its half-stencil folds, under the SPH kernels ``kernels``
    (density, gradient)."""
    pos, alive, vel, bpos, bvel = _particles(dim)
    n, nb = len(pos), len(bpos)
    lo, hi = 0.0, 0.8
    sim = SimConfig(dim=dim, particle_radius=0.05, use_pallas=False,
                    dense_compact=False, dense_spill_auto=False,
                    dense_sparse_boundary=False,
                    domain=((lo,) * dim, (hi,) * dim),
                    kernel_density=kernels[0], kernel_gradient=kernels[1])
    spec = jdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=16)

    @jax.jit
    def reference(pos, vel, alive, bpos, bvel):
        """Bin through the JAX DenseCtx (full-grid boundary binning) and
        run its half-stencil folds (one compiled program: far cheaper
        than eager op dispatch)."""
        fl = FluidsState.empty(n, dim).replace(
            positions=pos,
            velocities=vel,
            volumes=jnp.full((n,), 1e-3, jnp.float32),
            density0=jnp.full((n,), 1000.0, jnp.float32),
            alive=alive,
        )
        bd = BoundariesState.empty(nb, dim).replace(
            positions=bpos, velocities=bvel,
            alive=jnp.ones((nb,), bool),
        )
        ctx = DenseCtx(sim, spec, spec.replace(cap=8), fl, bd)
        K = ctx.rho * 1e-6
        return dict(
            P=ctx.P, M=ctx.M, V=ctx.V, K=K, mask=ctx.maskf,
            Pb=ctx.Pb, Volb=ctx.Volb, Vbvel=ctx.Vbvel, maskb=ctx.maskb,
            overflow=ctx.binf.overflow + ctx.binb.overflow,
            k=ctx._k_pass_half(K),
            t=ctx._t_pass_half(ctx.V), hoist=ctx._hoist_ff_half(),
        )

    ref = reference(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive),
                    jnp.asarray(bpos), jnp.asarray(bvel))
    counts = np.asarray(ref["mask"]).sum(axis=0).astype(np.int32)
    assert counts.max() > 8, counts.max()  # hi slot groups are live
    assert int(ref["overflow"]) == 0
    tspec = tdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                              spec.cell_width)
    t = {k: torch.from_numpy(np.array(ref[k]))
         for k in ("P", "M", "V", "K", "Pb", "Volb", "Vbvel")}
    t["counts"] = torch.from_numpy(counts)
    t["counts_b"] = torch.from_numpy(
        np.asarray(ref["maskb"]).sum(axis=0).astype(np.int32))
    t["bpos"], t["balive"] = torch.from_numpy(bpos), torch.ones(nb, dtype=bool)
    t["bvel"] = torch.from_numpy(bvel)
    return spec, ref, tspec, t


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def state(request):
    return (request.param,) + _state(request.param)


def _close(actual, desired, tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(desired), **tol)


def test_k_pass_plain_matches(state):
    dim, spec, ref, tspec, t = state
    out = pair.k_pass_plain(tspec, H, dim, "cubic", t["P"], t["M"], t["K"],
                            t["counts"])
    _close(out.numpy(), ref["k"], KT_TOL)
    _close(out.numpy(), k_pass_pallas3(
        spec, H, dim, "cubic", ref["P"], ref["M"], ref["K"], tile=TILE,
        interpret=True), KT_TOL)


def test_k_pass_v2_matches_pallas2(state):
    """``k_pass_v2`` on CPU tensors (its plain version, ``k_pass_plain``)
    against the interpret-mode v2 kernel, whose slot-group gating skips
    the dead groups of cells under 9 particles and runs the live hi
    groups of the clustered cells."""
    dim, spec, ref, tspec, t = state
    out = pair.k_pass_v2(tspec, H, dim, "cubic", t["P"], t["M"], t["K"],
                         t["counts"])
    torch.testing.assert_close(
        out, pair.k_pass_plain(tspec, H, dim, "cubic", t["P"], t["M"],
                               t["K"], t["counts"]), rtol=0, atol=0)
    _close(out.numpy(), k_pass_pallas2(
        spec, H, dim, "cubic", ref["P"], ref["M"], ref["K"], tile=TILE,
        interpret=True), KT_TOL)


def test_t_pass_plain_matches(state):
    dim, spec, ref, tspec, t = state
    out = pair.t_pass_plain(tspec, H, dim, "cubic", t["P"], t["M"], t["V"],
                            t["counts"])
    _close(out.numpy(), ref["t"], KT_TOL)
    _close(out.numpy(), t_pass_pallas3(
        spec, H, dim, "cubic", ref["P"], ref["M"], ref["V"], tile=TILE,
        interpret=True), KT_TOL)


def test_hoist_ff_plain_matches(state):
    dim, spec, ref, tspec, t = state
    out = pair.hoist_ff_plain(tspec, H, dim, "cubic", "cubic", t["P"],
                              t["M"], t["counts"], need_s2=True)
    refs = (
        ref["hoist"],
        hoist_ff_pallas3(spec, H, dim, "cubic", "cubic", ref["P"],
                         ref["M"], need_s2=True, tile=TILE, interpret=True),
    )
    for ref in refs:
        for o, r in zip(out[:4], ref[:4]):
            _close(o.numpy(), r, HOIST_TOL)
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    assert int(out[4].sum()) > 0


def test_cpu_wrappers_run_the_plain_versions(state):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    dim, spec, ref, tspec, t = state
    before = dict(pair.LAUNCHES)
    P, M, counts = t["P"], t["M"], t["counts"]
    torch.testing.assert_close(
        pair.k_pass(tspec, H, dim, "cubic", P, M, t["K"], counts),
        pair.k_pass_plain(tspec, H, dim, "cubic", P, M, t["K"], counts),
        rtol=0, atol=0,
    )
    torch.testing.assert_close(
        pair.t_pass(tspec, H, dim, "cubic", P, M, t["V"], counts),
        pair.t_pass_plain(tspec, H, dim, "cubic", P, M, t["V"], counts),
        rtol=0, atol=0,
    )
    for a, b in zip(
        pair.hoist_ff(tspec, H, dim, "cubic", "cubic", P, M, counts,
                      need_s2=False),
        pair.hoist_ff_plain(tspec, H, dim, "cubic", "cubic", P, M, counts,
                            need_s2=False),
    ):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(
        pair.hoist_fb(*_fb_args(tspec, dim, t), need_s2=False),
        pair.hoist_fb_plain(*_fb_args(tspec, dim, t), need_s2=False),
    ):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pair.LAUNCHES == before


def _fb_args(tspec, dim, t, kernels=("cubic", "cubic")):
    return (tspec, H, dim, *kernels, t["P"], t["counts"], t["Pb"],
            t["Volb"], t["Vbvel"], t["counts_b"])


def test_hoist_fb_plain_matches(state):
    """Full-grid boundary binning (identity cell map, every column)
    against the interpret-mode Pallas kernel, with need_s2."""
    dim, spec, ref, tspec, t = state
    out = pair.hoist_fb_plain(*_fb_args(tspec, dim, t), need_s2=True)
    want = hoist_fb_pallas3(
        spec, t["Pb"].shape[1], H, dim, "cubic", "cubic", ref["P"], ref["M"],
        ref["Pb"], ref["Volb"], ref["Vbvel"], need_s2=True, tile=TILE,
        interpret=True,
    )
    for o, r in zip(out[:5], want[:5]):
        assert float(np.abs(np.asarray(r)).max()) > 0  # channel exercised
        _close(o.numpy(), r, HOIST_TOL)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(want[5]))
    assert int(out[5].sum()) > 0


def test_hoist_fb_plain_forms_agree(state):
    """The three forms of the fb hoist on one state: the boundaries
    binned into the full grid (identity), the compact occupied-cell table
    over every fluid column, and the compact table over the sparse
    hoist's adjacency columns (with unused table entries). The per-pair
    sums are the same, so the results are equal bitwise."""
    dim, spec, ref, tspec, t = state
    full = pair.hoist_fb_plain(*_fb_args(tspec, dim, t), need_s2=True)
    bspec = tspec.replace(cap=8)
    binb = tdg.bin_particles_active(bspec, 64, t["bpos"], t["balive"])
    sb = tdg.ActiveSpec(65, bspec.cap)
    Pb, Vb = tdg.to_grid_multi(sb, binb, [(t["bpos"], tdg.POS_SENTINEL),
                                          (t["bvel"], 0.0)])
    # Volumes of the full-grid binning, moved to the compact slots.
    vol = tdg.from_grid(tspec, tdg.bin_particles(bspec, t["bpos"],
                                                 t["balive"]), t["Volb"])
    Volb = tdg.to_grid(sb, binb, vol)
    counts_b = (binb.mask > 0).sum(dim=0, dtype=torch.int32)
    C = tspec.num_cells
    adj = torch.zeros(C, dtype=torch.bool)
    occ = torch.zeros(C + 1, dtype=torch.bool)
    occ[binb.active_cells.long()] = True
    for s_ in tdg.flat_shifts(tspec):
        adj |= torch.roll(occ[:C], s_)
    table = torch.cat([torch.nonzero(adj)[:, 0],
                       torch.full((5,), C)]).to(torch.int32)
    compact = (tspec, H, dim, "cubic", "cubic", t["P"], t["counts"], Pb,
               Volb, Vb, counts_b)
    every = pair.hoist_fb_plain(*compact, cell_to_col=binb.cell_to_active,
                                need_s2=True)
    sparse = pair.hoist_fb_plain(*compact, cell_to_col=binb.cell_to_active,
                                 cols=table, need_s2=True)
    for a, b, c in zip(full, every, sparse):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(full[5].sum()) > 0


# -- the full-stencil plain folds ---------------------------------------------

# The hoisted fields of ``DenseCtx`` the full folds feed (the ff and fb
# hoist outputs combined as ``DenseCtx._hoist`` combines them).
HOISTED = ("rho", "Gf", "Gb", "Sb", "sq_mm", "s2_ff", "s2_m")
BRUTE_CELLS = 16


def _full_state(kind):
    """The 3D clustered fixture of :func:`_state`, bound as a grid with
    the half stencil off (full-grid boundary binning) or as the brute
    tier, and the JAX ``DenseCtx`` full folds on it."""
    dim = 3
    pos, alive, vel, bpos, bvel = _particles(dim)
    n, nb = len(pos), len(bpos)
    fl = FluidsState.empty(n, dim).replace(
        positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
        volumes=jnp.full((n,), 1e-3, jnp.float32),
        density0=jnp.full((n,), 1000.0, jnp.float32),
        alive=jnp.asarray(alive),
    )
    bd = BoundariesState.empty(nb, dim).replace(
        positions=jnp.asarray(bpos), velocities=jnp.asarray(bvel),
        alive=jnp.ones((nb,), bool),
    )
    sim = SimConfig(dim=dim, particle_radius=0.05, use_pallas=False,
                    dense_compact=False, dense_spill_auto=False,
                    dense_sparse_boundary=False, dense_half_stencil=False,
                    domain=((0.0,) * dim, (0.8,) * dim))
    if kind == "brute":
        spec_f = jdg.brute_spec(n, BRUTE_CELLS)
        spec_b = jdg.brute_spec(nb, BRUTE_CELLS)
        tspec = tdg.brute_spec(n, BRUTE_CELLS)
        tspec_b = tdg.brute_spec(nb, BRUTE_CELLS)
    else:
        spec_f = jdg.spec_for_aabb((0.0,) * dim, (0.8,) * dim, H, cap=16)
        spec_b = spec_f.replace(cap=8)
        tspec = tdg.DenseGridSpec(spec_f.origin, spec_f.dims, spec_f.cap,
                                  spec_f.cell_width)
        tspec_b = tspec.replace(cap=8)

    @jax.jit
    def reference(fl, bd):
        ctx = DenseCtx(sim, spec_f, spec_b, fl, bd)
        K = ctx.rho * 1e-6
        out = dict(P=ctx.P, M=ctx.M, V=ctx.V, K=K, R0=ctx.R0,
                   mask=ctx.maskf, Pb=ctx.Pb, Volb=ctx.Volb,
                   Vbvel=ctx.Vbvel, maskb=ctx.maskb,
                   overflow=ctx.binf.overflow + ctx.binb.overflow,
                   k=ctx.k_pass(K), t=ctx.t_pass(ctx.V),
                   cnt_ff=ctx.cnt_ff, cnt_fb=ctx.cnt_fb)
        out.update({f: getattr(ctx, f) for f in HOISTED})
        return out

    ref = {k: np.asarray(v) for k, v in reference(fl, bd).items()}
    assert int(ref["overflow"]) == 0
    t = {k: torch.from_numpy(ref[k].copy()) for k in
         ("P", "M", "V", "K", "R0", "mask", "Pb", "Volb", "Vbvel", "maskb")}
    states = tuple(
        state_from_numpy({f: np.asarray(getattr(s, f))
                          for f in s.__dataclass_fields__}, device="cpu")
        for s in (fl, bd))
    return (tspec, tspec_b), ref, t, states


@pytest.fixture(scope="module", params=["grid_3d_full", "brute"])
def full_state(request):
    return (request.param,) + _full_state(request.param)


def _port_hoisted(tspec, t, need_s2=True):
    """The port's full ff and fb hoists on the reference grids, combined
    as ``DenseCtx._hoist`` combines them."""
    rho_ff, Gf, sq_ff, s2_ff, cnt_ff = full_folds.hoist_ff(
        tspec, H, 3, "cubic", "cubic", t["P"], t["M"], t["mask"],
        need_s2=need_s2)
    rho_fb, Gb, sq_fb, s2_fb, Sb, cnt_fb = full_folds.hoist_fb(
        tspec, H, 3, "cubic", "cubic", t["P"], t["mask"], t["Pb"],
        t["maskb"], t["Volb"], t["Vbvel"], need_s2=need_s2)
    R0, live = t["R0"], t["mask"] > 0
    return dict(rho=torch.where(live, rho_ff + R0 * rho_fb, R0), Gf=Gf,
                Gb=R0[None] * Gb, Sb=R0 * Sb,
                sq_mm=sq_ff + R0 * R0 * sq_fb, s2_ff=s2_ff,
                s2_m=s2_ff + R0 * s2_fb, cnt_ff=cnt_ff, cnt_fb=cnt_fb)


def test_full_k_and_t_pass_match(full_state):
    kind, (tspec, _), ref, t, _ = full_state
    k = full_folds.k_pass(tspec, H, 3, "cubic", t["P"], t["M"], t["K"])
    tt = full_folds.t_pass(tspec, H, 3, "cubic", t["P"], t["M"], t["V"])
    assert float(np.abs(ref["k"]).max()) > 0
    assert float(np.abs(ref["t"]).max()) > 0
    _close(k.numpy(), ref["k"], KT_TOL)
    _close(tt.numpy(), ref["t"], KT_TOL)


def test_full_hoists_match(full_state):
    kind, (tspec, _), ref, t, _ = full_state
    got = _port_hoisted(tspec, t)
    for f in HOISTED:
        assert float(np.abs(ref[f]).max()) > 0, f  # channel exercised
        _close(got[f].numpy(), ref[f], KT_TOL)
    for f in ("cnt_ff", "cnt_fb"):
        np.testing.assert_array_equal(got[f].numpy(), ref[f], err_msg=f)
        assert int(got[f].sum()) > 0, f
    # Without s2 (the DFSPH setting) the s2 channels are exactly zero.
    no_s2 = _port_hoisted(tspec, t, need_s2=False)
    assert int(torch.count_nonzero(no_s2["s2_ff"])) == 0
    torch.testing.assert_close(no_s2["Gf"], got["Gf"], rtol=0, atol=0)


def test_dense_ctx_runs_the_full_folds(full_state, monkeypatch):
    """The port's ``DenseCtx`` on the same particle state: on the brute
    tier and on the grid without the half stencil (CPU tensors) the
    fluid-fluid passes are the full folds, bitwise. The brute tier never
    calls ``ops.pair``; the grid's fb hoist stays ``ops.pair.hoist_fb``
    (the reference's fb hoist is a full fold with the half stencil or
    without; its plain version is that fold, bitwise)."""
    from salva_tpu_torch.config import SimConfig as TSimConfig
    from salva_tpu_torch.solver.dense_common import DenseCtx as TDenseCtx

    kind, (tspec, tspec_b), ref, t, (fl, bd) = full_state

    def refuse(*args, **kw):
        raise AssertionError("ops.pair reached")

    for name in ("k_pass", "t_pass", "hoist_ff", "k_pass_v2") + (
            ("hoist_fb",) if kind == "brute" else ()):
        monkeypatch.setattr(pair, name, refuse)
    tsim = TSimConfig(dim=3, particle_radius=0.05, dense_compact=False,
                      dense_sparse_boundary=False, dense_half_stencil=False,
                      domain=((0.0,) * 3, (0.8,) * 3))
    ctx = TDenseCtx(tsim, tspec, tspec_b, fl, bd, need_s2=True)
    assert ctx.use_full_folds and ctx.brute == (kind == "brute")
    # The port binds the state as the JAX package does (volumes: its
    # own boundary fold, to the last bits).
    for k, got in (("P", ctx.P), ("M", ctx.M), ("mask", ctx.maskf),
                   ("Pb", ctx.Pb), ("maskb", ctx.maskb)):
        assert torch.equal(got, t[k]), k
    torch.testing.assert_close(ctx.Volb, t["Volb"], rtol=1e-6, atol=0)
    t = dict(t, Volb=ctx.Volb)
    want = _port_hoisted(tspec, t)
    for f, w in want.items():
        assert torch.equal(getattr(ctx, f), w), f
    K = t["K"]
    assert torch.equal(ctx.k_pass(K), full_folds.k_pass(
        tspec, H, 3, "cubic", t["P"], t["M"], K))
    assert torch.equal(ctx.t_pass(ctx.V), full_folds.t_pass(
        tspec, H, 3, "cubic", t["P"], t["M"], ctx.V))
