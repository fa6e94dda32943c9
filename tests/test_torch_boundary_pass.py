"""The boundary-owner pass of the dense solvers on the CPU:
``ops.pair.boundary_forces`` (the pressure solves' forces on the
boundary, F_b = Volb_b sum_i grad_ij coef_i) on CPU tensors against
``DenseCtx``'s plain fold, bitwise, and against a float64 sum over every
(boundary, fluid) pair; and which bindings ``DenseCtx._bind_passes``
gives it.

Fixture: a jittered block of fluid resting over a floor sampled four to
a cell along each axis, so that floor cells hold exactly ``cap_b``
particles, bound as a ``DenseCtx`` on the sparse boundary binning (an
occupied-cell table with void entries) and on the full-grid one, in 2D
and 3D. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``).
"""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.config import DFSPHConfig
from salva_tpu_torch.kernels import sph
from salva_tpu_torch.ops import pair
from salva_tpu_torch.solver.dense_common import DenseCtx
from salva_tpu_torch.step import _dense_config

R = 0.05
KERNELS = ("cubic", "poly6", "spiky", "viscosity")
# The fold's float32 sums against the float64 pair sum: each output within
# ``ATOL * peak + RTOL * |want|`` (peak: max |want| of the output).
RTOL, ATOL = 1e-4, 1e-5


def _world(dim):
    rng = np.random.default_rng(3 + dim)
    n = 6 if dim == 3 else 10
    axes = np.meshgrid(*[np.arange(n, dtype=np.float32) * 2 * R] * dim,
                       indexing="ij")
    pos = np.stack(axes, -1).reshape(-1, dim)
    pos += np.float32([-0.25, 0.02, -0.25] if dim == 3 else [-0.45, 0.02])
    pos += rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32) * R
    xs = np.arange(-0.5, 0.5, R, dtype=np.float32)
    if dim == 3:
        gx, gz = np.meshgrid(xs, xs, indexing="ij")
        floor = np.stack([gx.ravel(), np.full(gx.size, -2 * R, np.float32),
                          gz.ravel()], -1)
    else:
        floor = np.stack([xs, np.full(xs.size, -2 * R, np.float32)], -1)
    lo, hi = (-0.6, -0.3, -0.6)[:dim], (0.6, 0.9, 0.6)[:dim]
    w = st.LiquidWorld(solver=DFSPHConfig(), particle_radius=R, dim=dim,
                       domain=(lo, hi), layout="dense", dense_cap=16,
                       dense_cap_boundary=16 if dim == 3 else 4,
                       fit_grid=False, device="cpu")
    w.add_fluid(st.Fluid(pos, density0=1000.0))
    w.add_boundary(st.Boundary(floor))
    w._prepare()
    return w


def _bind(w, **over):
    sim = w._boundary_volume_mode(w._effective_sim(), None).replace(
        recompute_boundary_volumes=True, **over)
    spec_f, spec_b, _ = _dense_config(sim, w.solver_config, w._force_set)
    return DenseCtx(sim, spec_f, spec_b, w.fluids_state,
                    w.boundaries_state.clear_forces(), need_s2=True)


def _coef(ctx, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(ctx.maskf.shape, generator=g) * ctx.maskf


@pytest.fixture(scope="module")
def ctxs():
    """{(dim, binning): bound context}."""
    out = {}
    for dim in (2, 3):
        w = _world(dim)
        for binning, sparse in (("sparse", True), ("full", False)):
            out[dim, binning] = _bind(w, dense_sparse_boundary=sparse)
    return out


def _pair_sum(ctx, coef, kernel_gradient):
    """F_b = Volb_b sum_i -(p_b - p_i) dW/dr / r coef_i over every live
    (boundary, fluid) slot pair within h, in float64, on the boundary grid
    (zero on dead slots)."""
    _, dw = sph.get_kernel(kernel_gradient)
    dim, h = ctx.dim, ctx.h
    live_f = ctx.maskf > 0
    pf = ctx.P[:, live_f].double()  # [dim, n_f]
    cf = coef[live_f].double()
    live_b = ctx.maskb > 0
    pb = ctx.Pb[:, live_b].double()  # [dim, n_b]
    d = pb[:, :, None] - pf[:, None, :]
    r = torch.sqrt((d * d).sum(0))
    ok = (r <= h) & (r > sph.EPSILON)
    dwr = torch.where(ok, dw(torch.where(ok, r, h), h, dim)
                      / torch.where(ok, r, 1.0), 0.0)
    f = -(d * (dwr * cf[None, :])[None]).sum(-1)  # [dim, n_b]
    out = torch.zeros((dim,) + tuple(ctx.maskb.shape), dtype=torch.float64)
    out[:, live_b] = f * ctx.Volb[live_b].double()[None]
    return out


@pytest.mark.parametrize("kg", KERNELS)
@pytest.mark.parametrize("binning", ["sparse", "full"])
@pytest.mark.parametrize("dim", [2, 3])
def test_cpu_wrapper_is_the_fold(ctxs, dim, binning, kg):
    """On CPU tensors the wrapper is ``DenseCtx``'s fold, bitwise, and
    both hold to the float64 pair sum; dead slots and void columns read
    zero, and a floor cell is full to ``cap_b``."""
    ctx = copy.copy(ctxs[dim, binning])
    ctx.sim = ctx.sim.replace(kernel_gradient=kg)
    C = ctx.spec_f.num_cells
    assert int(ctx.counts_b.max()) == ctx.Pb.shape[1]
    owner = ctx.binb.active_cells if binning == "sparse" else None
    if owner is not None:
        assert bool((owner >= C).any())  # void entries in the table
    coef = _coef(ctx)
    before = dict(pair.LAUNCHES)
    out = pair.boundary_forces(ctx.spec_f, ctx.h, dim, kg, ctx.P, coef,
                               ctx.counts, ctx.Pb, ctx.Volb, ctx.counts_b,
                               owner_cells=owner)
    assert pair.LAUNCHES == before  # the CPU launches nothing
    fold = DenseCtx._boundary_forces_fold(ctx, coef)
    assert torch.equal(out, fold)
    want = _pair_sum(ctx, coef, kg)
    peak = float(want.abs().max())
    assert peak > 0
    torch.testing.assert_close(out.double(), want, rtol=RTOL,
                               atol=ATOL * peak)
    dead = ctx.maskb == 0
    assert not bool(out[:, dead].any())
    if owner is not None:
        assert not bool(out[..., owner >= C].any())


# The layouts of ``tools/fold_parity.py`` whose binding runs the pass
# (its plain twin on the CPU) or keeps the plain fold.
PASS_LAYOUTS = ("grid_sparse", "grid_full", "grid_sparse_full_stencil")
FOLD_LAYOUTS = ("brute", "compact", "spill")


def _fold_parity():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "fold_parity", os.path.join(root, "tools", "fold_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", PASS_LAYOUTS + FOLD_LAYOUTS)
def test_binding_chooses_pass_or_fold(layout, monkeypatch):
    """The grid bindings route ``DenseCtx.boundary_forces`` through
    ``ops.pair.boundary_forces`` (once a call); the brute tier, the
    compact layout and dense+spill keep the plain fold. Either way the
    result is the fold's, bitwise."""
    ctx, _, _ = _fold_parity().bind(layout)
    calls = []
    wrapper = pair.boundary_forces

    def counted(*args, **kw):
        calls.append(layout)
        return wrapper(*args, **kw)

    monkeypatch.setattr(pair, "boundary_forces", counted)
    coef = _coef(ctx)
    out = ctx.boundary_forces(coef)
    assert len(calls) == (1 if layout in PASS_LAYOUTS else 0)
    assert torch.equal(out, DenseCtx._boundary_forces_fold(ctx, coef))
    assert float(out.abs().max()) > 0


def test_wrapper_refuses_what_the_kernel_does_not_take(ctxs):
    ctx = ctxs[3, "sparse"]
    coef = _coef(ctx)
    args = [ctx.spec_f, ctx.h, 3, "cubic", ctx.P, coef, ctx.counts, ctx.Pb,
            ctx.Volb, ctx.counts_b]
    owner = ctx.binb.active_cells

    def call(i=None, value=None, **kw):
        a = list(args)
        if i is not None:
            a[i] = value
        return pair.boundary_forces(*a, **kw)

    with pytest.raises(KeyError):
        call(3, "gaussian", owner_cells=owner)
    with pytest.raises(TypeError):
        call(5, coef.double(), owner_cells=owner)
    with pytest.raises(ValueError):
        call(8, ctx.Volb[:, :-1], owner_cells=owner)
    with pytest.raises(ValueError):  # the table's columns are not the grid's
        call()
    with pytest.raises(ValueError):
        call(owner_cells=owner.long())
    with pytest.raises(ValueError):
        call(9, ctx.counts_b[:-1], owner_cells=owner)
