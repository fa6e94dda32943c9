"""The artificial viscosity's fluid-fluid pass (``ops.pair.artificial_visc_ff``)
on CPU tensors against ``ArtificialViscosityDense``'s own fold.

On CPU tensors the wrapper runs ``artificial_visc_ff_plain``: the fold of
``forces_dense`` over the grid's rolls, the live slots rebuilt from the
per-cell counts. It must equal, bitwise, the force's fold over the
``DenseFields`` views (the views the brute tier and the compact layout
keep), on seeded 2D and 3D grids of two fluids with different
coefficients, alphas, betas and speeds of sound, under every SPH kernel
name. So the CPU path that the JAX parity tests hold stays what it was.

:func:`visc_grid` is also the fixture of the ``gpu`` tests of the kernel
(``tests/test_torch_kernels.py``); this module imports numpy and the port
only (no JAX), so it loads on a machine without the JAX package.
"""

import types

import numpy as np
import pytest
import torch

from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import pair
from salva_tpu_torch.solver import forces_dense as fd

torch.set_num_threads(1)

H = 0.2
DT = 1.0 / 200.0
KERNELS = ("cubic", "poly6", "spiky", "viscosity")
# Two fluids, every per-fluid number different (both carry the force).
TABLES = dict(fluid_coefficients=(0.7, 0.4), alphas=(1.0, 0.6),
              betas=(0.0, 0.3), speeds_of_sound=(10.0, 14.0))


def visc_grid(dim, device, seed=0, n=None, cap=24, n_fluids=2):
    """A clustered random fluid of ``n_fluids`` fluids binned into a cap-
    ``cap`` grid (cells of more than 8 particles), with random velocities
    (v.r of either sign), volumes, rest densities (1,000 and 800) and
    densities around them. Returns a namespace: ``spec``, ``P``, ``V``,
    ``VOL``, ``RHO``, ``R0``, ``FID``, ``counts``, ``maskf``."""
    rng = np.random.default_rng(1000 * dim + seed)
    lo, hi = 0.0, 1.6
    if n is None:
        n = 600 if dim == 3 else 150
    bg = rng.uniform(lo, hi, size=(n, dim))
    centers = (rng.integers(1, 7, size=(12, dim)) + 0.5) * H
    clusters = (centers[:, None, :]
                + rng.uniform(-0.06, 0.06, size=(12, 9, dim))).reshape(-1, dim)
    pos = np.concatenate([bg, clusters])
    n = len(pos)
    fid = (np.arange(n) % 3 == 0).astype(np.int32) if n_fluids == 2 \
        else np.zeros(n, np.int32)
    rho0 = np.where(fid == 0, 1000.0, 800.0)
    spec = tdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=cap)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    binf = tdg.bin_particles(spec, t(pos),
                             torch.ones(n, dtype=torch.bool, device=device))
    assert int(binf.overflow) == 0
    P, V, VOL, R0, RHO = tdg.to_grid_multi(spec, binf, [
        (t(pos), tdg.POS_SENTINEL), (t(rng.normal(size=(n, dim))), 0.0),
        (t(rng.uniform(0.8e-3, 1.2e-3, size=n)), 0.0), (t(rho0), 1.0),
        (t(rho0 * rng.uniform(0.95, 1.1, size=n)), 1.0)])
    FID = tdg.to_grid(spec, binf, torch.from_numpy(fid).to(device), fill=-1)
    counts = (binf.mask > 0).sum(dim=0, dtype=torch.int32)
    assert int(counts.max()) > 8
    return types.SimpleNamespace(spec=spec, P=P, V=V, VOL=VOL, RHO=RHO,
                                 R0=R0, FID=FID, counts=counts,
                                 maskf=binf.mask)


def visc_args(g, kernel_gradient="cubic", tables=TABLES):
    """``pair.artificial_visc_ff``'s arguments over the grid ``g``."""
    return (g.spec, H, g.spec.dim, kernel_gradient, g.P, g.V, g.VOL, g.RHO,
            g.R0, g.FID, g.counts, tables["fluid_coefficients"],
            tables["alphas"], tables["betas"], tables["speeds_of_sound"])


def dense_fields(g, kernel_gradient="cubic", pair_kernels=False):
    """The force's ``DenseFields`` over ``g`` (roll views; a boundary of
    one empty-but-sentinel slot per cell), with the grid's counts where
    ``pair_kernels`` (the grids' route), without them as the brute tier
    and the compact layout hand the force."""
    spec = g.spec
    offs = tdg.neighbor_offsets(spec.dim)

    def roll(a, o):
        return tdg.shift_j(spec, a, offs[o])

    C = spec.num_cells
    dev = g.P.device
    Pb = torch.full((spec.dim, 1, C), tdg.POS_SENTINEL, device=dev)
    zb = torch.zeros((1, C), device=dev)
    return fd.DenseFields(
        jff=roll, jfb=roll, jbf=roll, n_offsets=len(offs), P=g.P, V=g.V,
        M=g.VOL * g.R0, VOL=g.VOL, R0=g.R0, RHO=g.RHO, FID=g.FID,
        maskf=g.maskf, Pb=Pb, Vbvel=torch.zeros_like(Pb), Volb=zb,
        maskb=zb, h=H, dim=spec.dim,
        dt=torch.tensor(DT, device=dev),
        inv_dt=torch.tensor(1.0 / DT, device=dev),
        kernel_density="cubic", kernel_gradient=kernel_gradient,
        spec=spec, counts=g.counts if pair_kernels else None)


def visc_force(boundary=(0.0, 0.0), tables=TABLES):
    return fd.ArtificialViscosityDense(
        fluid_coefficients=tables["fluid_coefficients"],
        boundary_coefficients=boundary, alphas=tables["alphas"],
        betas=tables["betas"], speeds_of_sound=tables["speeds_of_sound"])


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def grid(request):
    return visc_grid(request.param, "cpu")


@pytest.mark.parametrize("kernel_gradient", KERNELS)
def test_cpu_pass_equals_the_force_fold(grid, kernel_gradient):
    """The wrapper on CPU tensors is the force's own ff fold, bitwise, and
    counts no launch; the case pairs both fluids, both signs of v.r."""
    before = dict(pair.LAUNCHES)
    got = pair.artificial_visc_ff(*visc_args(grid, kernel_gradient))
    assert pair.LAUNCHES == before
    want, fb = visc_force().apply(dense_fields(grid, kernel_gradient))
    assert fb is None
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    # Both fluids carry terms; dead slots and the other fluid's pairs none.
    mag = got.abs().sum(dim=0)
    for f in (0, 1):
        assert float(mag[grid.FID == f].max()) > 0.0, f"fluid {f}"
    assert not bool(mag[grid.maskf == 0].any())


def test_cpu_pass_pairs_like_with_like(grid):
    """A fluid's coefficient reaches only its own fluid's slots: zeroing
    fluid 1's coefficient zeroes exactly fluid 1's accelerations (no term
    crosses fluids)."""
    tables = dict(TABLES, fluid_coefficients=(0.7, 0.0))
    got = pair.artificial_visc_ff(*visc_args(grid, tables=tables))
    full = pair.artificial_visc_ff(*visc_args(grid))
    one = grid.FID == 1
    assert not bool(got[:, one].any())
    assert torch.equal(got[:, grid.FID == 0], full[:, grid.FID == 0])


@pytest.mark.parametrize("boundary", [(0.0, 0.0), (0.3, 0.5)],
                         ids=["ff_only", "with_fb"])
def test_apply_takes_the_pass_without_changing_a_bit(grid, boundary):
    """``ArtificialViscosityDense.apply`` through ``ops.pair``
    (counts given, the grids' route) equals its fold over the views,
    bitwise, with and without the fluid-boundary terms."""
    force = visc_force(boundary)
    a0, fb0 = force.apply(dense_fields(grid, pair_kernels=False))
    a1, fb1 = force.apply(dense_fields(grid, pair_kernels=True))
    assert torch.equal(a0, a1)
    assert (fb0 is None) == (fb1 is None) == (boundary == (0.0, 0.0))
    if fb0 is not None:
        assert torch.equal(fb0, fb1)


def test_tiling_knows_the_pass():
    """``pair.tiling`` names the pass (its kernel is tiled); an unknown
    name is refused before any library is loaded."""
    with pytest.raises(ValueError, match="artificial_visc_ff"):
        pair.tiling("visc", 3, 16, 1000)
