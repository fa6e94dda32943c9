"""The surface-tension and DFSPH-viscosity dense forces of the PyTorch port
against the JAX package, at field level.

``Akinci2013SurfaceTensionDense``, ``WCSPHSurfaceTensionDense``,
``He2014SurfaceTensionDense`` and ``DFSPHViscosityDense`` of both packages
on the numpy grids of ``tests/test_torch_forces.py`` (2D and 3D; two
fluids, of which only fluid 0 carries the force; a moving boundary layer
through the fluid, so the adhesion and boundary-tension passes and their
feedback run), under the cubic spline and under poly6 (density) / spiky
(gradient): the acceleration and the boundary feedback within 1e-5 of
each output's peak (float32 summation order only; both evaluate the same
pair terms).

The DFSPH viscosity runs at ``max_viscosity_iter=1`` (one update), in 2D
and 3D, and at its defaults (up to 50 iterations), in 2D only: a 3D case
at the defaults took 87-100 s of eager torch on the CPU. It is held to
1e-3 of its peak: its update solves beta's [S, S] systems by a batched
float32 inverse (``torch.linalg.inv``, ``jnp.linalg.inv``), and on these
grids some are near-singular. On the 2D grid the float32 and a float64
inverse put the port's acceleration 1.2e-4 of its peak apart, and the two
packages' float32 results 5.5e-5 apart (4.1e-4 in 3D). The JAX package's
own dense-against-gather test of this force holds it to rtol 2e-3 / atol
1e-2 (``tests/test_dense.py``). At the defaults the reference's iteration
diverges on the cubic grid (``tests/test_dense.py:110-114``, its upstream
instability): both packages then run all 50 iterations and reach the
same non-finite slots, and their finite slots are held as above.

The Akinci cohesion and adhesion kernels are held against the JAX
package's on a dense r-grid.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.kernels import sph as jsph
from salva_tpu.solver import forces_dense as jfd
from salva_tpu_torch import counters
from salva_tpu_torch.kernels import sph as tsph
from salva_tpu_torch.solver import forces_dense as tfd
from test_torch_forces import FIELD_ATOL, _fields, _grids

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

H = 0.2
# (dense class, fluid 0's coefficients as the world merges them for two
# fluids; fluid 1 carries no force): faucet3's Akinci tension
# (`salva_tpu/scenes.py:429`), the WCSPH and He 2014 tensions of
# `tests/test_dense.py:278-279`, and the DFSPH viscosity of
# `tests/test_dense.py` at one iteration.
FORCE_CASES = {
    "akinci": ("Akinci2013SurfaceTensionDense", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_adhesion_coefficients=(10.0, 0.0))),
    "wcsph": ("WCSPHSurfaceTensionDense", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_tension_coefficients=(0.5, 0.0))),
    "he2014": ("He2014SurfaceTensionDense", dict(
        fluid_tension_coefficients=(1.0, 0.0),
        boundary_tension_coefficients=(0.5, 0.0))),
    "dfsph_viscosity_1": ("DFSPHViscosityDense", dict(
        viscosity_coefficients=(0.5, 0.0), participating=(1, 0),
        max_viscosity_iter=1)),
}
KERNEL_PAIRS = {"cubic": ("cubic", "cubic"), "poly6_spiky": ("poly6", "spiky")}
VISC_ATOL = 1e-3  # x the peak: the DFSPH viscosity (module docstring)


def _check(cls, got, want, atol, finite_only=False):
    """Each output of ``got`` within ``atol`` x the peak of ``want``;
    with ``finite_only``, both non-finite at the same slots and the
    finite slots held."""
    for name, a, b in zip(("accel", "boundary feedback"), got, want):
        if b is None:  # the DFSPH viscosity has no boundary term
            assert a is None and cls == "DFSPHViscosityDense"
            continue
        a, b = a.numpy(), np.asarray(b)
        fin = np.isfinite(b)
        if finite_only:
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=name)
            if not fin.any():  # diverged everywhere: nothing to compare
                continue
            a, b = a[fin], b[fin]
        else:
            assert fin.all(), name
        peak = float(np.abs(b).max())
        assert peak > 0, f"{name}: the case exercises nothing"
        np.testing.assert_allclose(a, b, rtol=0, atol=atol * peak,
                                   err_msg=name)


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def grids(request):
    return _grids(request.param)


@pytest.mark.parametrize("kernels", list(KERNEL_PAIRS))
@pytest.mark.parametrize("case", list(FORCE_CASES))
def test_dense_force_matches_jax(grids, case, kernels):
    spec, g = grids
    cls, kw = FORCE_CASES[case]
    kern = KERNEL_PAIRS[kernels]
    want = getattr(jfd, cls)(**kw).apply(_fields("jax", spec, g, kern))
    counters.reset_force_iterations()
    got = getattr(tfd, cls)(**kw).apply(_fields("torch", spec, g, kern))
    visc = cls == "DFSPHViscosityDense"
    _check(cls, got, want, VISC_ATOL if visc else FIELD_ATOL)
    # Only fluid 0 carries the force: fluid 1's live slots get nothing.
    other = g["FID"] == 1
    assert other.any()
    assert not np.abs(got[0].numpy()[:, other]).any()
    assert counters.FORCE_ITERATIONS["dfsph_viscosity"] == (1 if visc
                                                            else 0)


@pytest.mark.parametrize("kernels", list(KERNEL_PAIRS))
def test_dfsph_viscosity_at_defaults_matches_jax(kernels):
    """``DFSPHViscosity(0.5)``'s defaults (1 to 50 iterations, error 0.01)
    on the 2D grid; where the reference diverges (module docstring) the
    port runs all 50 iterations to the same non-finite slots (on the
    cubic grid, every slot)."""
    spec, g = _grids(2)
    kern = KERNEL_PAIRS[kernels]
    kw = dict(viscosity_coefficients=(0.5, 0.0), participating=(1, 0))
    want = jfd.DFSPHViscosityDense(**kw).apply(_fields("jax", spec, g, kern))
    counters.reset_force_iterations()
    got = tfd.DFSPHViscosityDense(**kw).apply(
        _fields("torch", spec, g, kern))
    iters = counters.FORCE_ITERATIONS["dfsph_viscosity"]
    diverged = not np.isfinite(np.asarray(want[0])).all()
    assert 1 <= iters <= 50 and (iters == 50 or not diverged)
    _check("DFSPHViscosityDense", got, want, VISC_ATOL,
           finite_only=diverged)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", ["cohesion_kernel", "adhesion_kernel"])
def test_akinci_kernels_match(name, dim):
    r = np.concatenate([np.linspace(0.0, 1.2 * H, 2001),
                        [0.5 * H, H]]).astype(np.float32)
    want = np.asarray(getattr(jsph, name)(jnp.asarray(r), H, dim))
    got = getattr(tsph, name)(torch.from_numpy(r), H, dim).numpy()
    assert float(np.abs(want).max()) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
