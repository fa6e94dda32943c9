"""SPH kernels of the PyTorch port against ``salva_tpu.kernels.sph``.

Both packages evaluate every kernel and its radial derivative on the same
float32 r-grid (numpy), in 2D and 3D; the fused cubic pair form
(``w_dwr``, which the hand kernels reproduce) is compared too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salva_tpu.kernels import sph as jsph
from salva_tpu.solver.dense_common import w_dwr as j_w_dwr
from salva_tpu_torch.kernels import sph as tsph

H = 0.2
# Dense r-grid over [0, 1.2 h] plus the branch points (q = 0.5, 1) and
# r = 0; values straddling the cubic's q <= 1e-5 derivative cutoff are
# left out (a last-ulp difference in q flips a discontinuous branch).
_R = np.concatenate([
    np.linspace(0.0, 1.2 * H, 2001),
    [0.5 * H, H, 3.0e-6, 1.0e-3],
]).astype(np.float32)
_R = _R[(_R == 0.0) | (_R / H > 1.0e-4)]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", sorted(tsph.KERNELS))
def test_kernel_and_derivative_match(name, dim):
    jw, jdw = jsph.get_kernel(name)
    tw, tdw = tsph.get_kernel(name)
    r_t = torch.from_numpy(_R)
    r_j = jnp.asarray(_R)
    for jf, tf in ((jw, tw), (jdw, tdw)):
        np.testing.assert_allclose(
            tf(r_t, H, dim).numpy(), np.asarray(jf(r_j, H, dim)),
            rtol=1e-6, atol=1e-7,
        )


@pytest.mark.parametrize("dim", [2, 3])
def test_cubic_normalizer_matches(dim):
    for h in (H, 0.1, 0.37):
        assert tsph._cubic_normalizer(h, dim) == jsph._cubic_normalizer(h, dim)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", ["cubic", "poly6"])
def test_fused_w_dwr_matches(name, dim):
    r2 = (_R.astype(np.float32)) ** 2
    jw, jdw = jsph.get_kernel(name)
    tw, tdw = tsph.get_kernel(name)
    wj, dj = j_w_dwr(jnp.asarray(r2), H, dim, jw, jdw)
    wt, dt = tsph.w_dwr(torch.from_numpy(r2), H, dim, tw, tdw)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-7)
    # dW/dr / r carries a 1/h^2 scale (~1e4 here): relative tolerance.
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6,
                               atol=1e-7 * float(np.abs(np.asarray(dj)).max()))


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        tsph.get_kernel("gaussian")
