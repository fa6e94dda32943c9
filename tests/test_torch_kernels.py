"""The hand CUDA kernels of ``salva_tpu_torch.ops.pair`` against their
plain PyTorch versions, on the card.

Every test here needs a CUDA device (``gpu`` marker) and skips without
one. The file imports torch and the port only (no JAX), so it runs on a
GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Fixture: a clustered random fluid binned by the port's dense grid, in 2D
and 3D, with cells over 8 particles. Tolerances as in
``tests/test_torch_pair_passes.py`` (the kernels walk the full stencil,
the plain versions the half stencil: float32 summation order only).
"""

import numpy as np
import pytest
import torch

from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import pair

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


@pytest.mark.parametrize("dim", [2, 3])
def test_k_and_t_kernels_match_plain(cuda, dim):
    spec, P, M, V, K, counts = _grid(dim, cuda)
    before = dict(pair.LAUNCHES)
    args = (spec, H, dim, "cubic", P, M)
    _assert_close(pair.k_pass(*args, K, counts),
                  pair.k_pass_plain(*args, K, counts), KT_TOL)
    _assert_close(pair.t_pass(*args, V, counts),
                  pair.t_pass_plain(*args, V, counts), KT_TOL)
    assert pair.LAUNCHES["k_pass"] == before["k_pass"] + 1
    assert pair.LAUNCHES["t_pass"] == before["t_pass"] + 1


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("need_s2", [False, True])
def test_hoist_kernel_matches_plain(cuda, dim, need_s2):
    spec, P, M, V, K, counts = _grid(dim, cuda)
    args = (spec, H, dim, "cubic", "cubic", P, M, counts)
    out = pair.hoist_ff(*args, need_s2=need_s2)
    ref = pair.hoist_ff_plain(*args, need_s2=need_s2)
    for o, r in zip(out[:4], ref[:4]):
        _assert_close(o, r, HOIST_TOL)
    assert torch.equal(out[4], ref[4])  # pair counts exact


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


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    spec, P, M, V, K, counts = _grid(3, cuda)
    with pytest.raises(NotImplementedError):
        pair.k_pass(spec, H, 3, "poly6", P, M, K, counts)
    with pytest.raises(ValueError):
        pair.t_pass(spec, H, 3, "cubic", P, M, V.transpose(1, 2)
                    .contiguous().transpose(1, 2), counts)
    with pytest.raises(ValueError):
        pair.k_pass(spec, H, 3, "cubic", P, M.cpu(), K, counts)
