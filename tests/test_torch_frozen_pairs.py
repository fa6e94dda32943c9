"""Frozen pair coefficients (``dense_frozen_pairs``, float32 and bfloat16
storage), run by both packages on the CPU.

Mirrors ``tests/test_dense.py::test_frozen_pairs_matches_recompute``: the
iteration-invariant s_ij = (dW/dr / r) m_j is stored once a substep and
``k_pass`` / ``t_pass`` become multiply-reduces over it (``sp_multi``,
float32 accumulation). Against the JAX package's run of the same layout
from the same inputs: identical iteration counts and exact contact
counts at every step; positions within ``atol=2e-6`` for float32
storage, and within 2e-6 for bfloat16 storage too (both packages round
the same float32 coefficients to bfloat16, to nearest even, so only the
float32 summation order differs: measured 1.5e-6 after 6 steps; the JAX
package's own bound for bfloat16 against the recomputed passes is 5e-3,
``tests/test_dense.py:358``); IISPH velocities within 1e-5 and pressures
within 2e-5 x their peak (ROADMAP Queue 3, item 8). Against the port's
recomputed passes: the JAX test's bounds, 2e-5 (float32) and 5e-3
(bfloat16), with the float32 run's iterations identical. IISPH against
the JAX package (a third JAX compile, over this file's share of Tier-1's
time) and the 3D world are ``slow``.
"""

import numpy as np
import pytest
import torch

from test_torch_compact import (
    DT,
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

STEPS = 10


def frozen_block_2d():
    """``tests/test_dense.py::_frozen_world``'s 8 x 8 block."""
    return block(2, 8, 0.1, (-0.9, 0.02))


def frozen(dtype):
    return dict(dense_frozen_pairs=True, dense_pair_dtype=dtype)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def dfsph_runs(request):
    return request.param, run_pair(frozen_block_2d(), steps=STEPS,
                                   **frozen(request.param))


def test_frozen_dfsph_matches_jax(dfsph_runs):
    _dtype, runs = dfsph_runs
    check_against_jax(runs)
    assert runs["torch"][-1]["counts"]["ncontacts_fb"] > 0


@pytest.mark.slow
def test_frozen_iisph_matches_jax():
    check_against_jax(run_pair(frozen_block_2d(), solver="iisph",
                               **frozen("float32")),
                      vel_atol=1e-5, state_atol=2e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 5e-3)])
def test_frozen_matches_recompute(dtype, atol):
    """The frozen passes against the port's recomputed ones (the JAX
    test's bounds), 10 steps; the float32 run's iterations and contact
    counts identical (the bfloat16 run's trajectory parts from the
    recomputed one by ~1e-3 m, and pairs near r = h with it)."""
    runs = []
    for flags in ({}, frozen(dtype)):
        w, fl, _ = layout_world("torch", frozen_block_2d(), **flags)
        snaps = []
        for _ in range(STEPS):
            w.step(DT, gravity(2))
            snaps.append(snapshot(w, fl))
        runs.append(snaps)
    for r, f in zip(*runs):
        np.testing.assert_allclose(f["pos"], r["pos"], rtol=0, atol=atol)
        if dtype == "float32":
            assert f["iters"] == r["iters"]
            assert f["counts"] == r["counts"]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_passes_match_recomputed(dim, dtype):
    """At one state: ``k_pass`` / ``t_pass`` through the stored
    coefficients against the recomputed passes on the same binning
    (float32: the pair kernels' tolerance, rtol 1e-4 and 1e-5 x the
    output's peak; bfloat16: 1e-2 x peak, its 8-bit mantissa), and the
    store: 3^dim coefficient blocks [cap, cap, C] of the storage dtype."""
    pos = (block(2, 8, 0.1, (-0.9, 0.02)) if dim == 2
           else block(3, 4, 0.1, (-0.2, 0.1, -0.2)))
    w, _, _ = layout_world("torch", pos, caps=(16, 16))
    w.step(DT, gravity(dim))
    plain = dense_ctx(w)
    ctx = dense_ctx(w, **frozen(dtype))
    cap, C = ctx.maskf.shape
    assert len(ctx.S) == 3 ** dim
    assert all(S.shape == (cap, cap, C) and S.dtype == getattr(torch, dtype)
               for S in ctx.S)
    g = torch.Generator().manual_seed(0)
    Q = torch.randn(ctx.V.shape, generator=g) * ctx.maskf[None]
    K = torch.randn(ctx.maskf.shape, generator=g) * ctx.maskf
    rtol, atol = (1e-4, 1e-5) if dtype == "float32" else (0.0, 1e-2)
    for got, want in ((ctx.t_pass(Q), plain.t_pass(Q)),
                      (ctx.k_pass(K), plain.k_pass(K))):
        peak = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol * peak)


def test_frozen_with_spill_refused():
    """As in the JAX package: frozen pairs with the spill structure
    raise."""
    w, _, _ = layout_world("torch", frozen_block_2d(), caps=(3, 16),
                           dense_spill_columns=64, **frozen("float32"))
    with pytest.raises(NotImplementedError, match="dense_spill_columns"):
        w.step(DT, gravity(2))


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_matches_jax_3d(dtype):
    """The 4^3 block on the 3D grid with frozen pairs against the JAX
    package."""
    check_against_jax(run_pair(block(3, 4, 0.1, (-0.2, 0.1, -0.2)),
                               steps=4, caps=(12, 16), **frozen(dtype)))
