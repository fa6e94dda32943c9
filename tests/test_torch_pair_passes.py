"""The three pair passes of the PyTorch port against the JAX package.

The plain PyTorch versions (``k_pass_plain``, ``t_pass_plain``,
``hoist_ff_plain``) are held, on the same grid state, against

- the JAX ``DenseCtx`` half-stencil folds (``_k_pass_half``,
  ``_t_pass_half``, ``_hoist_ff_half``), and
- the Pallas v3 kernels in interpret mode (``k_pass_pallas3``,
  ``t_pass_pallas3``, ``hoist_ff_pallas3``: the v1 lo slice plus the hi
  complement), as ``tests/test_pallas_ops.py`` runs them on the CPU,

in 2D and 3D, on a clustered fixture that puts more than 8 particles in
some cells (so the hi complement carries real blocks). Tolerances follow
``tests/test_pallas_ops.py``: rtol 1e-4 / atol 1e-5 for k and t, 1e-3 for
the hoist's float outputs, exact pair counts.

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
    hoist_ff_pallas3,
    k_pass_pallas3,
    t_pass_pallas3,
)
from salva_tpu.solver.dense_common import DenseCtx
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import pair

H = 0.2
KT_TOL = dict(rtol=1e-4, atol=1e-5)
HOIST_TOL = dict(rtol=1e-3, atol=1e-3)
# One 128-lane chunk per Pallas program: the interpret-mode hi complement
# unrolls its chunk loop, so this is the cheapest program to compile.
TILE = 128


def _state(dim):
    """Uniform background + tight clusters in distinct cells: several
    cells hold 9..16 particles (cap 16, no overflow)."""
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
    sim = SimConfig(dim=dim, particle_radius=0.05, use_pallas=False,
                    dense_compact=False, dense_spill_auto=False,
                    domain=((lo,) * dim, (hi,) * dim))
    spec = jdg.spec_for_aabb((lo,) * dim, (hi,) * dim, H, cap=16)

    @jax.jit
    def reference(pos, vel, alive):
        """Bin through the JAX DenseCtx and run its half-stencil folds
        (one compiled program: far cheaper than eager op dispatch)."""
        fl = FluidsState.empty(n, dim).replace(
            positions=pos,
            velocities=vel,
            volumes=jnp.full((n,), 1e-3, jnp.float32),
            density0=jnp.full((n,), 1000.0, jnp.float32),
            alive=alive,
        )
        ctx = DenseCtx(sim, spec, spec.replace(cap=4), fl,
                       BoundariesState.empty(8, dim))
        K = ctx.rho * 1e-6
        return dict(
            P=ctx.P, M=ctx.M, V=ctx.V, K=K, mask=ctx.maskf,
            overflow=ctx.binf.overflow, k=ctx._k_pass_half(K),
            t=ctx._t_pass_half(ctx.V), hoist=ctx._hoist_ff_half(),
        )

    ref = reference(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(alive))
    counts = np.asarray(ref["mask"]).sum(axis=0).astype(np.int32)
    assert counts.max() > 8, counts.max()  # hi slot groups are live
    assert int(ref["overflow"]) == 0
    tspec = tdg.DenseGridSpec(spec.origin, spec.dims, spec.cap,
                              spec.cell_width)
    t = {k: torch.from_numpy(np.array(ref[k])) for k in ("P", "M", "V", "K")}
    t["counts"] = torch.from_numpy(counts)
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
    assert pair.LAUNCHES == before
