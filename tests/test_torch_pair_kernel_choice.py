"""The plain pair passes of the PyTorch port under the non-cubic SPH
kernels, against the JAX package.

The cases of ``tests/test_torch_pair_passes.py`` (its clustered fixture,
2D and 3D, the JAX ``DenseCtx`` half-stencil folds and the Pallas v3 and
v2 kernels in interpret mode) with ``(kernel_density, kernel_gradient)``
set to poly6 / spiky, spiky / viscosity and viscosity / poly6, so that
each non-cubic kernel is held in each role: the JAX side evaluates them
as ``pallas_pair._grad_scale_fn`` / ``_w_scale_fn`` and
``dense_common.w_dwr`` do. Tolerances are that file's: rtol 1e-4 / atol
1e-5 for ``k_pass`` / ``t_pass`` (and ``k_pass_v2``), 1e-3 for the hoists'
float outputs, exact pair counts. The cubic cases stay in that file.

The CUDA kernels under these names are held against the plain versions
on the card (``tests/test_torch_kernels.py``, ``gpu``-marked, and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from salva_tpu.ops.pallas_pair2 import (
    hoist_fb_pallas3,
    hoist_ff_pallas3,
    k_pass_pallas2,
    k_pass_pallas3,
    t_pass_pallas3,
)
from salva_tpu_torch.ops import pair
from test_torch_pair_passes import (
    H,
    HOIST_TOL,
    KT_TOL,
    TILE,
    _close,
    _fb_args,
    _state,
)

# One intra-op thread (see tests/test_torch_pair_passes.py).
torch.set_num_threads(1)

PAIRS = [("poly6", "spiky"), ("spiky", "viscosity"), ("viscosity", "poly6")]
# (dim, kernels) cases of this module: every pair in 2D and poly6 / spiky in
# 3D; ``tests/test_torch_pair_kernel_choice_3d.py`` runs the same tests on
# the two other pairs in 3D (a 3D case costs ~60 s on the CPU, most of it
# the JAX compiles).
CASES = [(2, p) for p in PAIRS] + [(3, PAIRS[0])]


def case_id(case):
    dim, (kd, kg) = case
    return f"{dim}d-{kd}-{kg}"


def make_state(request):
    dim, kernels = request.param
    return (dim, kernels) + _state(dim, kernels)


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def state(request):
    return make_state(request)


def test_k_pass_plain_matches(state):
    dim, (kd, kg), spec, ref, tspec, t = state
    out = pair.k_pass_plain(tspec, H, dim, kg, t["P"], t["M"], t["K"],
                            t["counts"])
    assert float(out.abs().max()) > 0
    _close(out.numpy(), ref["k"], KT_TOL)
    _close(out.numpy(), k_pass_pallas3(
        spec, H, dim, kg, ref["P"], ref["M"], ref["K"], tile=TILE,
        interpret=True), KT_TOL)


def test_k_pass_v2_matches_pallas2(state):
    dim, (kd, kg), spec, ref, tspec, t = state
    out = pair.k_pass_v2(tspec, H, dim, kg, t["P"], t["M"], t["K"],
                         t["counts"])
    _close(out.numpy(), k_pass_pallas2(
        spec, H, dim, kg, ref["P"], ref["M"], ref["K"], tile=TILE,
        interpret=True), KT_TOL)


def test_t_pass_plain_matches(state):
    dim, (kd, kg), spec, ref, tspec, t = state
    out = pair.t_pass_plain(tspec, H, dim, kg, t["P"], t["M"], t["V"],
                            t["counts"])
    assert float(out.abs().max()) > 0
    _close(out.numpy(), ref["t"], KT_TOL)
    _close(out.numpy(), t_pass_pallas3(
        spec, H, dim, kg, ref["P"], ref["M"], ref["V"], tile=TILE,
        interpret=True), KT_TOL)


def test_hoist_ff_plain_matches(state):
    dim, (kd, kg), spec, ref, tspec, t = state
    out = pair.hoist_ff_plain(tspec, H, dim, kd, kg, t["P"], t["M"],
                              t["counts"], need_s2=True)
    refs = (
        ref["hoist"],
        hoist_ff_pallas3(spec, H, dim, kd, kg, ref["P"], ref["M"],
                         need_s2=True, tile=TILE, interpret=True),
    )
    for want in refs:
        for o, r in zip(out[:4], want[:4]):
            _close(o.numpy(), r, HOIST_TOL)
        np.testing.assert_array_equal(out[4].numpy(), np.asarray(want[4]))
    assert float(out[0].abs().max()) > 0 and int(out[4].sum()) > 0


def test_hoist_fb_plain_matches(state):
    dim, kernels, spec, ref, tspec, t = state
    out = pair.hoist_fb_plain(*_fb_args(tspec, dim, t, kernels),
                              need_s2=True)
    want = hoist_fb_pallas3(
        spec, t["Pb"].shape[1], H, dim, *kernels, ref["P"], ref["M"],
        ref["Pb"], ref["Volb"], ref["Vbvel"], need_s2=True, tile=TILE,
        interpret=True,
    )
    for o, r in zip(out[:5], want[:5]):
        assert float(np.abs(np.asarray(r)).max()) > 0  # channel exercised
        _close(o.numpy(), r, HOIST_TOL)
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(want[5]))
