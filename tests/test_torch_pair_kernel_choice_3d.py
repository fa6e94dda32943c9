"""The cases of ``tests/test_torch_pair_kernel_choice.py`` on its two
other kernel pairs in 3D (spiky / viscosity and viscosity / poly6), in a
module of their own so that each file stays near a minute on the CPU.
The test functions are that module's (imported, so collected here with
this module's ``state``); tolerances and references as there."""

import pytest
import torch

from test_torch_pair_kernel_choice import (  # noqa: F401  collected here
    PAIRS,
    case_id,
    make_state,
    test_hoist_fb_plain_matches,
    test_hoist_ff_plain_matches,
    test_k_pass_plain_matches,
    test_k_pass_v2_matches_pallas2,
    test_t_pass_plain_matches,
)

# One intra-op thread (see tests/test_torch_pair_passes.py).
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[(3, p) for p in PAIRS[1:]],
                ids=case_id)
def state(request):
    return make_state(request)
