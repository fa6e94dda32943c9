"""The ``dfsph_implicit_visc`` scenario of
``tests/test_torch_kernel_choice_dam_break.py`` (DFSPH with
``DFSPHViscosity(0.5, max_viscosity_iter=1)``, 2 steps; why one
iteration, there), in a module of its own: the tests are that module's
(imported, so collected here with this module's ``runs``)."""

import pytest
import torch

from test_torch_kernel_choice_dam_break import (  # noqa: F401  collected here
    scenario_runs,
    test_boundary_volumes_and_forces_match,
    test_contact_and_overflow_counts_exact,
    test_iteration_counts_identical,
    test_kernels_forces_and_layout_match,
    test_positions_and_velocities_match,
    test_scene_and_initial_state_match,
)

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["dfsph_implicit_visc"])
def runs(request):
    return scenario_runs(request.param)
