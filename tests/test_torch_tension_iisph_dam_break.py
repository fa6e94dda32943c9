"""The ``iisph_tension_poly6_spiky`` scenario of
``tests/test_torch_tension_dam_break.py`` (IISPH under poly6 / spiky with
the WCSPH and He 2014 surface tensions), in a module of its own: the
tests are that module's (imported, so collected here with this module's
``runs``); tolerances as there."""

import pytest
import torch

from test_torch_tension_dam_break import (  # noqa: F401  collected here
    scenario_runs,
    test_boundary_volumes_and_forces_match,
    test_contact_and_overflow_counts_exact,
    test_force_set_and_layout_match,
    test_iteration_counts_identical,
    test_positions_and_velocities_match,
    test_scene_and_initial_state_match,
)

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["iisph_tension_poly6_spiky"])
def runs(request):
    return scenario_runs(request.param)
