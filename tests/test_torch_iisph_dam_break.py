"""The 3D dense dam break on the paths the port added after DFSPH, run
by both packages on the CPU:

- ``iisph``: the scene of ``tests/test_torch_dam_break.py`` with
  ``solver=IISPHConfig()`` (the relaxed-Jacobi pressure solve over
  ``k_pass`` / ``t_pass`` and both hoists with their ``s2`` channels);
- ``dfsph_full_grid``: the DFSPH dam break with
  ``dense_sparse_boundary=False`` on both sides (the boundaries bin into
  the fluid grid's cells; the JAX package's full-grid fb hoist).

Same pins, 6 steps and checks as that file (its ``run_both`` and
``check_*`` helpers): identical pressure (and divergence) iteration
counts, exact contact and overflow counts, positions within
``atol=2e-6``. Velocities and solver state are held to 2e-6 (the state
to 2e-6 x max(1, its peak)) on the DFSPH scenario. IISPH divides each
Jacobi update by ``a_ii = d_ii . Gsum - factor * s2_m``, a difference of
near-equal terms, so last-ulp differences of the hoisted sums (the two
frameworks sum in different orders) grow through the solve: measured
over the 6 steps, positions differ by at most 6.0e-8 m, velocities by
3.1e-6 m/s and pressures by 7.6e-6 of their peak (~5e4 Pa, where one
float32 ulp is 4e-3). IISPH velocities are held to 1e-5 and pressures to
2e-5 x their peak. One JAX and one port world per scenario, shared by
the module's tests.
"""

import pytest

from test_torch_dam_break import (
    check_boundary_volumes_and_forces,
    check_contact_and_overflow_counts,
    check_iteration_counts,
    check_positions_and_velocities,
    check_resolved_layout,
    check_scene_and_initial_state,
    run_both,
)

# scenario: (run_both arguments, check_positions_and_velocities tolerances)
SCENARIOS = {
    "iisph": (dict(solver="iisph", sparse_boundary=True),
              dict(vel_atol=1e-5, state_atol=2e-5)),
    "dfsph_full_grid": (dict(solver="dfsph", sparse_boundary=False), {}),
}


@pytest.fixture(scope="module", params=list(SCENARIOS))
def runs(request):
    args, tol = SCENARIOS[request.param]
    return dict(run_both(**args), tol=tol)


def test_scene_and_initial_state_match(runs):
    check_scene_and_initial_state(runs)


def test_resolved_layout_matches(runs):
    check_resolved_layout(runs)
    wj, wt = runs["worlds"]
    assert wt.sim.dense_sparse_boundary == wj.sim.dense_sparse_boundary


def test_iteration_counts_identical(runs):
    check_iteration_counts(runs)
    # The solve does real work: some step needs more than one iteration.
    assert max(s["p_iters"] for s in runs["torch"]) > 1


def test_contact_and_overflow_counts_exact(runs):
    check_contact_and_overflow_counts(runs)


def test_positions_and_velocities_match(runs):
    check_positions_and_velocities(runs, **runs["tol"])


def test_boundary_volumes_and_forces_match(runs):
    check_boundary_volumes_and_forces(runs)
