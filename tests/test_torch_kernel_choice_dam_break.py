"""The 3D dense dam break under the non-cubic SPH kernels and with the
DFSPH implicit viscosity, run by both packages on the CPU.

The 7^3 scene of ``tests/test_torch_dam_break.py`` (its ``run_both``, one
JAX and one port world per scenario, shared by the module's tests; each
scenario has a module: ``dfsph_implicit_visc`` runs in
``tests/test_torch_implicit_visc_dam_break.py``, which reuses these
tests, since each costs 1-2.5 minutes on the CPU, most of it the JAX
compiles):

- ``dfsph_poly6_spiky`` (here): DFSPH with ``kernel_density="poly6"`` and
  ``kernel_gradient="spiky"`` and no force, 6 steps: the boundary
  volumes, both hoists and every solver pass under the non-cubic
  kernels;
- ``dfsph_implicit_visc``: DFSPH, the cubic spline, the fluid carrying
  ``DFSPHViscosity(0.5, max_viscosity_iter=1)``, 2 steps: the single
  application (one viscosity update a step). At the force's defaults (up
  to 50 iterations a step) the reference's iteration diverges, as
  ``tests/test_dense.py:110-114`` warns: run so, both packages reached
  non-finite positions within these 2 steps, with identical iteration
  counts and contact counts (and ~7 minutes of eager torch on the CPU),
  so the scenario holds the single application instead.

Held as that file holds the dam break: identical iteration counts, exact
contact and overflow counts, positions within 2e-6 m, velocities and
solver state within 2e-6, the boundary forces as
``check_boundary_volumes_and_forces`` holds them, every position finite.
The viscosity's iterations are the port's (``counters.FORCE_ITERATIONS``:
one a step). In its 2 steps the block does not yet close on the floor
(the fb contact count stays at 588), so that scenario's contact counts
are held exactly without the growth that the 6-step scenarios show.
"""

import numpy as np
import pytest
import torch

from salva_tpu_torch import counters
from test_torch_dam_break import (
    check_boundary_volumes_and_forces,
    check_contact_and_overflow_counts,
    check_iteration_counts,
    check_positions_and_velocities,
    check_resolved_layout,
    check_scene_and_initial_state,
    run_both,
)

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

SCENARIOS = {
    "dfsph_poly6_spiky": dict(solver="dfsph", kernels=("poly6", "spiky")),
    "dfsph_implicit_visc": dict(solver="dfsph", steps=2, forces=(
        ("DFSPHViscosity", dict(viscosity_coefficient=0.5,
                                max_viscosity_iter=1)),)),
}


def scenario_runs(name):
    counters.reset_force_iterations()
    run = run_both(**SCENARIOS[name])
    return dict(run, name=name,
                visc_iters=counters.FORCE_ITERATIONS["dfsph_viscosity"])


@pytest.fixture(scope="module", params=["dfsph_poly6_spiky"])
def runs(request):
    return scenario_runs(request.param)


def test_scene_and_initial_state_match(runs):
    check_scene_and_initial_state(runs)


def test_kernels_forces_and_layout_match(runs):
    wj, wt = runs["worlds"]
    assert (wt.sim.kernel_density, wt.sim.kernel_gradient) == (
        wj.sim.kernel_density, wj.sim.kernel_gradient)
    assert [vars(f) for f in wt._force_set] == [
        vars(f) for f in wj._force_set]
    if runs["name"] == "dfsph_implicit_visc":
        assert [type(f).__name__ for f in wt._force_set] == [
            "DFSPHViscosityForce"]
        assert runs["visc_iters"] == len(runs["torch"])  # one a step
    else:
        assert runs["visc_iters"] == 0
    check_resolved_layout(runs)


def test_iteration_counts_identical(runs):
    check_iteration_counts(runs)


def test_contact_and_overflow_counts_exact(runs):
    if runs["name"] != "dfsph_implicit_visc":
        check_contact_and_overflow_counts(runs)
        return
    keys = ("ncontacts_ff", "ncontacts_fb", "neighbor_overflow",
            "candidate_overflow")
    for j, t in zip(runs["jax"], runs["torch"]):
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        assert t["ncontacts_fb"] > 0


def test_positions_and_velocities_match(runs):
    for s in runs["jax"] + runs["torch"]:
        assert np.isfinite(s["fluids"]["positions"]).all()
    check_positions_and_velocities(runs)


def test_boundary_volumes_and_forces_match(runs):
    check_boundary_volumes_and_forces(runs)
