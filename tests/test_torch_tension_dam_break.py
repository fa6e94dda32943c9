"""The 3D dense dam break with the surface-tension forces, run by both
packages on the CPU.

The 7^3 scene of ``tests/test_torch_dam_break.py`` (its ``run_both``, 6
steps, one JAX and one port world per scenario, shared by the module's
tests):

- ``dfsph_faucet3`` (here): DFSPH, the cubic spline, the fluid carrying
  faucet3's forces (`salva_tpu/scenes.py:428-429`):
  ``XSPHViscosity(0.5, 0.0)`` and ``Akinci2013SurfaceTension(1.0,
  10.0)``, whose adhesion drives the fluid-boundary and boundary-fluid
  passes;
- ``iisph_tension_poly6_spiky`` (``tests/test_torch_tension_iisph_dam_
  break.py``, which reuses this module's tests): IISPH with
  ``kernel_density="poly6"`` and ``kernel_gradient="spiky"`` (every pair
  pass and hoist under the non-cubic kernels), the fluid carrying
  ``WCSPHSurfaceTension(1.0, 0.5)`` and ``He2014SurfaceTension(1.0,
  0.5)`` (`tests/test_dense.py:278-279`). Each scenario costs 2-3 minutes
  on the CPU, most of it the JAX compiles, hence a module each.

Held as that file holds the dam break: identical iteration counts, exact
contact and overflow counts, positions within 2e-6 m, the boundary
forces as ``check_boundary_volumes_and_forces`` holds them; velocities
within 1e-5 m/s and the solver state within 2e-5 (x its peak, where that
exceeds 1): IISPH pressures, as its parity test holds them (its Jacobi
update amplifies last-ulp differences), and faucet3's DFSPH velocities
and velocity changes. The Akinci adhesion kernel is A(r) ~ (-4 r^2 / h +
6 r - 2 h)^(1/4), whose slope is unbounded at the ends of its support,
so a last-ulp difference in a boundary pair's distance moves that
particle's velocity: over the 6 steps the two packages differed by up to
4.7e-6 m/s in velocity and 6.9e-6 m/s in velocity change, at 4 entries
each, with identical iterations and positions within 2e-6 m (two runs on
this CPU).
"""

import pytest
import torch

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

IISPH_TOL = dict(vel_atol=1e-5, state_atol=2e-5)
# scenario: (run_both arguments, merged force classes,
# check_positions_and_velocities tolerances); ``SCENARIO`` is this
# module's.
SCENARIOS = {
    "dfsph_faucet3": (
        dict(solver="dfsph", forces=(
            ("XSPHViscosity", dict(fluid_viscosity_coefficient=0.5,
                                   boundary_viscosity_coefficient=0.0)),
            ("Akinci2013SurfaceTension", dict(
                fluid_tension_coefficient=1.0,
                boundary_adhesion_coefficient=10.0)))),
        ["XSPHViscosityForce", "Akinci2013SurfaceTensionForce"],
        dict(vel_atol=1e-5, state_atol=2e-5)),
    "iisph_tension_poly6_spiky": (
        dict(solver="iisph", kernels=("poly6", "spiky"), forces=(
            ("WCSPHSurfaceTension", dict(fluid_tension_coefficient=1.0,
                                         boundary_tension_coefficient=0.5)),
            ("He2014SurfaceTension", dict(
                fluid_tension_coefficient=1.0,
                boundary_tension_coefficient=0.5)))),
        ["WCSPHSurfaceTensionForce", "He2014SurfaceTensionForce"],
        IISPH_TOL),
}


SCENARIO = "dfsph_faucet3"


def scenario_runs(name):
    args, names, tol = SCENARIOS[name]
    return dict(run_both(**args), names=names, tol=tol)


@pytest.fixture(scope="module", params=[SCENARIO])
def runs(request):
    return scenario_runs(request.param)


def test_scene_and_initial_state_match(runs):
    check_scene_and_initial_state(runs)


def test_force_set_and_layout_match(runs):
    """Both worlds merge the fluid's forces into the same configurations
    and resolve the same kernels and layout."""
    wj, wt = runs["worlds"]
    assert [type(f).__name__ for f in wt._force_set] == [
        type(f).__name__ for f in wj._force_set] == runs["names"]
    for a, b in zip(wt._force_set, wj._force_set):
        assert vars(a) == vars(b)
    assert (wt.sim.kernel_density, wt.sim.kernel_gradient) == (
        wj.sim.kernel_density, wj.sim.kernel_gradient)
    check_resolved_layout(runs)


def test_iteration_counts_identical(runs):
    check_iteration_counts(runs)


def test_contact_and_overflow_counts_exact(runs):
    check_contact_and_overflow_counts(runs)


def test_positions_and_velocities_match(runs):
    check_positions_and_velocities(runs, **runs["tol"])


def test_boundary_volumes_and_forces_match(runs):
    check_boundary_volumes_and_forces(runs)
