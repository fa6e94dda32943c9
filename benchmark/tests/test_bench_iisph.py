"""The plain IISPH reference against the port on the CPU, at a small size of
the IISPH configuration, and its stages on a hand-built particle set
against their closed forms."""

import math

import numpy as np
import pytest
import torch

from benchmark import check, harness, parts
from benchmark.reference import dfsph, iisph
from benchmark.tests.test_bench_reference import CPU_LIMITS, config

NAME = "harness_basic3_n40_iisph"


@pytest.mark.parametrize("layout", ["dense", "brute"])
def test_reference_follows_three_steps_of_the_port(layout):
    """At 5^3 on the CPU, from seeded jitter, the port's first step (from
    rest) and its second and third (from warm-started pressures), on the
    grid and on the brute tier, are within rounding of the reference's
    (``CPU_LIMITS``: one float32 step against float64, as for DFSPH), with
    the same contacts and the same Jacobi iterations each step."""
    cfg = config(NAME, nparticles=5)
    scene = harness.Scene(cfg, 2 ** 31 + 11, "cpu", layout=layout,
                          device_coupling=True)
    pb = torch.as_tensor(parts.scene(cfg).wall_samples(cfg))
    solver = parts.solver(cfg)
    entries, diags = [], []
    for k in range(3):
        before = scene.state() if k else None
        harness.take_step(scene, False)
        e = dict(after=scene.state(), slots=scene.slots())
        if before is not None:
            e["before"] = before
            # The step reads carried pressures: the warm start is taken.
            assert float(before["fluid"]["pressures"].abs().max()) > 0.0
        entries.append(e)
        diags.append(scene.world.last_diagnostics)
    for e, d in zip(entries, diags):
        gaps = check.compare(cfg, scene.initial, [e], "cpu")
        for k, lim in CPU_LIMITS.items():
            assert gaps[k] <= lim, (k, gaps[k])
        st = check.reference_inputs(cfg, scene.initial, e, "cpu")
        ref = solver.reference_step(cfg, st, pb)["counts"]
        assert ref["ncontacts_ff"] == int(d.ncontacts_ff)
        assert ref["ncontacts_fb"] == int(d.ncontacts_fb)
        assert (ref["pressure_iters"], ref["divergence_iters"]) == (
            d.solver.pressure_iters, d.solver.divergence_iters)


def tetrahedron(edge):
    """A regular tetrahedron of side ``edge`` around (1, 1, 1), float32."""
    s = edge / (2.0 * math.sqrt(2.0))
    corners = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                       np.float64)
    return torch.as_tensor(1.0 + s * corners, dtype=torch.float32)


@pytest.mark.parametrize("p0", [0.0, 1.0e5])
def test_stages_on_four_particles_equal_their_closed_form(p0):
    """Four particles at the corners of a regular tetrahedron of side a,
    at rest, with no wall within h, each carrying the pressure p0. Every
    pair has the gradient g = dW/dr / r (x_i - x_j), and sum_j (x_i - x_j)
    = 4 (x_i - c) with |x_i - c|^2 = 3 a^2 / 8, so with Q = (dt m dwr a /
    rho)^2:

        rho  = m (W(0) + 3 W(a)),
        d_ii = -4 dt^2 m dwr / rho^2 (x_i - c),
        a_ii = -9 Q,
        s_i  = -15 p Q    (at equal pressures p = p0 / 2: d_ij p_j = p d_ii),
        p'   = (1 - w) p + w (rho0 - rho - s_i) / a_ii    (rho* = rho at rest),

    and the particle's error (-s_i - a_ii p') / rho0. One Jacobi update
    (``max_iter`` 1) of the reference equals them to 1e-6 relative: the
    float32 positions round the side by ~6e-8, and a and dwr enter
    squared."""
    a, rho0 = 0.06, 500.0
    prm = iisph.Params(h=0.2, mass=0.8, density0=rho0,
                       gravity=(0.0, 0.0, 0.0), dt=0.005, max_iter=1)
    pos = tetrahedron(a)
    far = torch.tensor([[5.0, 5.0, 5.0]])
    out = iisph.step(prm, pos, torch.zeros_like(pos),
                     torch.full((4,), p0), far)
    assert out["ncontacts_ff"] == 16 and out["ncontacts_fb"] == 0
    d = (pos[0] - pos[1]).double()
    a32 = float(d.norm())                      # the side the pairs see
    w0, _ = dfsph.cubic_w_dwr(torch.zeros(1, dtype=torch.float64), prm.h)
    wa, dwr = dfsph.cubic_w_dwr(torch.tensor([a32 * a32],
                                             dtype=torch.float64), prm.h)
    m, dt = prm.mass, prm.dt
    rho = m * (float(w0) + 3.0 * float(wa))
    dwr = float(dwr)
    c = pos.double().mean(0)
    dii = -4.0 * dt * dt * m * dwr / rho ** 2 * (pos.double() - c)
    q = (dt * m * dwr * a32 / rho) ** 2
    aii = -9.0 * q
    p = 0.5 * p0
    s = -15.0 * p * q
    p1 = (1.0 - prm.omega) * p + prm.omega * (rho0 - rho - s) / aii
    assert p1 > 0.0  # the update is kept
    err = (-s - aii * p1) / rho0
    rel = dict(rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out["dii"], dii, **rel)
    torch.testing.assert_close(out["aii"], torch.full((4,), aii,
                                                      dtype=torch.float64),
                               **rel)
    torch.testing.assert_close(out["pressures"].double(),
                               torch.full((4,), p1, dtype=torch.float64),
                               **rel)
    assert out["pressure_error"] == pytest.approx(err, rel=1e-6)
    assert out["pressure_iters"] == 1


def test_bfloat16_reference_fails_the_limits():
    """The reference with bfloat16 pair terms and float32 sums, in the
    program's place, reads far outside the CPU limits (the comparison can
    fail)."""
    cfg = config(NAME, nparticles=4)
    scene = harness.Scene(cfg, 3, "cpu", layout="brute", device_coupling=True)
    harness.take_step(scene, False)
    first = dict(after=scene.state(), slots=scene.slots())
    gaps = check.compare(cfg, scene.initial, [first], "cpu",
                         stepper=check.reference_stepper(torch.bfloat16,
                                                         torch.float32))
    assert gaps["pos_gap_m"] > 100 * CPU_LIMITS["pos_gap_m"]
    assert gaps["vel_gap"] > 100 * CPU_LIMITS["vel_gap"]
