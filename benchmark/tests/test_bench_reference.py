"""The plain reference against the port on the CPU, at small sizes of each
configuration, and its parts on their own."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, parts
from benchmark.reference import dfsph, walls

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("harness_basic3_n40", "basic3_n15")
# One float32 step of the port against the float64 reference at 5^3 on the
# CPU (readings 3.0e-8 m, 6e-7 and 3.4e-6 there): rounding only.
CPU_LIMITS = dict(pos_gap_m=1e-6, vel_gap=1e-5, force_gap=1e-4)


def config(name, **kw):
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(kw)
    return cfg


def test_pairs_equal_all_pairs():
    """The cell search finds exactly the pairs within h of an all-pairs
    test in float32, near ties included."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand(300, 3, generator=g) * 0.8
    y = torch.rand(200, 3, generator=g) * 0.8
    y[:5] = x[:5] + torch.tensor([0.2, 0.0, 0.0])  # pairs at r = h
    h = 0.2
    p = dfsph.Pairs(x, y, h, block=64)
    d = x[:, None, :] - y[None, :, :]
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    want = set(map(tuple, torch.nonzero(r2 <= torch.tensor(h * h)).tolist()))
    got = set(zip(p.i.tolist(), p.j.tolist()))
    assert got == want and len(p) == len(want)


def test_cubic_kernel_integrates_to_one():
    h = 0.2
    r = torch.linspace(0, h, 20001, dtype=torch.float64)
    w, dwr = dfsph.cubic_w_dwr(r * r, h)
    integral = torch.trapezoid(w * 4 * np.pi * r * r, r)
    assert abs(float(integral) - 1.0) < 1e-6
    # dW/dr / r against a difference quotient of W.
    rr = torch.tensor([0.03, 0.09, 0.13, 0.19], dtype=torch.float64)
    e = 1e-7
    w1, _ = dfsph.cubic_w_dwr((rr + e) ** 2, h)
    w0, _ = dfsph.cubic_w_dwr((rr - e) ** 2, h)
    _, dwr = dfsph.cubic_w_dwr(rr * rr, h)
    assert torch.allclose((w1 - w0) / (2 * e) / rr, dwr, rtol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_wall_samples_equal_the_ports(name):
    """The frozen sampling gives the port's samples of each cuboid, and
    the posed samples are where the port's coupling writes them."""
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample

    cfg = config(name)
    scene_mod = parts.scene(cfg)
    for he, _, _ in scene_mod.colliders(cfg):
        mine = walls.cuboid_surface_samples(he, cfg["particle_radius"])
        port = shape_surface_sample(shapes.Cuboid(tuple(he)),
                                    cfg["particle_radius"], 3)
        np.testing.assert_array_equal(mine, port)
    scene = harness.Scene(config(name, nparticles=3), 0, "cpu",
                          layout="brute", device_coupling=True)
    scene.step()
    _, b = scene.slots()
    posed = scene.world.boundaries_state.positions[b].numpy()
    np.testing.assert_array_equal(posed, scene_mod.wall_samples(cfg))
    assert len(posed) == 13458


@pytest.mark.parametrize("name,layout", [("harness_basic3_n40", "dense"),
                                         ("basic3_n15", "brute")])
def test_reference_follows_one_step_of_the_port(name, layout):
    """At 5^3 on the CPU, the port's first step from the inputs and its
    second from its own state, on the layout the card takes at the
    configuration's size, are within rounding of the reference's."""
    cfg = config(name, nparticles=5)
    scene = harness.Scene(cfg, 2 ** 31 + 11, "cpu", layout=layout,
                          device_coupling=True)
    harness.take_step(scene, False)
    first = dict(after=scene.state(), slots=scene.slots())
    before = scene.state()
    harness.take_step(scene, False)
    second = dict(before=before, after=scene.state(), slots=scene.slots())
    gaps = check.compare(cfg, scene.initial, [first, second], "cpu")
    for k, lim in CPU_LIMITS.items():
        assert gaps[k] <= lim, (k, gaps[k])
    # The same contacts and iterations on both sides.
    pb = torch.as_tensor(parts.scene(cfg).wall_samples(cfg))
    st = check.select(before, second["slots"], "cpu")
    ref = parts.solver(cfg).reference_step(cfg, st, pb)["counts"]
    d = scene.world.last_diagnostics
    assert ref["ncontacts_ff"] == int(d.ncontacts_ff)
    assert ref["ncontacts_fb"] == int(d.ncontacts_fb)
    assert (ref["pressure_iters"], ref["divergence_iters"]) == (
        d.solver.pressure_iters, d.solver.divergence_iters)


def test_the_viscosity_is_in_the_reference():
    """Without its force the reference leaves the program's step by more
    than rounding: the force list reaches the reference's step."""
    cfg = config("basic3_n15", nparticles=4)
    scene = harness.Scene(cfg, 4, "cpu", layout="brute", device_coupling=True)
    for _ in range(6):
        before = scene.state()
        harness.take_step(scene, False)
    entry = dict(before=before, after=scene.state(), slots=scene.slots())
    gaps = check.compare(cfg, scene.initial, [entry], "cpu")
    assert gaps["vel_gap"] <= CPU_LIMITS["vel_gap"]
    bare = dict(cfg, forces=[])
    gaps = check.compare(bare, scene.initial, [entry], "cpu")
    assert gaps["vel_gap"] > 10 * CPU_LIMITS["vel_gap"]


def test_bfloat16_reference_fails_the_limits():
    """The reference with bfloat16 pair terms, in the program's place,
    reads far outside the CPU limits (the comparison can fail)."""
    cfg = config("basic3_n15", nparticles=4)
    scene = harness.Scene(cfg, 3, "cpu", layout="brute", device_coupling=True)
    harness.take_step(scene, False)
    first = dict(after=scene.state(), slots=scene.slots())
    gaps = check.compare(cfg, scene.initial, [first], "cpu",
                         stepper=check.reference_stepper(torch.bfloat16,
                                                         torch.float32))
    assert gaps["pos_gap_m"] > 100 * CPU_LIMITS["pos_gap_m"]
    assert gaps["vel_gap"] > 100 * CPU_LIMITS["vel_gap"]
