"""salva's basic3 scene (`examples3d/basic3.rs`), from a configuration file.

A block of n^3 fluid particles (radius r, spaced 2r) rests one floor
thickness above a 5 x 5 m floor inside four walls; every collider is a
static cuboid sampled once (``ColliderSampling.static_sampling``) and
coupled through a ``FluidsPipeline``; the fluid carries the
configuration's non-pressure forces. The wall samples come from the
benchmark's own frozen sampling (``reference/walls.py``): ``build`` hands
the local samples to the port and ``wall_samples`` poses the same arrays
for the reference. The fluid lattice carries the seed's jitter. Only
``build`` imports the port.
"""

from __future__ import annotations

import numpy as np

from benchmark import parts
from benchmark.reference import walls

# y-axis rotation by 90 degrees (`examples3d/basic3.rs`: the two walls
# that close the box along z).
ROT_Y90 = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
                   np.float32)


def colliders(cfg):
    """[(half_extents, translation, rotation or None)] of basic3's five
    static cuboids: four walls, then the floor."""
    t, hw, hh = (cfg["ground_thickness"], cfg["ground_half_width"],
                 cfg["ground_half_height"])
    wall = (t, hh, hw)
    return [
        (wall, (0.0, hh, hw), ROT_Y90),
        (wall, (0.0, hh, -hw), ROT_Y90),
        (wall, (hw, hh, 0.0), None),
        (wall, (-hw, hh, 0.0), None),
        ((hw, t, hw), (0.0, 0.0, 0.0), None),
    ]


def wall_samples(cfg) -> np.ndarray:
    """All wall samples in world space, float32 [n, 3], in collider order."""
    r = cfg["particle_radius"]
    return np.concatenate([
        walls.posed(walls.cuboid_surface_samples(he, r), tr, rot)
        for he, tr, rot in colliders(cfg)])


def initial_fluid(cfg, seed) -> np.ndarray:
    """The fluid block (`examples3d/helper.rs`: n^3 particles spaced 2r,
    centred in x and z, resting one floor thickness above the floor) with
    the seed's jitter of amplitude ``cfg["jitter"]``; float32. Seed None:
    no jitter."""
    n, r = int(cfg["nparticles"]), float(cfg["particle_radius"])
    pos = walls.cube_lattice(n, r)
    pos[:, 1] += cfg["ground_thickness"] + n * r
    if seed is not None:
        pos = pos + walls.seeded_jitter(len(pos), cfg["jitter"], seed)
    return pos.astype(np.float32)


def force_scale(cfg) -> float:
    """The hydrostatic load of the resting column on one wall sample,
    rho0 |g| (2 n r) (2 r)^2, newtons: the scale of ``force_gap``."""
    r, n = float(cfg["particle_radius"]), float(cfg["nparticles"])
    g = sum(float(v) ** 2 for v in cfg["gravity"]) ** 0.5
    return float(cfg["density0"]) * g * (2 * n * r) * (2 * r) ** 2


def domain(cfg):
    """The static simulation box of basic3 (0.4 m beyond the walls, up to
    1 m above the block)."""
    t, hw = cfg["ground_thickness"], cfg["ground_half_width"]
    top = t + 2.0 * cfg["nparticles"] * cfg["particle_radius"] + 1.0
    return ((-hw - 0.4, -0.6, -hw - 0.4), (hw + 0.4, max(2.0, top), hw + 0.4))


def build(cfg, fluid_positions, device=None, layout=None,
          device_coupling=None):
    """(pipeline, fluid handle, boundary handles in collider order).

    ``layout`` / ``device_coupling`` default to the configuration's (the
    values it is run with); tests on the CPU pin them."""
    from salva_tpu_torch import forces, shapes
    from salva_tpu_torch.coupling import ColliderSampling, FluidsPipeline
    from salva_tpu_torch.world import Boundary, Fluid

    r = float(cfg["particle_radius"])
    pip = FluidsPipeline(
        r, float(cfg["smoothing_factor"]), dim=3,
        solver=parts.solver(cfg).program_solver(cfg), domain=domain(cfg),
        layout=layout or cfg["layout"], fit_grid=bool(cfg["fit_grid"]),
        device_coupling=(device_coupling if device_coupling is not None
                         else cfg["device_coupling"]),
        device=device,
    )
    world = pip.liquid_world
    fl = world.add_fluid(Fluid(
        np.asarray(fluid_positions, np.float32),
        density0=float(cfg["density0"]),
        nonpressure_forces=[getattr(forces, f["program"])(*f["args"])
                            for f in cfg["forces"]],
    ))
    body = pip.bodies.add_body("fixed")
    handles = []
    for he, tr, rot in colliders(cfg):
        co = pip.bodies.add_collider(body, shapes.Cuboid(tuple(he)), tr, rot)
        bo = world.add_boundary(Boundary(np.zeros((0, 3))))
        pip.coupling.register_coupling(bo, co, ColliderSampling.static_sampling(
            walls.cuboid_surface_samples(he, r)))
        handles.append(bo)
    return pip, fl, handles
