"""Headless scene library: every reference example scene, rebuilt.

Port of ``salva_tpu.scenes``. The reference ships 11 example scenes
driven by a bevy testbed or the headless harness (SURVEY.md §2.2). Each
scene here is a builder returning a :class:`Scene` — a ``FluidsPipeline``
plus metadata and an optional per-step callback — runnable headless via
:func:`run`, at the JAX package's published sizes. Every builder takes
``device=None``: the card (raising without one), or ``device="cpu"``.

Scene inventory and reference sources:

- ``basic2``   (`examples2d/basic2.rs`):   3 fluids (2 elastic + 1 viscous)
  over a cosine heightfield, 3 coupled dynamic bodies (box/ball/capsule).
- ``basic3``   (`examples3d/basic3.rs`):   3D dam break in a box of
  static-sampled cuboid walls, artificial viscosity.
- ``layers2``  (`examples2d/layers2.rs`):  multiphase interaction groups.
- ``surface_tension2/3`` (`examples2d/surface_tension2.rs`,
  `examples3d/surface_tension3.rs`): droplet with Akinci2013 tension.
- ``elasticity2/3`` (`examples2d/elasticity2.rs`,
  `examples3d/elasticity3.rs`): two elastic blocks falling on the ground.
- ``custom_forces2/3`` (`examples3d/custom_forces3.rs`): user-defined
  NonPressureForce pulling particles toward two attractors, zero gravity.
- ``faucet3``  (`examples3d/faucet3.rs`):  emitter + deletion below y=-2.
- ``heightfield3`` (`examples3d/heightfield3.rs`): fluid block launched at
  a sin/cos heightfield.
- ``harness_basic3`` (`examples3d/harness_basic3.rs`): the headless
  benchmark configuration (same physics as basic3, size parameterized).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import forces, shapes
from .config import NeighborConfig
from .coupling import ColliderSampling, FluidsPipeline
from .object.interaction_groups import InteractionGroups, group
from .sampling import shape_surface_sample
from .solver.nonpressure import CustomForce
from .world import Boundary, Fluid


@dataclasses.dataclass
class Scene:
    name: str
    pipeline: FluidsPipeline
    gravity: tuple
    dt: float = 1.0 / 200.0
    fluid_handles: List[int] = dataclasses.field(default_factory=list)
    # Called as callback(scene, step_index, time) before each step.
    callback: Optional[Callable] = None

    @property
    def world(self):
        return self.pipeline.liquid_world

    def step(self):
        self.pipeline.step(self.gravity, self.dt)


def run(scene: Scene, steps: int) -> Scene:
    """Drive a scene headless (the `FluidsHarnessPlugin` role,
    `harness_plugin.rs:42-70`)."""
    for i in range(steps):
        if scene.callback is not None:
            scene.callback(scene, i, i * scene.dt)
        scene.step()
    return scene


# -- shared helpers ----------------------------------------------------------


def cube_fluid(counts, particle_radius: float) -> np.ndarray:
    """Centered grid of particles spaced 2r (`examples3d/helper.rs`)."""
    counts = tuple(counts)
    axes = [
        (np.arange(n, dtype=np.float32) * 2.0 + 1.0) * particle_radius
        - n * particle_radius
        for n in counts
    ]
    return (
        np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        .reshape(-1, len(counts))
        .astype(np.float32)
    )


def _cos_heightfield_2d(nsubdivs=50, size_x=10.0, wall_height=20.0):
    """The basic2/layers2 ground: cos(x)·0.5 with raised edge walls
    (`examples2d/basic2.rs:79-89`)."""
    xs = np.arange(nsubdivs + 1, dtype=np.float32) * size_x / nsubdivs
    hs = np.cos(xs) * 0.5
    hs[0] = wall_height
    hs[-1] = wall_height
    return shapes.Heightfield(
        heights=tuple(float(v) for v in hs),
        extent=(size_x,),
        shape=(nsubdivs + 1,),
    )


def _sincos_heightfield_3d(nsubdivs=40, size=12.0, wall_height=3.0):
    """The heightfield3 ground: sin(x)+cos(z) with raised borders
    (`examples3d/heightfield3.rs:46-61`)."""
    hs = np.zeros((nsubdivs + 1, nsubdivs + 1), np.float32)
    for i in range(nsubdivs + 1):
        for j in range(nsubdivs + 1):
            if i in (0, nsubdivs) or j in (0, nsubdivs):
                hs[i, j] = wall_height
            else:
                x = i * size / nsubdivs
                z = j * size / nsubdivs
                hs[i, j] = np.sin(x) + np.cos(z)
    return shapes.Heightfield(
        heights=tuple(float(v) for v in hs.ravel()),
        extent=(size, size),
        shape=(nsubdivs + 1, nsubdivs + 1),
    )


def _register_static(pipeline, body, shape, particle_radius,
                     local_translation=None, local_rotation=None,
                     sample_radius=None):
    """Add a collider + boundary + static-sampled coupling (the
    `build_rigid_body_with_coupling` pattern, `basic2.rs:108-126`)."""
    dim = pipeline.liquid_world.dim
    co = pipeline.bodies.add_collider(
        body, shape, local_translation, local_rotation
    )
    bo = pipeline.liquid_world.add_boundary(Boundary(np.zeros((0, dim))))
    samples = shape_surface_sample(
        shape, sample_radius or particle_radius, dim
    )
    pipeline.coupling.register_coupling(
        bo, co, ColliderSampling.static_sampling(samples)
    )
    return co, bo


def _register_dynamic_sampling(pipeline, body, shape,
                               local_translation=None, max_samples=4096):
    dim = pipeline.liquid_world.dim
    co = pipeline.bodies.add_collider(body, shape, local_translation)
    bo = pipeline.liquid_world.add_boundary(Boundary(np.zeros((0, dim))))
    pipeline.coupling.register_coupling(
        bo, co, ColliderSampling.dynamic_contact_sampling(max_samples)
    )
    return co, bo


# -- scenes ------------------------------------------------------------------


def basic3(nparticles: int = 15, particle_radius: float = 0.05,
           neighbors: Optional[NeighborConfig] = None, device=None) -> Scene:
    """3D dam break in a static-sampled box (`examples3d/basic3.rs`)."""
    ground_thickness, ground_half_width, ground_half_height = 0.2, 2.5, 0.7
    top = ground_thickness + 2.0 * nparticles * particle_radius + 1.0
    domain = (
        (-ground_half_width - 0.4, -0.6, -ground_half_width - 0.4),
        (ground_half_width + 0.4, max(2.0, top), ground_half_width + 0.4),
    )
    # The dam traverses most of this small box (~23k cells), so a
    # fluid-tracking window would end up ~= the domain: no fitting.
    pip = FluidsPipeline(particle_radius, 2.0, dim=3, neighbors=neighbors,
                         domain=domain, fit_grid=False, device=device)

    pos = cube_fluid((nparticles,) * 3, particle_radius)
    pos[:, 1] += ground_thickness + nparticles * particle_radius
    fl = pip.liquid_world.add_fluid(
        Fluid(pos, density0=1000.0,
              nonpressure_forces=[forces.ArtificialViscosity(1.0, 0.0)])
    )

    ground = pip.bodies.add_body("fixed")
    ground_shape = shapes.Cuboid(
        (ground_half_width, ground_thickness, ground_half_width)
    )
    wall_shape = shapes.Cuboid(
        (ground_thickness, ground_half_height, ground_half_width)
    )
    rot_y90 = np.array(
        [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], np.float32
    )
    wall_poses = [
        ((0.0, ground_half_height, ground_half_width), rot_y90),
        ((0.0, ground_half_height, -ground_half_width), rot_y90),
        ((ground_half_width, ground_half_height, 0.0), None),
        ((-ground_half_width, ground_half_height, 0.0), None),
    ]
    for tr, rot in wall_poses:
        _register_static(pip, ground, wall_shape, particle_radius, tr, rot)
    _register_static(pip, ground, ground_shape, particle_radius)

    return Scene("basic3", pip, (0.0, -9.81, 0.0), fluid_handles=[fl])


def _basic_or_layers_2d(name: str, grouped: bool, device=None) -> Scene:
    """Shared body of basic2 / layers2 (`examples2d/basic2.rs`,
    `examples2d/layers2.rs` — identical geometry, different groups)."""
    r = 0.1
    # Static domain box -> the dense fast path (elasticity runs on it via
    # its static rest topology; see forces_dense.ParticleWiseForce).
    pip = FluidsPipeline(r, 2.0, dim=2, domain=((-4.0, -1.5), (4.0, 12.0)),
                         device=device)
    ni, nj = 25, 15
    shift2 = nj * r * 2.0

    pts1, pts2, pts3 = [], [], []
    for i in range(ni // 2):
        for j in range(nj):
            x = i * r * 2.0 - ni * r
            y = (j + 1.0) * r * 2.0 + 0.5
            pts1.append((x, y))
            pts2.append((x + ni * r, y))
    for i in range(ni):
        for j in range(nj * 2):
            x = i * r * 2.0 - ni * r
            y = (j + 1.0) * r * 2.0 + 0.5
            pts3.append((x, y + shift2))

    g1 = InteractionGroups(group(1), group(1)) if grouped else InteractionGroups()
    g2 = InteractionGroups(group(2), group(2)) if grouped else InteractionGroups()

    handles = []
    for pts, groups_, np_forces in (
        (pts1, g1, [forces.Becker2009Elasticity(1_000.0, 0.3, True),
                    forces.XSPHViscosity(0.5, 1.0)]),
        (pts2, g2, [forces.Becker2009Elasticity(1_000.0, 0.3, True),
                    forces.XSPHViscosity(0.5, 1.0)]),
        (pts3, g2, [forces.ArtificialViscosity(0.5, 0.0)]),
    ):
        handles.append(
            pip.liquid_world.add_fluid(
                Fluid(np.asarray(pts, np.float32), density0=1.0,
                      nonpressure_forces=np_forces,
                      interaction_groups=groups_)
            )
        )

    ground = pip.bodies.add_body("fixed")
    _register_dynamic_sampling(pip, ground, _cos_heightfield_2d())

    # Three coupled dynamic bodies (`basic2.rs:105-131`).
    rad = 0.4
    for (x, y), shape in (
        ((0.0, 10.0), shapes.Cuboid((rad, rad))),
        ((-2.0, 10.0), shapes.Ball(rad)),
        ((2.0, 10.5), shapes.Capsule(rad, rad)),
    ):
        b = pip.bodies.add_body("dynamic", translation=(x, y))
        _register_static(pip, b, shape, r)
        pip.bodies.bodies[b].mass *= 0.8 / 1000.0  # density 0.8
        pip.bodies.bodies[b].inertia *= 0.8 / 1000.0

    return Scene(name, pip, (0.0, -9.81), fluid_handles=handles)


def basic2(device=None) -> Scene:
    return _basic_or_layers_2d("basic2", grouped=False, device=device)


def layers2(device=None) -> Scene:
    """Multiphase with interaction groups (`examples2d/layers2.rs:54-89`)."""
    return _basic_or_layers_2d("layers2", grouped=True, device=device)


def surface_tension2(device=None) -> Scene:
    """2D droplet (`examples2d/surface_tension2.rs`)."""
    r = 0.0025
    pip = FluidsPipeline(r, 2.0, dim=2, device=device)
    pos = cube_fluid((20, 20), r)
    pos[:, 1] += 0.08
    fl = pip.liquid_world.add_fluid(
        Fluid(pos, density0=1000.0, nonpressure_forces=[
            forces.Akinci2013SurfaceTension(1.0, 0.0),
            forces.ArtificialViscosity(0.01, 0.0),
        ])
    )
    ground = pip.bodies.add_body("fixed")
    _register_dynamic_sampling(pip, ground, shapes.Cuboid((0.15, 0.02)))
    return Scene("surface_tension2", pip, (0.0, -0.981), fluid_handles=[fl])


def surface_tension3(device=None) -> Scene:
    """3D droplet (`examples3d/surface_tension3.rs:39-60`)."""
    r = 0.005
    # The droplet falls through most of this small box (~28k cells): a
    # fitted window would end ~= the domain.
    pip = FluidsPipeline(
        r, 2.0, dim=3,
        domain=((-0.3, -0.1, -0.3), (0.3, 0.3, 0.3)),
        fit_grid=False, device=device,
    )
    pos = cube_fluid((7, 7, 7), r)
    pos[:, 1] += 0.08
    fl = pip.liquid_world.add_fluid(
        Fluid(pos, density0=1000.0, nonpressure_forces=[
            forces.Akinci2013SurfaceTension(1.0, 0.0),
            forces.ArtificialViscosity(0.01, 0.01),
        ])
    )
    ground = pip.bodies.add_body("fixed")
    _register_static(pip, ground, shapes.Cuboid((0.15, 0.02, 0.15)), r)
    return Scene("surface_tension3", pip, (0.0, -9.81, 0.0), fluid_handles=[fl])


def elasticity2(device=None) -> Scene:
    """Two elastic blocks, 2D (`examples2d/elasticity2.rs`)."""
    r = 0.1
    pip = FluidsPipeline(r, 2.0, dim=2, domain=((-4.0, -1.5), (4.0, 9.0)),
                         device=device)
    ground_thickness, ground_half_width = 0.2, 3.0
    height = 0.4
    nx, ny = 25, 15
    handles = []
    for young, lift in ((500_000.0, 1.0), (100_000.0, 4.0)):
        pos = cube_fluid((nx, ny), r)
        pos[:, 1] += ground_thickness + r * ny * lift + height
        handles.append(
            pip.liquid_world.add_fluid(
                Fluid(pos, density0=1000.0, nonpressure_forces=[
                    forces.Becker2009Elasticity(young, 0.3, True),
                    forces.XSPHViscosity(0.5, 1.0),
                ])
            )
        )
    ground = pip.bodies.add_body("fixed")
    _register_dynamic_sampling(
        pip, ground, shapes.Cuboid((ground_half_width, ground_thickness))
    )
    return Scene("elasticity2", pip, (0.0, -9.81), fluid_handles=handles)


def elasticity3(device=None) -> Scene:
    """Two elastic blocks, 3D (`examples3d/elasticity3.rs:42-90`)."""
    r = 0.05
    pip = FluidsPipeline(
        r, 2.0, dim=3, domain=((-2.0, -0.5, -2.0), (2.0, 3.2, 2.0)),
        device=device,
    )
    ground_thickness, ground_half_width = 0.2, 1.5
    height, n = 0.4, 6
    handles = []
    for young, lift in ((500_000.0, 1.0), (100_000.0, 4.0)):
        pos = cube_fluid((n * 2, n, n * 2), r)
        pos[:, 1] += ground_thickness + r * n * lift + height
        handles.append(
            pip.liquid_world.add_fluid(
                Fluid(pos, density0=1000.0, nonpressure_forces=[
                    forces.Becker2009Elasticity(young, 0.3, True),
                    forces.XSPHViscosity(0.5, 1.0),
                ])
            )
        )
    ground = pip.bodies.add_body("fixed")
    _register_static(
        pip, ground,
        shapes.Cuboid((ground_half_width, ground_thickness, ground_half_width)),
        r,
    )
    return Scene("elasticity3", pip, (0.0, -9.81, 0.0), fluid_handles=handles)


class AttractorForce(CustomForce):
    """The custom force of `examples3d/custom_forces3.rs:67-90`:
    ``acc += (origin - p) / |origin - p|^2`` beyond a 0.1 dead zone."""

    def __init__(self, origin):
        self.origin = tuple(float(v) for v in origin)

    def apply(self, ctx):
        pos = ctx.fluids.positions
        d = torch.tensor(self.origin, dtype=pos.dtype, device=pos.device) - pos
        dist = torch.sqrt(torch.sum(d * d, dim=-1))
        ok = dist > 0.1
        safe = torch.where(ok, dist, 1.0)
        return torch.where(ok[:, None], d / (safe * safe)[:, None], 0.0)


def _custom_forces(dim: int, device=None) -> Scene:
    r = 0.025
    pip = FluidsPipeline(r, 2.0, dim=dim, device=device)
    n = 10
    pos = cube_fluid((n,) * dim, r)
    origin1 = (1.0, 0.0, 0.0)[:dim]
    origin2 = (-1.0, 0.0, 0.0)[:dim]
    fl = pip.liquid_world.add_fluid(
        Fluid(pos, density0=1000.0, nonpressure_forces=[
            AttractorForce(origin1), AttractorForce(origin2),
        ])
    )
    return Scene(
        f"custom_forces{dim}", pip, (0.0,) * dim, fluid_handles=[fl]
    )


def custom_forces2(device=None) -> Scene:
    return _custom_forces(2, device)


def custom_forces3(device=None) -> Scene:
    """User NonPressureForce demo (`examples3d/custom_forces3.rs`)."""
    return _custom_forces(3, device)


def faucet3(particle_radius: float = 0.0125, device=None) -> Scene:
    """Emitter + deletion (`examples3d/faucet3.rs:69-105`): a 10x10 particle
    sheet is emitted every 0.06 s at y=0.6 above a static ball; particles
    below y=-2 are deleted."""
    # Domain box sized to the fall corridor. On the card the auto layout
    # resolves to the brute tier (the reserved capacity sits at its
    # ceiling); on the CPU to the gather layout (the grid exceeds its slot
    # budget). The stream spans the full fall corridor at steady state, so
    # a fluid-tracking window would grow every few emitted sheets toward
    # the domain: no fitting.
    pip = FluidsPipeline(
        particle_radius, 2.0, dim=3,
        domain=((-1.2, -2.3, -1.2), (1.2, 0.9, 1.2)),
        fit_grid=False, device=device,
    )
    fl = pip.liquid_world.add_fluid(
        Fluid(np.zeros((0, 3), np.float32), density0=1000.0,
              nonpressure_forces=[
                  forces.XSPHViscosity(0.5, 0.0),
                  forces.Akinci2013SurfaceTension(1.0, 10.0),
              ])
    )
    ground = pip.bodies.add_body("fixed")
    _register_static(pip, ground, shapes.Ball(0.15), particle_radius)
    # Reserve the emitter's steady-state head count (100 particles per
    # 0.06 s, ~0.75 s of fall to the deletion plane): emission never
    # grows the arrays.
    pip.liquid_world.reserve_fluid_capacity(4096)

    state = {"last_t": -1.0}

    # Fixed emission template + deletion predicate: both run on the
    # device through the alive mask (`world.emit_particles` /
    # `world.delete_where`) — the callback does no per-step host fetch
    # of particle state (`faucet3.rs:69-105` emitter pattern).
    nparticles, diam = 10, particle_radius * 2.0
    shift = -nparticles * particle_radius
    ij = np.stack(
        np.meshgrid(np.arange(nparticles), np.arange(nparticles),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 2)
    template = np.stack(
        [
            ij[:, 0] * diam + shift,
            np.full(len(ij), 0.6, np.float32),
            ij[:, 1] * diam + shift,
        ],
        axis=-1,
    ).astype(np.float32)

    def _fallen(positions, velocities):
        return positions[:, 1] < -2.0

    def callback(scene, i, t):
        world = scene.world
        world.delete_where(fl, _fallen)
        # Emit a new sheet every 0.06 s.
        if t - state["last_t"] < 0.06:
            return
        state["last_t"] = t
        world.emit_particles(fl, template)

    return Scene(
        "faucet3", pip, (0.0, -9.81, 0.0), fluid_handles=[fl],
        callback=callback,
    )


def heightfield3(device=None) -> Scene:
    """Fluid block launched downward at a sin/cos heightfield
    (`examples3d/heightfield3.rs`)."""
    r = 0.1
    # The launched block splashes across the whole heightfield (~30k
    # cells): a fitted window would end near the domain.
    pip = FluidsPipeline(
        r, 2.0, dim=3,
        domain=((-6.5, -1.5, -6.5), (6.5, 5.5, 6.5)),
        fit_grid=False, device=device,
    )
    n = 14
    pos = cube_fluid((n, n, n), r)
    pos[:, 1] += 3.0
    vel = np.zeros_like(pos)
    vel[:, 1] = -10.0
    fl = pip.liquid_world.add_fluid(
        Fluid(pos, density0=1000.0, velocities=vel)
    )
    ground = pip.bodies.add_body("fixed")
    _register_static(
        pip, ground, _sincos_heightfield_3d(), r, sample_radius=r / 1.5
    )
    return Scene("heightfield3", pip, (0.0, -9.81, 0.0), fluid_handles=[fl])


def harness_basic3(nparticles: int = 15, particle_radius: float = 0.05,
                   neighbors: Optional[NeighborConfig] = None,
                   device=None) -> Scene:
    """The headless harness configuration (`examples3d/harness_basic3.rs`)
    — basic3 physics with a parameterizable particle count, used as the
    benchmark scene."""
    s = basic3(nparticles, particle_radius, neighbors, device=device)
    return dataclasses.replace(s, name="harness_basic3")


SCENES: Dict[str, Callable[[], Scene]] = {
    "basic2": basic2,
    "basic3": basic3,
    "layers2": layers2,
    "surface_tension2": surface_tension2,
    "surface_tension3": surface_tension3,
    "elasticity2": elasticity2,
    "elasticity3": elasticity3,
    "custom_forces2": custom_forces2,
    "custom_forces3": custom_forces3,
    "faucet3": faucet3,
    "heightfield3": heightfield3,
    "harness_basic3": harness_basic3,
}
