"""IISPH as the benchmark drives and checks it: the port's solver settings,
the state one step reads and writes, and the reference's step.

A state is ``{"fluid": {...}, "boundary": {...}}`` of tensors indexed by
slot: the fluid's positions, velocities and the pressures carried to the
next step (which halves them for its warm start, `iisph_solver.rs:673-677`;
the check hands them to the reference so that a sampled step can be
followed), the boundary particles' forces. The particles move with their
new velocities. Only ``program_solver`` imports the port.
"""

from __future__ import annotations

import torch

from benchmark import parts
from benchmark.reference import iisph


def program_solver(cfg):
    """The port's solver settings: IISPH at its defaults."""
    from salva_tpu_torch.config import IISPHConfig

    return IISPHConfig()


def state(world):
    """Clones of the state of ``world`` that one step reads and writes."""
    fl, bd = world.fluids_state, world.boundaries_state
    # The carried pressures live in the world's solver scratch, which has
    # no public accessor.
    ss = world._solver_state
    p = (ss.clone() if ss is not None
         else torch.zeros_like(fl.positions[:, 0]))
    return dict(fluid=dict(positions=fl.positions.clone(),
                           velocities=fl.velocities.clone(), pressures=p),
                boundary=dict(forces=bd.forces.clone()))


def at_rest(positions):
    """The state of a fluid placed at ``positions``, before its first step."""
    return dict(fluid=dict(positions=positions,
                           velocities=torch.zeros_like(positions),
                           pressures=torch.zeros_like(positions[:, 0])),
                boundary={})


def moved_velocity(fluid):
    """The velocity each particle moved with in the step: its new one."""
    return fluid["velocities"]


def _force(module, args):
    return lambda ctx: module.accel(ctx, *args)


def reference_step(cfg, st, walls, pair_dtype=torch.float64,
                   acc_dtype=torch.float64):
    """The reference's step from state ``st`` beside the posed ``walls``
    [nb, 3]: the state after it, with its counts under ``counts``."""
    forces = [_force(parts.reference_force(f), f["args"])
              for f in cfg["forces"]]
    fl = st["fluid"]
    out = iisph.step(iisph.Params.from_config(cfg), fl["positions"],
                     fl["velocities"], fl["pressures"], walls, forces,
                     pair_dtype, acc_dtype)
    return dict(
        fluid=dict(positions=out["positions"], velocities=out["velocities"],
                   pressures=out["pressures"]),
        boundary=dict(forces=out["boundary_forces"]),
        counts=dict(pressure_iters=out["pressure_iters"], divergence_iters=0,
                    ncontacts_ff=out["ncontacts_ff"],
                    ncontacts_fb=out["ncontacts_fb"]))
