"""DFSPH as the benchmark drives and checks it: the port's solver settings,
the state one step reads and writes, and the reference's step.

A state is ``{"fluid": {...}, "boundary": {...}}`` of tensors indexed by
slot: the fluid's positions, velocities and the velocity changes ``dv``
carried to the next step (the particles move with v + dv), the boundary
particles' forces. Only ``program_solver`` imports the port.
"""

from __future__ import annotations

import torch

from benchmark import parts
from benchmark.reference import dfsph


def program_solver(cfg):
    """The port's solver settings: DFSPH at its defaults."""
    from salva_tpu_torch.config import DFSPHConfig

    return DFSPHConfig()


def state(world):
    """Clones of the state of ``world`` that one step reads and writes."""
    fl, bd = world.fluids_state, world.boundaries_state
    # The carried velocity changes live in the world's solver scratch,
    # which has no public accessor.
    ss = world._solver_state
    dv = (ss[:, :3].clone() if ss is not None
          else torch.zeros_like(fl.positions))
    return dict(fluid=dict(positions=fl.positions.clone(),
                           velocities=fl.velocities.clone(), dv=dv),
                boundary=dict(forces=bd.forces.clone()))


def at_rest(positions):
    """The state of a fluid placed at ``positions``, before its first step."""
    zero = torch.zeros_like(positions)
    return dict(fluid=dict(positions=positions, velocities=zero, dv=zero),
                boundary={})


def moved_velocity(fluid):
    """The velocity each particle moved with in the step: v + dv."""
    return fluid["velocities"] + fluid["dv"]


def _force(module, args):
    return lambda ctx: module.accel(ctx, *args)


def reference_step(cfg, st, walls, pair_dtype=torch.float64,
                   acc_dtype=torch.float64):
    """The reference's step from state ``st`` beside the posed ``walls``
    [nb, 3]: the state after it, with its counts under ``counts``."""
    forces = [_force(parts.reference_force(f), f["args"])
              for f in cfg["forces"]]
    fl = st["fluid"]
    out = dfsph.step(dfsph.Params.from_config(cfg), fl["positions"],
                     fl["velocities"], fl["dv"], walls, forces, pair_dtype,
                     acc_dtype)
    return dict(
        fluid=dict(positions=out["positions"], velocities=out["velocities"],
                   dv=out["dv"]),
        boundary=dict(forces=out["boundary_forces"]),
        counts={k: out[k] for k in ("pressure_iters", "divergence_iters",
                                    "ncontacts_ff", "ncontacts_fb")})
