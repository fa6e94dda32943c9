"""The comparison that decides ``correct``.

The reference (the configuration's ``solvers/<solver>.py`` and its
``reference/`` step) takes one step from the state the program stepped
from and is held against the state the program wrote:

- the first step of the run, from the benchmark's own inputs (the jittered
  lattice, at rest): it checks the start without any state of the
  program;
- the steps of the window's sample (drawn from the seed): from the
  program's state before the step. The reference works out the wall
  samples (the scene's), their volumes, the contacts, the densities and
  both solves again.

Three numbers are compared, each against the limit in
``limits/<workload>.json``:

- ``pos_gap_m``: the widest distance between a particle's position after
  the step in the program and in the reference (metres);
- ``vel_gap``: the widest gap of the velocity a particle moved with in the
  step, over the reference's fastest particle;
- ``force_gap``: the widest gap of a wall particle's force, over the
  scene's fixed force scale (a fixed scale: the step's own largest force
  vanishes as the fluid first presses on a wall, where float32 rounding
  of rho - rho0 leaves a large share of a tiny force).
"""

from __future__ import annotations

import math

import torch

from benchmark import parts

NUMBERS = ("pos_gap_m", "vel_gap", "force_gap")


def _gaps(out, ref, f0, solver):
    pos = float((out["fluid"]["positions"] - ref["fluid"]["positions"])
                .norm(dim=1).max())
    v_out = solver.moved_velocity(out["fluid"])
    v_ref = solver.moved_velocity(ref["fluid"])
    vel = float((v_out - v_ref).norm(dim=1).max()
                / v_ref.norm(dim=1).max())
    force = float((out["boundary"]["forces"] - ref["boundary"]["forces"])
                  .norm(dim=1).max()) / f0
    return dict(pos_gap_m=pos, vel_gap=vel, force_gap=force)


def select(st, slots, device):
    """A state's live particles, in particle and collider order."""
    f, b = slots
    return dict(fluid={k: v[f].to(device) for k, v in st["fluid"].items()},
                boundary={k: v[b].to(device)
                          for k, v in st["boundary"].items()})


def reference_inputs(cfg, initial, entry, device):
    """The state the reference steps from: the inputs for the first step
    (``entry`` without "before"), else the program's state before the
    sampled step."""
    if "before" not in entry:
        return parts.solver(cfg).at_rest(torch.as_tensor(initial,
                                                         device=device))
    return select(entry["before"], entry["slots"], device)


def compare(cfg, initial, entries, device, stepper=None):
    """The widest reading of each number over ``entries`` (the first step
    first). ``stepper(cfg, state, walls)``, when given, stands in for the
    program's recorded post-step state (the control computed in the
    program's place)."""
    solver = parts.solver(cfg)
    scene = parts.scene(cfg)
    pb = torch.as_tensor(scene.wall_samples(cfg), device=device)
    f0 = scene.force_scale(cfg)
    worst = {k: 0.0 for k in NUMBERS}
    for entry in entries:
        st = reference_inputs(cfg, initial, entry, device)
        ref = solver.reference_step(cfg, st, pb)
        if stepper is not None:
            out = stepper(cfg, st, pb)
        else:
            out = select(entry["after"], entry["slots"], device)
        g = _gaps(out, ref, f0, solver)
        for k in NUMBERS:
            # A NaN (a non-finite state) stays and fails the verdict.
            if not (math.isnan(worst[k]) or g[k] <= worst[k]):
                worst[k] = g[k]
    return worst


def reference_stepper(pair_dtype, acc_dtype):
    """The reference computed in another precision, put in the program's
    place."""
    def stepper(cfg, st, pb):
        return parts.solver(cfg).reference_step(cfg, st, pb, pair_dtype,
                                                acc_dtype)
    return stepper


def verdict(gaps, limits):
    """(correct, [(name, value, limit)]): every number within its limit."""
    rows = [(k, gaps[k], float(limits[k])) for k in NUMBERS]
    return all(v <= lim for _, v, lim in rows), rows
