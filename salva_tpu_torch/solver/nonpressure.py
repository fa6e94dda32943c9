"""Non-pressure force framework.

Each force *type* is applied once, vectorized across all fluids:
per-fluid coefficients are stored in static tuples (one slot per fluid,
0 for fluids that don't carry the force) and gathered per particle
through ``fluid_id``, as in ``salva_tpu.solver.nonpressure``. For every
built-in force a zero coefficient is exactly a no-op.

On the gather layout a force is a function ``apply(ctx) -> (accel
[N, dim], boundary_force_delta [M, dim])`` of the substep's
``StepContext``. ``CustomForce`` is the user-extension point (the
reference's ``NonPressureForce`` trait); it has no dense form, so a
world carrying one runs the gather layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


def per_particle(values: Sequence[float], ctx):
    """Gather a per-fluid tuple of coefficients to per-particle values."""
    fid = ctx.fluids.fluid_id
    arr = torch.tensor(values, dtype=torch.float32, device=fid.device)
    return arr[fid.long()]


def same_fluid_mask(ctx):
    """[N, K] mask: both contact endpoints belong to the same fluid (the
    reference's ``c.i_model == c.j_model`` checks)."""
    fid = ctx.fluids.fluid_id
    return (fid[:, None] == fid[ctx.ff.j]) & ctx.ff.valid


def merge_per_fluid(instances, num_fluids: int, attr: str, default=0.0):
    """Build the per-fluid coefficient tuple for one force type.

    ``instances``: dict fluid_index -> force instance.
    """
    return tuple(
        float(getattr(instances[i], attr)) if i in instances else float(default)
        for i in range(num_fluids)
    )


class CustomForce:
    """User-extensible non-pressure force (``salva_tpu.solver.
    nonpressure.CustomForce``, the reference's ``NonPressureForce``
    trait, `nonpressure_force.rs:10-30`, used by
    ``examples3d/custom_forces3.rs:67-90``).

    Subclass and implement ``apply(ctx) -> accel [N, dim]`` (or
    ``(accel [N, dim], boundary_forces [M, dim])``) as a function of the
    gather layout's :class:`~salva_tpu_torch.solver.common.StepContext`.
    The world masks the result to the particles of the fluid the instance
    is attached to."""

    def apply(self, ctx):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class MaskedCustomForce:
    """World-internal wrapper restricting a CustomForce to its fluids
    (``fluid_flags``: one 0/1 per fluid)."""

    force: CustomForce
    fluid_flags: Tuple[int, ...]

    def apply(self, ctx):
        out = self.force.apply(ctx)
        if isinstance(out, tuple):
            accel, bforces = out
        else:
            accel = out
            bforces = torch.zeros_like(ctx.boundaries.forces)
        mask = (per_particle(self.fluid_flags, ctx)
                * ctx.fluids.alive.to(torch.float32))
        return accel * mask[:, None], bforces


@dataclasses.dataclass(frozen=True)
class ForceSet:
    """Static, hashable bundle of all merged force configurations of a
    world (``salva_tpu.solver.nonpressure.ForceSet``)."""

    forces: Tuple = ()

    def __iter__(self):
        return iter(self.forces)

    def __bool__(self):
        return bool(self.forces)
