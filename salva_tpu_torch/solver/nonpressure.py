"""Non-pressure force framework.

Each force *type* is applied once, vectorized across all fluids:
per-fluid coefficients are stored in static tuples (one slot per fluid,
0 for fluids that don't carry the force), as in
``salva_tpu.solver.nonpressure``. For every built-in force a zero
coefficient is exactly a no-op. ``CustomForce`` is the user-extension
point's name only: its forces run on the gather layout, which is not
ported, so ``LiquidWorld.add_fluid`` refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def merge_per_fluid(instances, num_fluids: int, attr: str, default=0.0):
    """Build the per-fluid coefficient tuple for one force type.

    ``instances``: dict fluid_index -> force instance.
    """
    return tuple(
        float(getattr(instances[i], attr)) if i in instances else float(default)
        for i in range(num_fluids)
    )


@dataclasses.dataclass(frozen=True)
class ForceSet:
    """Static, hashable bundle of all merged force configurations of a
    world (``salva_tpu.solver.nonpressure.ForceSet``)."""

    forces: Tuple = ()

    def __iter__(self):
        return iter(self.forces)

    def __bool__(self):
        return bool(self.forces)


class CustomForce:
    """User-extensible non-pressure force (``salva_tpu.solver.nonpressure.
    CustomForce``, the reference's ``NonPressureForce`` trait,
    `nonpressure_force.rs:10-30`): subclass and implement ``apply(ctx)``
    over the gather layout's step context. That layout is not ported, so
    a fluid carrying one is refused."""

    def apply(self, ctx):
        raise NotImplementedError
