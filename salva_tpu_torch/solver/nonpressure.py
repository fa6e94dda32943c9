"""Non-pressure force bundle.

Only the container is ported: the dam break of the main path attaches no
non-pressure force, and the world refuses fluids that carry one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ForceSet:
    """Static, hashable bundle of all merged force configurations of a
    world (``salva_tpu.solver.nonpressure.ForceSet``)."""

    forces: Tuple = ()

    def __iter__(self):
        return iter(self.forces)

    def __bool__(self):
        return bool(self.forces)
