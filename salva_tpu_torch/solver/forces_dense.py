"""Dense-layout non-pressure forces: only the conversion of the empty
force set is ported (the main-path dam break attaches none)."""

from __future__ import annotations

from typing import Tuple


def to_dense_forces(force_set) -> Tuple:
    """Convert a ForceSet to dense force objects. The empty set converts
    to ``()``; any force raises, since no dense force is ported yet."""
    forces = tuple(force_set)
    if forces:
        names = ", ".join(type(f).__name__ for f in forces)
        raise NotImplementedError(
            f"non-pressure forces are not ported to salva_tpu_torch yet: "
            f"{names}"
        )
    return ()
