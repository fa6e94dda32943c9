"""Analytic shapes as signed distance fields (the main-path subset).

Port of ``salva_tpu.shapes``: only ``Cuboid``, whose surface sample is
the dam break's floor. Shapes are evaluated host-side at world
construction, on float32 numpy arrays, like the JAX package's sampling.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def _safe_norm(v):
    """|v| over the last axis (zero at v = 0)."""
    sq = np.sum(v * v, axis=-1)
    return np.where(sq > 0, np.sqrt(np.where(sq > 0, sq, 1.0)), 0.0).astype(
        v.dtype
    )


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Box with the given half-extents (dim inferred from the tuple)."""

    half_extents: Tuple[float, ...]

    def sdf(self, p):
        p = np.asarray(p)
        b = np.asarray(self.half_extents, p.dtype)
        q = np.abs(p) - b
        outside = _safe_norm(np.maximum(q, 0.0).astype(p.dtype))
        inside = np.minimum(np.max(q, axis=-1), 0.0)
        return outside + inside
