"""Scene helpers (the main-path subset of ``salva_tpu.scenes``)."""

from __future__ import annotations

import numpy as np


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
