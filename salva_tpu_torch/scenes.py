"""Scene helpers (the main-path subset of ``salva_tpu.scenes``): the
block of fluid particles and the custom forces scene's attractor. The
scene functions themselves wait for rigid-body coupling."""

from __future__ import annotations

import numpy as np
import torch

from .solver.nonpressure import CustomForce


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


class AttractorForce(CustomForce):
    """The custom force of `examples3d/custom_forces3.rs:67-90`
    (``salva_tpu.scenes.AttractorForce``):
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
