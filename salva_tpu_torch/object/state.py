"""Particle state: capacity-N struct-of-arrays dataclasses of tensors.

Port of ``salva_tpu.object.state``. All fluids of a world are merged into
ONE capacity-``N`` set (and all boundaries into one capacity-``M`` set):
object membership is a per-particle ``fluid_id`` / ``boundary_id``,
deletion flips an ``alive`` bit, and shapes change only when the world
grows a capacity.

Interaction-group bitmasks (``memberships`` / ``filter``) are u32 in the
JAX package; torch's ``uint32`` supports few operations, so they are held
as ``int64`` holding the same non-negative values — every bit test
(``&``, ``!= 0``) is exact.

``state_from_numpy`` / ``state_to_numpy`` convert to and from numpy: a
particle state as a dictionary of arrays keyed by field name, the solver
state (``[N, dim + 2]`` float32 for DFSPH) as one array. That is the form
in which a ``salva_tpu`` state (or any other producer) enters this
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_F32 = torch.float32


@dataclasses.dataclass
class FluidsState:
    """All fluid particles of a world, merged (capacity N)."""

    positions: torch.Tensor  # [N, dim] f32
    velocities: torch.Tensor  # [N, dim] f32
    volumes: torch.Tensor  # [N] f32
    density0: torch.Tensor  # [N] f32 rest density (per particle -> multiphase)
    alive: torch.Tensor  # [N] bool
    fluid_id: torch.Tensor  # [N] i32
    memberships: torch.Tensor  # [N] i64 (u32 values)
    filter: torch.Tensor  # [N] i64 (u32 values)

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    @property
    def masses(self) -> torch.Tensor:
        """Per-particle mass = volume * rest density (`fluid.rs:183-187`)."""
        return self.volumes * self.density0

    def replace(self, **kw) -> "FluidsState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def empty(cls, capacity: int, dim: int, device="cpu") -> "FluidsState":
        return cls(
            positions=torch.zeros((capacity, dim), dtype=_F32, device=device),
            velocities=torch.zeros((capacity, dim), dtype=_F32, device=device),
            volumes=torch.zeros((capacity,), dtype=_F32, device=device),
            density0=torch.ones((capacity,), dtype=_F32, device=device),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            fluid_id=torch.zeros((capacity,), dtype=torch.int32, device=device),
            memberships=torch.zeros((capacity,), dtype=torch.int64,
                                    device=device),
            filter=torch.zeros((capacity,), dtype=torch.int64, device=device),
        )


@dataclasses.dataclass
class BoundariesState:
    """All boundary particles of a world, merged (capacity M)."""

    positions: torch.Tensor  # [M, dim] f32
    velocities: torch.Tensor  # [M, dim] f32
    volumes: torch.Tensor  # [M] f32 (computed each substep: 1 / sum W)
    forces: torch.Tensor  # [M, dim] f32 force feedback accumulator
    alive: torch.Tensor  # [M] bool
    boundary_id: torch.Tensor  # [M] i32
    memberships: torch.Tensor  # [M] i64 (u32 values)
    filter: torch.Tensor  # [M] i64 (u32 values)

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def replace(self, **kw) -> "BoundariesState":
        return dataclasses.replace(self, **kw)

    def clear_forces(self) -> "BoundariesState":
        """`Boundary::clear_forces` (`boundary.rs:70-82`)."""
        return self.replace(forces=torch.zeros_like(self.forces))

    @classmethod
    def empty(cls, capacity: int, dim: int, device="cpu") -> "BoundariesState":
        return cls(
            positions=torch.zeros((capacity, dim), dtype=_F32, device=device),
            velocities=torch.zeros((capacity, dim), dtype=_F32, device=device),
            volumes=torch.zeros((capacity,), dtype=_F32, device=device),
            forces=torch.zeros((capacity, dim), dtype=_F32, device=device),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            boundary_id=torch.zeros((capacity,), dtype=torch.int32,
                                    device=device),
            memberships=torch.zeros((capacity,), dtype=torch.int64,
                                    device=device),
            filter=torch.zeros((capacity,), dtype=torch.int64, device=device),
        )


_DTYPES = {
    "positions": _F32,
    "velocities": _F32,
    "volumes": _F32,
    "density0": _F32,
    "forces": _F32,
    "alive": torch.bool,
    "fluid_id": torch.int32,
    "boundary_id": torch.int32,
    "memberships": torch.int64,
    "filter": torch.int64,
}


def state_from_numpy(fields, device="cpu"):
    """Build a ``FluidsState`` (when ``fields`` has ``fluid_id``) or a
    ``BoundariesState`` (``boundary_id``) from numpy arrays, one per
    field — u32 bitmasks widen to int64 without changing their values —
    or, given one array, the float32 solver-state tensor."""
    if isinstance(fields, np.ndarray):
        return torch.tensor(fields, dtype=_F32, device=device)
    if "fluid_id" in fields:
        cls = FluidsState
    elif "boundary_id" in fields:
        cls = BoundariesState
    else:
        raise ValueError("fields name neither fluid_id nor boundary_id")
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise ValueError(f"missing state fields: {sorted(missing)}")
    kw = {}
    for name in names:
        arr = np.asarray(fields[name])
        if name in ("memberships", "filter"):
            arr = arr.astype(np.int64)
        kw[name] = torch.tensor(arr, dtype=_DTYPES[name], device=device)
    return cls(**kw)


def state_to_numpy(state):
    """Inverse of :func:`state_from_numpy` (bitmasks come back as u32)."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    out = {}
    for f in dataclasses.fields(state):
        arr = getattr(state, f.name).detach().cpu().numpy()
        if f.name in ("memberships", "filter"):
            arr = arr.astype(np.uint32)
        out[f.name] = arr
    return out
