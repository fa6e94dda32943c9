"""salva_tpu_torch — the PyTorch + CUDA port of salva_tpu.

SPH fluid simulation (dimforge/salva's capabilities) on torch tensors,
with the four hot dense pair passes as hand-written CUDA kernels for
NVIDIA Hopper (``ops/pair.py``, ``csrc/pair_passes.cu``), and the
binning's expansion (``csrc/expand.cu``). The module
layout and names follow ``salva_tpu``, the JAX package this port is held
against.

Ported: 3D/2D DFSPH and IISPH on the dense layout (with sparse or
full-grid boundary binning, over a static ``domain``), the brute
all-pairs tier and the gather layout (Morton grid, [N, K] neighbour
tables; every world without a domain), with the seven non-pressure forces
and ``CustomForce``; ``LiquidWorld`` with its emitters, deletion, adaptive
CFL substepping, debug checks, ``z_sort`` and particle queries; rigid-body
coupling (``coupling``), the analytic shapes and triangle meshes
(``shapes``: ``TriMesh`` through its voxelized ``VoxelSdf``), their
sampling (``sampling``; the native mesh sampler, ``native``), ``.npz``
checkpoints that load in either package (``io``), the renderer (``viz``),
the reference scenes (``scenes``) and a scene runner
(``python -m salva_tpu_torch.run_scene``) — on a CUDA device (the default)
or on the CPU when asked (``device="cpu"``). Not ported: the multi-chip
slab decomposition (see ``ROADMAP.md``).

This package imports torch and numpy only; the CUDA kernels and the
mesh sampler's C++ build at their first use, never at import.
"""

from .config import DFSPHConfig, IISPHConfig, NeighborConfig, SimConfig, particle_volume
from .object import (
    ALL,
    NONE,
    BoundariesState,
    FluidsState,
    InteractionGroups,
    group,
    state_from_numpy,
    state_to_numpy,
)
from .step import StepDiagnostics
from .version import __version__
from .world import Boundary, Fluid, LiquidWorld
from .coupling import ColliderSampling, FluidsPipeline

__all__ = [
    "__version__",
    "SimConfig",
    "NeighborConfig",
    "DFSPHConfig",
    "IISPHConfig",
    "particle_volume",
    "FluidsState",
    "BoundariesState",
    "InteractionGroups",
    "group",
    "ALL",
    "NONE",
    "state_from_numpy",
    "state_to_numpy",
    "StepDiagnostics",
    "LiquidWorld",
    "Fluid",
    "Boundary",
    "FluidsPipeline",
    "ColliderSampling",
]
