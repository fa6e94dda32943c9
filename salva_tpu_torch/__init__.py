"""salva_tpu_torch — the PyTorch + CUDA port of salva_tpu.

SPH fluid simulation (dimforge/salva's capabilities) on torch tensors,
with the four hot dense pair passes as hand-written CUDA kernels for
NVIDIA Hopper (``ops/pair.py``, ``csrc/pair_passes.cu``), and the
binning's expansion (``csrc/expand.cu``). The module
layout and names follow ``salva_tpu``, the JAX package this port is held
against.

Ported so far: 3D/2D DFSPH and IISPH on the dense layout (with sparse
or full-grid boundary binning, over a static ``domain``), the brute
all-pairs tier and the gather layout (Morton grid, [N, K] neighbour
tables; every world without a domain), with the seven non-pressure forces
and ``CustomForce`` — ``LiquidWorld`` with ``add_fluid`` /
``add_boundary`` / ``step``, on a CUDA device (the default) or on the
CPU when asked (``device="cpu"``). Everything else raises
``NotImplementedError`` (see ``ROADMAP.md``).

This package imports torch and numpy only; the CUDA kernels build at
their first launch, never at import.
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
