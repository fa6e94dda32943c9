"""Multi-device execution: slab decomposition of the dense grid
(``domain``; port of ``salva_tpu.parallel.domain`` with replicated
binning), on ``torch.distributed`` ranks or on threads of one process."""

from .domain import (
    DistributedHalo,
    DistributedHalos,
    Halo,
    LocalHalo,
    LocalHalos,
    build_sharded_step_fn,
    get_sharded_step_fn,
    pad_spec_for_devices,
)

__all__ = [
    "DistributedHalo",
    "DistributedHalos",
    "Halo",
    "LocalHalo",
    "LocalHalos",
    "build_sharded_step_fn",
    "get_sharded_step_fn",
    "pad_spec_for_devices",
]
