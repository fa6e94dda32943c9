"""Multi-device execution (port of ``salva_tpu.parallel``): slab
decomposition of the dense grid (``domain``: replicated or sharded
binning, the dry run), on ``torch.distributed`` ranks or on threads of
one process; device meshes and particle-axis placements (``sharding``).
``python -m salva_tpu_torch.parallel <n>`` runs :func:`dryrun`."""

from .domain import (
    DistributedHalo,
    DistributedHalos,
    Halo,
    LocalHalo,
    LocalHalos,
    build_sharded_step_fn,
    dryrun,
    get_sharded_step_fn,
    pad_spec_for_devices,
    shard_interleave,
    shard_interleave_perm,
)
from .sharding import make_mesh, replicated, shard_states, state_shardings

__all__ = [
    "DistributedHalo",
    "DistributedHalos",
    "Halo",
    "LocalHalo",
    "LocalHalos",
    "build_sharded_step_fn",
    "dryrun",
    "get_sharded_step_fn",
    "make_mesh",
    "pad_spec_for_devices",
    "replicated",
    "shard_interleave",
    "shard_interleave_perm",
    "shard_states",
    "state_shardings",
]
