"""Device meshes and particle-axis placements (port of
``salva_tpu.parallel.sharding``) on ``torch.distributed.device_mesh`` and
DTensor placements.

``make_mesh`` builds a 1-D mesh over the ranks of the initialised process
group; ``state_shardings`` gives each tensor of a state its placement
(the leading, particle axis cut into one contiguous block a rank:
``Shard(0)``; a scalar ``Replicate()``), and ``shard_states`` places the
states so. A rank's ``to_local()`` block of a placed state is what the
sharded-binning step takes under ``DistributedHalos``
(``domain.build_sharded_step_fn(..., sharded_binning=True)``).

The JAX package also runs its whole single-device step on states placed
so, and XLA's SPMD partitioner (GSPMD) inserts the collectives. PyTorch
has no such partitioner: the placements here are the API's counterpart,
and the slab path (``domain``) is how the port runs on several ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..object.state import map_state


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "p"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the first
    ``n_devices`` ranks (all of them when None) of the default process
    group, which the caller has initialised: on the card for NCCL, on the
    CPU otherwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(init_process_group)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices asked, {world} ranks "
                         "in the process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n),
                      mesh_dim_names=(axis_name,))


def replicated(mesh):
    """The placement of a tensor held whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def _leaf_placement(leaf):
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0),) if leaf.ndim >= 1 else (Replicate(),)


def _check_axis(mesh, axis_name: str):
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names}, not "
                         f"({axis_name!r},)")


def state_shardings(mesh, tree, axis_name: str = "p"):
    """``tree`` (a fluids or boundaries state, or a solver-state tensor)
    with each tensor replaced by its placements on ``mesh``: the leading
    (particle) axis sharded, a scalar replicated."""
    _check_axis(mesh, axis_name)
    return map_state(_leaf_placement, tree)


def shard_states(mesh, *trees, axis_name: str = "p"):
    """Each state with its tensors distributed on ``mesh``
    (``distribute_tensor``, rank 0's data) under
    :func:`state_shardings`' placements. Returns the placed states (the
    state itself for one argument)."""
    from torch.distributed.tensor import distribute_tensor

    _check_axis(mesh, axis_name)
    placed = tuple(
        map_state(lambda a: distribute_tensor(a, mesh, _leaf_placement(a)),
                  t)
        for t in trees)
    return placed[0] if len(placed) == 1 else placed
