"""Checkpoint / resume.

Port of ``salva_tpu.io``, in the same ``.npz`` format, so a world saved by
either package loads in the other. The reference has no checkpointing;
its state is public SoA vectors a host can snapshot (SURVEY.md §5.4,
``fluid.rs:12-34``, ``boundary.rs:11-24``). Here the whole
``LiquidWorld`` (merged particle arrays, object records, solver scratch,
configs) round-trips through one file:

- ``meta``: a JSON document (uint8 bytes) with the configs, the user's
  dense-cap *requests* (``None`` = auto, so an auto world stays auto),
  and per object its record; non-pressure force descriptors
  (``forces.py`` dataclasses) by class name and fields. ``CustomForce``
  instances are code: they are left out with a warning naming their
  fluids, and the caller re-attaches them after :func:`load_world`;
- ``f_<field>`` / ``b_<field>``: the fluid and boundary state arrays in
  the JAX package's dtypes (float32; bool ``alive``; int32 ids; uint32
  bitmasks), ``fluid_slot_owner`` / ``boundary_slot_owner`` (int64) and
  ``solver_state`` (float32);
- ``host_state``: what the JAX format leaves out and this package reads
  back (JSON, uint8 bytes): the adaptive-timestep and check settings and
  the host-side layout state (resolved cap tier, fitted grid window, step
  count, pending deletions), so that a resumed run takes the uninterrupted
  run's steps bit for bit. The JAX package ignores it; a file without it
  loads as the JAX package loads it.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Optional

import numpy as np

from . import forces as force_specs
from .config import DFSPHConfig, IISPHConfig, NeighborConfig
from .object.interaction_groups import InteractionGroups
from .object.state import state_from_numpy, state_to_numpy
from .solver.nonpressure import CustomForce


def _force_to_json(f) -> Optional[dict]:
    if isinstance(f, CustomForce):
        return None
    return {
        "type": type(f).__name__,
        "fields": dataclasses.asdict(f),
    }


def _force_from_json(d: dict):
    cls = getattr(force_specs, d["type"])
    return cls(**d["fields"])


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)


def _host_state(world) -> dict:
    def ints(v):
        return None if v is None else [int(x) for x in v]

    return {
        "adaptive_timestep": bool(world.timestep_manager.adaptive),
        "debug_checks": bool(world.debug_checks),
        "warn_overflow": bool(world.warn_overflow),
        "overflow_check_interval": int(world.overflow_check_interval),
        "fit_grid": bool(world._fit_grid),
        "steps_taken": int(world._steps_taken),
        "overflow_alert": int(world._overflow_alert),
        "last_dt": float(world._last_dt),
        "auto_caps": ints(world._auto_caps),
        "auto_caps_capacity": ints(world._auto_caps_capacity),
        "fitted_dims": ints(world._fitted_dims),
        "fit_floor_dims": ints(world._fit_floor_dims),
        "initial_fit_done": bool(world._initial_fit_done),
        "grid_refit_count": int(world.grid_refit_count),
        "fb_cols_cache": (None if world._fb_cols_cache is None
                          else list(world._fb_cols_cache)),
        "boundary_dirty": bool(world._boundary_dirty),
        "full_bvol_stale": bool(world._full_bvol_stale),
        "pending_deletions": sorted(int(s) for s in world._pending_deletions),
    }


def _restore_host_state(world, hs: dict):
    def tup(v):
        return None if v is None else tuple(int(x) for x in v)

    world.timestep_manager.adaptive = hs["adaptive_timestep"]
    world.debug_checks = hs["debug_checks"]
    world.warn_overflow = hs["warn_overflow"]
    world.overflow_check_interval = hs["overflow_check_interval"]
    world._fit_grid = hs["fit_grid"]
    world._steps_taken = hs["steps_taken"]
    world._overflow_alert = hs["overflow_alert"]
    world._last_dt = hs["last_dt"]
    world._auto_caps = tup(hs["auto_caps"])
    world._auto_caps_capacity = tup(hs["auto_caps_capacity"])
    world._fitted_dims = tup(hs["fitted_dims"])
    world._fit_floor_dims = (None if hs["fit_floor_dims"] is None
                             else np.asarray(hs["fit_floor_dims"]))
    world._initial_fit_done = hs["initial_fit_done"]
    world.grid_refit_count = hs["grid_refit_count"]
    fbc = hs["fb_cols_cache"]
    world._fb_cols_cache = None if fbc is None else tuple(fbc)
    world._boundary_dirty = hs["boundary_dirty"]
    world._full_bvol_stale = hs["full_bvol_stale"]
    world._pending_deletions = set(hs["pending_deletions"])


def save_world(world, path: str):
    """Snapshot a LiquidWorld to ``path`` (.npz)."""
    world._sync_fluid_mirrors()
    meta = {
        "dim": world.dim,
        "particle_radius": world.particle_radius,
        "smoothing_factor": world.sim.smoothing_factor,
        "n_substeps": world.sim.n_substeps,
        "kernel_density": world.sim.kernel_density,
        "kernel_gradient": world.sim.kernel_gradient,
        "layout": world.sim.layout,
        "domain": world.sim.domain,
        "dense_cap": world._dense_cap_request,
        "dense_cap_boundary": world._dense_cap_boundary_request,
        "neighbors": dataclasses.asdict(world.sim.neighbors),
        "solver_kind": world.solver_config.kind,
        "solver": {
            k: v
            for k, v in dataclasses.asdict(world.solver_config).items()
            if k != "kind"
        },
        "fluid_records": [],
        "boundary_records": [],
    }
    dropped_custom = []
    for i, rec in enumerate(world._fluid_records):
        fs = []
        for f in rec.nonpressure_forces:
            j = _force_to_json(f)
            if j is None:
                dropped_custom.append(i)
            else:
                fs.append(j)
        meta["fluid_records"].append(
            {
                "density0": rec.density0,
                # The per-fluid radius sets the particles' volumes and
                # masses (`fluid.rs:22,110-120`): it must round-trip.
                "particle_radius": rec.particle_radius,
                "memberships": rec.groups.memberships,
                "filter": rec.groups.filter,
                "removed": rec.removed,
                "forces": fs,
            }
        )
    for rec in world._boundary_records:
        meta["boundary_records"].append(
            {
                "memberships": rec.groups.memberships,
                "filter": rec.groups.filter,
                "removed": rec.removed,
            }
        )
    if dropped_custom:
        warnings.warn(
            "CustomForce instances on fluids "
            f"{sorted(set(dropped_custom))} are not serialized; re-attach "
            "them after load_world."
        )

    arrays = {"meta": _json_bytes(meta)}
    for prefix, state in (("f", world.fluids_state),
                          ("b", world.boundaries_state)):
        for name, val in state_to_numpy(state).items():
            arrays[f"{prefix}_{name}"] = val
    arrays["fluid_slot_owner"] = np.asarray(world._fluid_slot_owner,
                                            np.int64)
    arrays["boundary_slot_owner"] = np.asarray(world._boundary_slot_owner,
                                               np.int64)
    if world._solver_state is not None:
        arrays["solver_state"] = state_to_numpy(world._solver_state)
    arrays["host_state"] = _json_bytes(_host_state(world))
    np.savez(path, **arrays)


def load_world(path: str, device=None):
    """Restore a LiquidWorld snapshot saved by :func:`save_world` (of
    either package) on ``device`` (``None``: the card, as for
    ``LiquidWorld``; CPU callers pass ``"cpu"``)."""
    from .world import LiquidWorld, _BoundaryRecord, _FluidRecord

    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())

    if meta["solver_kind"] == "dfsph":
        solver = DFSPHConfig(**meta["solver"])
    else:
        solver = IISPHConfig(**meta["solver"])
    world = LiquidWorld(
        solver=solver,
        particle_radius=meta["particle_radius"],
        smoothing_factor=meta["smoothing_factor"],
        dim=meta["dim"],
        neighbors=NeighborConfig(**meta["neighbors"]),
        n_substeps=meta["n_substeps"],
        layout=meta.get("layout", "auto"),
        domain=meta.get("domain"),
        dense_cap=meta.get("dense_cap"),
        dense_cap_boundary=meta.get("dense_cap_boundary"),
        device=device,
    )
    world.sim = world.sim.replace(
        kernel_density=meta["kernel_density"],
        kernel_gradient=meta["kernel_gradient"],
    )

    world._fluid_records = [
        _FluidRecord(
            density0=r["density0"],
            groups=InteractionGroups(r["memberships"], r["filter"]),
            nonpressure_forces=[_force_from_json(f) for f in r["forces"]],
            # Older snapshots predate per-fluid radii: fall back to the
            # world radius rather than a zero-volume 0.0 default.
            particle_radius=r.get(
                "particle_radius", meta["particle_radius"]
            ),
            removed=r["removed"],
        )
        for r in meta["fluid_records"]
    ]
    world._boundary_records = [
        _BoundaryRecord(
            groups=InteractionGroups(r["memberships"], r["filter"]),
            removed=r["removed"],
        )
        for r in meta["boundary_records"]
    ]

    for prefix, attr in (("f", "fluids_state"), ("b", "boundaries_state")):
        names = [f.name for f in dataclasses.fields(getattr(world, attr))]
        setattr(world, attr, state_from_numpy(
            {n: data[f"{prefix}_{n}"] for n in names}, device=world.device))

    world._fluid_slot_owner = np.asarray(data["fluid_slot_owner"], np.int64)
    world._fluid_alive = world.fluids_state.alive.cpu().numpy().copy()
    world._boundary_slot_owner = np.asarray(data["boundary_slot_owner"],
                                            np.int64)
    world._boundary_alive = world.boundaries_state.alive.cpu().numpy().copy()
    if "solver_state" in data:
        world._solver_state = state_from_numpy(data["solver_state"],
                                               device=world.device)
    if any(world._has_elasticity(i)
           for i, rec in enumerate(world._fluid_records) if not rec.removed):
        world._elasticity_dirty = True
    if "host_state" in data:
        _restore_host_state(
            world, json.loads(bytes(data["host_state"]).decode()))
    return world

