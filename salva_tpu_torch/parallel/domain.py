"""Slab decomposition of the dense grid with ghost-layer exchange.

Port of ``salva_tpu.parallel.domain`` with replicated binning: the dense
grid's x-axis is cut into one slab per rank; each rank bins every
particle but keeps those of its slab and of the two ghost x-layers
beside it (``dense_grid.bin_particles_slab``), runs the dense substep on
that local grid, and refreshes the ghost layers of every per-iteration
field from its neighbours (``Halo.exchange``). Convergence errors,
contact counts and overflows are summed over the ranks (``Halo.psum``),
so every rank follows the reference's global termination rule, and the
particle outputs merge by a sum in which each particle is nonzero on the
one rank that owns it (``Halo.merge_particles``).

Communication per DFSPH substep: per solver iteration, two exchanges of
a stiffness layer ``[cap, nyz]`` and two of a velocity-change layer
``[dim, cap, nyz]``; once per substep, the sums of the particle outputs
(O(N), the state itself).

Two backends, chosen by the caller:

- :class:`LocalHalos`: n slabs in one process, one Python thread per
  slab, a shared barrier at each collective. It is how the slab path runs
  on one card (NCCL refuses two ranks on one GPU), as the JAX package's
  tests run on a virtual 8-device CPU mesh.
- :class:`DistributedHalos`: one slab per ``torch.distributed`` rank
  (gloo for CPU tensors, NCCL for CUDA tensors); ghost layers move by
  paired ``isend`` / ``irecv`` (``batch_isend_irecv``).

Both take a sum as every rank's part gathered and added in rank order
(``all_gather`` on ``torch.distributed``), so a run is bitwise
repeatable and the two backends agree bitwise. Nothing falls back from
one backend to the other.

Sharded binning (``build_sharded_step_fn(..., sharded_binning=True)``):
the particle axis is cut into one block of rows a rank. Each substep a
rank sends every row to the slab that owns its x-cell and to the
neighbours whose ghost layer it fills (``_slab_targets``), in one
all-to-all (``Halo.all_to_all``, ``_route_out``); bins only the rows it
received; and sends each row's result back from its owner
(``_route_back``). The received blocks keep their senders' row order, so
every cell's ranks, and so the grids, are bitwise the replicated path's.
The particle-wise forces (the elasticity, whose rest topology is fixed
in row space) are evaluated on the home rows before the migration and
their acceleration travels with the rows (``a_pw``). A row's fields move
as one row of bytes, so each direction is one collective for the fluid
and one for the boundary.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..object.state import map_state, state_from_leaves, state_leaves

# Seconds a LocalHalos rank waits at a collective before the run raises.
BARRIER_TIMEOUT_S = 60.0


class Halo:
    """Ghost-layer exchange and collectives for one slab (``salva_tpu``'s
    ``Halo``): rank ``rank`` of ``n_dev`` owns x-layers ``[x0, x0 + nxl)``.

    Local grid arrays are ``[..., cap, C_local]`` with
    ``C_local = (nxl + 2) * nyz``; layers 0 and ``nxl + 1`` are the ghost
    layers mirroring the neighbours' border layers. Subclasses move the
    data (:meth:`_shift`, :meth:`_gather`)."""

    def __init__(self, n_dev: int, rank: int, nxl: int, nyz: int,
                 migrate: bool = False):
        self.n_dev = n_dev
        self.rank = rank
        self.nxl = nxl
        self.nyz = nyz
        # Sharded binning: the particle arrays are this rank's migrated
        # rows, not the replicated set (see merge_particles).
        self.migrate = migrate

    @property
    def x0(self) -> int:
        """First owned global x-layer of this slab."""
        return self.rank * self.nxl

    def exchange(self, arr):
        """Refresh both ghost layers of ``[..., cap, C_local]`` from the
        neighbouring slabs' border (first / last interior) layers. A ghost
        layer with no neighbour gets zeros: the domain's own ghost ring is
        empty."""
        if self.n_dev == 1:
            return arr
        shape = arr.shape
        a = arr.reshape(shape[:-1] + (self.nxl + 2, self.nyz))
        # My LAST interior layer becomes my right neighbour's left ghost
        # (layer 0); my FIRST my left neighbour's right ghost.
        dense = torch.contiguous_format
        from_left, from_right = self._shift(
            a[..., self.nxl, :].clone(memory_format=dense),
            a[..., 1, :].clone(memory_format=dense))
        out = a.clone()
        out[..., 0, :] = from_left
        out[..., self.nxl + 1, :] = from_right
        return out.reshape(shape)

    def psum(self, x):
        """The sum of ``x`` over the ranks, taken in rank order (so a run
        is bitwise repeatable, and the backends agree bitwise)."""
        parts = self._gather(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def pmax(self, x):
        """The elementwise max of ``x`` over the ranks."""
        parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out

    def all_to_all(self, buf):
        """``jax.lax.all_to_all(buf, split_axis=0, concat_axis=0,
        tiled=True)``: ``buf`` is ``n_dev`` equal blocks of rows, block t
        for rank t; returns the blocks this rank was sent, in the senders'
        rank order."""
        raise NotImplementedError

    def merge_particles(self, values, covered, fallback):
        """Combine the ranks' unbinned particle arrays: each particle is
        interior on exactly one rank (``covered``) and the others give
        zeros; a particle no rank covers keeps ``fallback``. With
        ``migrate`` the arrays are this rank's received rows: a local
        select (the route back picks each row's owner)."""
        if self.migrate:
            cov = covered[:, None] if values.ndim == 2 else covered
            return torch.where(cov, values, fallback)
        total = self.psum(values)
        cov = self.psum(covered.to(torch.float32)) > 0
        if values.ndim == 2:
            cov = cov[:, None]
        return torch.where(cov, total, fallback)

    def _shift(self, last, first):
        """(the left neighbour's ``last``, the right neighbour's
        ``first``), zeros where there is no neighbour."""
        raise NotImplementedError

    def _gather(self, x):
        """Every rank's tensor ``x``, in rank order."""
        raise NotImplementedError


class _LocalGroup:
    """What the threads of one :class:`LocalHalos` run share: a barrier
    and two banks of one slot per rank (a collective posts into one bank
    while a slower rank may still read the previous collective's)."""

    def __init__(self, n_dev: int, timeout: float):
        self.barrier = threading.Barrier(n_dev, timeout=timeout)
        self.banks = ([None] * n_dev, [None] * n_dev)


class LocalHalo(Halo):
    """One slab of a :class:`LocalHalos` run (one thread of it)."""

    def __init__(self, group: _LocalGroup, n_dev, rank, nxl, nyz,
                 migrate=False):
        super().__init__(n_dev, rank, nxl, nyz, migrate)
        self._group = group
        self._calls = 0

    def _post(self, value):
        """Post ``value``, wait for every rank's, return the bank. A
        barrier that times out or is aborted raises in every thread."""
        bank = self._group.banks[self._calls % 2]
        self._calls += 1
        bank[self.rank] = value
        self._group.barrier.wait()
        return bank

    def _shift(self, last, first):
        bank = self._post((last, first))
        r, n = self.rank, self.n_dev
        from_left = bank[r - 1][0] if r > 0 else torch.zeros_like(last)
        from_right = bank[r + 1][1] if r < n - 1 else torch.zeros_like(first)
        return from_left, from_right

    def _gather(self, x):
        return list(self._post(torch.as_tensor(x)))

    def all_to_all(self, buf):
        bank = self._post(buf)
        blk = buf.shape[0] // self.n_dev
        r = self.rank
        return torch.cat([part[r * blk:(r + 1) * blk] for part in bank])


class LocalHalos:
    """The in-process backend: ``n_dev`` slabs, one thread each, in this
    process. A rank that waits BARRIER_TIMEOUT_S seconds at a collective
    for the others raises, and so does every other rank."""

    # The caller hands a step the whole particle state (every rank's
    # rows), and gets the whole state back.
    in_process = True

    def __init__(self, n_dev: int):
        if n_dev < 1:
            raise ValueError(f"LocalHalos: n_dev must be >= 1, got {n_dev}")
        self.n_dev = n_dev

    def run(self, nxl: int, nyz: int, fn, migrate: bool = False):
        """``fn(halo)`` on every slab, each in its own thread; returns the
        results in rank order. If a rank raises, the barrier is aborted
        (the others raise at their next collective) and the first error
        is raised here."""
        group = _LocalGroup(self.n_dev, BARRIER_TIMEOUT_S)
        results = [None] * self.n_dev
        errors = [None] * self.n_dev

        def body(rank):
            try:
                results[rank] = fn(LocalHalo(group, self.n_dev, rank, nxl,
                                             nyz, migrate))
            except BaseException as e:  # re-raised below, in the caller
                errors[rank] = e
                group.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,),
                                    name=f"slab-{r}")
                   for r in range(self.n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # A rank's own error first; the others' broken barriers follow it.
        failed = [e for e in errors if e is not None]
        if failed:
            first = next((e for e in failed
                          if not isinstance(e, threading.BrokenBarrierError)),
                         failed[0])
            raise first
        return results


class DistributedHalo(Halo):
    """This process's slab of a :class:`DistributedHalos` run."""

    def __init__(self, group, n_dev, rank, nxl, nyz, migrate=False):
        super().__init__(n_dev, rank, nxl, nyz, migrate)
        self._group = group

    def _peer(self, rank):
        import torch.distributed as dist

        if self._group is None:
            return rank
        return dist.get_global_rank(self._group, rank)

    def _shift(self, last, first):
        import torch.distributed as dist

        from_left = torch.zeros_like(last)
        from_right = torch.zeros_like(first)
        ops = []
        if self.rank + 1 < self.n_dev:
            right = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, last, right, self._group),
                    dist.P2POp(dist.irecv, from_right, right, self._group)]
        if self.rank > 0:
            left = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, first, left, self._group),
                    dist.P2POp(dist.irecv, from_left, left, self._group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_left, from_right

    def _gather(self, x):
        import torch.distributed as dist

        x = torch.as_tensor(x)
        flat = x.reshape(-1).contiguous()
        parts = [torch.empty_like(flat) for _ in range(self.n_dev)]
        dist.all_gather(parts, flat, group=self._group)
        return [p.reshape(x.shape) for p in parts]

    def all_to_all(self, buf):
        import torch.distributed as dist

        buf = buf.contiguous()
        out = torch.empty_like(buf)
        dist.all_to_all_single(out, buf, group=self._group)
        return out


class DistributedHalos:
    """The ``torch.distributed`` backend: one slab per rank of ``group``
    (the default group when None), initialised by the caller
    (``init_process_group`` with its address, world size and rank)."""

    # The caller hands a step this rank's block of the particle rows
    # (sharded binning), or the whole state (replicated binning).
    in_process = False

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistributedHalos: torch.distributed is not "
                               "initialised (init_process_group)")
        self.group = group
        self.n_dev = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def run(self, nxl: int, nyz: int, fn, migrate: bool = False):
        """``[fn(halo)]`` for this process's slab."""
        return [fn(DistributedHalo(self.group, self.n_dev, self.rank, nxl,
                                   nyz, migrate))]


def pad_spec_for_devices(spec, n_dev: int):
    """Pad the grid's x-extent to a multiple of ``n_dev`` (the pad cells
    lie beyond the domain and stay empty, like the ghost ring)."""
    nx = spec.dims[0]
    pad = (-nx) % n_dev
    if pad:
        # clamp_nx keeps escaped particles clamping to the ORIGINAL
        # border ring (the pad layers stay empty), so the slab and the
        # single-device binnings agree once a particle leaves +x.
        spec = spec.replace(dims=(nx + pad,) + spec.dims[1:], clamp_nx=nx)
    return spec


# -- sharded binning: particle migration --------------------------------------


def shard_interleave_perm(n: int, n_dev: int):
    """Round-robin permutation that decorrelates the contiguous row blocks
    of the ranks from spatial order: rank ``d``'s block becomes every
    ``n_dev``-th row of the original order. Spatially sorted storage
    (cube emission order, ``z_sort``) would otherwise send a rank's whole
    block to one slab owner, and the send buffers would need O(N / n_dev)
    rows a rank pair instead of O(N / n_dev^2)."""
    return np.arange(n).reshape(n // n_dev, n_dev).T.reshape(-1)


def shard_interleave(state, n_dev: int):
    """:func:`shard_interleave_perm` applied to every [N, ...] tensor of a
    fluids, boundaries or solver state."""
    n = state_leaves(state)[0].shape[0]
    perm = torch.from_numpy(shard_interleave_perm(n, n_dev))
    return map_state(lambda a: a[perm.to(a.device)], state)


def _slab_targets(spec, nxl: int, n_dev: int, positions, alive):
    """[N, 3] int32 target ranks of each row: the slab that owns its
    (interior-clamped) x-cell, then the left and right neighbours whose
    ghost layer it fills (first / last owned layer of a slab); -1 = none,
    and all -1 for a dead row. The x-cell is found as
    ``dense_grid.bin_particles_slab`` finds it: a multiplication by the
    float32 reciprocal of the width (the JAX package divides, inside jit,
    where XLA compiles the division by the constant width as that
    multiplication)."""
    from ..geometry.dense_grid import inv_width

    hi_x = (spec.clamp_nx if spec.clamp_nx is not None else spec.dims[0]) - 2
    ox = torch.tensor(spec.origin[0], dtype=positions.dtype,
                      device=positions.device)
    cx = torch.floor((positions[:, 0] - ox) * inv_width(spec.cell_width)).to(
        torch.int32)
    cx = torch.clamp(cx, 1, hi_x)
    owner = torch.clamp(cx // nxl, 0, n_dev - 1)
    lx = cx - owner * nxl  # in [0, nxl)
    none = torch.full_like(owner, -1)
    left = torch.where((lx == 0) & (owner > 0), owner - 1, none)
    right = torch.where((lx == nxl - 1) & (owner < n_dev - 1), owner + 1,
                        none)
    t = torch.stack([owner, left, right], dim=-1)
    return torch.where(alive[:, None], t, -1)


def _pack_rows(leaves):
    """The rows of ``[n, ...]`` tensors of any types as one ``[n, B]``
    uint8 tensor (each row's bytes, leaf after leaf), so that one
    collective moves them all."""
    return torch.cat([a.reshape(a.shape[0], -1).contiguous()
                      .view(torch.uint8) for a in leaves], dim=1)


def _unpack_rows(buf, likes):
    """Inverse of :func:`_pack_rows`: tensors of ``likes``' types and row
    shapes, with ``buf``'s rows."""
    out, col = [], 0
    for a in likes:
        width = a.element_size() * int(np.prod(a.shape[1:], dtype=np.int64))
        part = buf[:, col:col + width].contiguous().view(a.dtype)
        out.append(part.reshape((buf.shape[0],) + tuple(a.shape[1:])))
        col += width
    return out


def _route_out(halo, rows, targets, cap_send: int):
    """Send each row to its target ranks.

    ``rows``: [N, B] packed rows; ``targets``: [N, T] ranks (-1 = none).
    Rows are bucketed by target in row order (a stable sort); bucket t
    holds at most ``cap_send`` rows. Returns (the received rows
    [n_dev * cap_send, B]: block s = the rows rank s sent here, in its row
    order, then zero rows (dead); the flat destination slot of each
    (row, target) [N * T] for the route back, ``n_dev * cap_send`` where
    none; the count of (row, target) pairs that did not fit)."""
    from ..geometry.dense_grid import _sorted_ranks

    n_dev = halo.n_dev
    t_slots = targets.shape[1]
    tgt = targets.reshape(-1)
    key = torch.where(tgt >= 0, tgt, n_dev).to(torch.int32)
    order, rank_sorted, _, _ = _sorted_ranks(key)
    rank = torch.empty_like(rank_sorted)
    rank[order.long()] = rank_sorted
    ok = (tgt >= 0) & (rank < cap_send)
    dst = torch.where(ok, tgt * cap_send + rank, n_dev * cap_send)
    overflow = ((tgt >= 0) & (rank >= cap_send)).sum(dtype=torch.int32)
    # One spare row takes every unsent (row, target) and is cut off.
    buf = rows.new_zeros((n_dev * cap_send + 1, rows.shape[1]))
    buf[dst.long()] = rows.repeat_interleave(t_slots, dim=0)
    return halo.all_to_all(buf[:-1]), dst, overflow


def _route_back(halo, reply, dst, fallback, t_slots: int, cap_send: int):
    """Send per-received-row results back to their source rows.

    ``reply``: [n_dev * cap_send, B] results in the received layout; after
    the reverse all-to-all, block t holds the replies to the rows this rank
    sent to t. Each row reads its OWNER's reply (target column 0); a row
    that was never delivered keeps ``fallback`` (its own values)."""
    n_dev = halo.n_dev
    dst_owner = dst.reshape(-1, t_slots)[:, 0]
    ok = dst_owner < n_dev * cap_send
    idx = torch.clamp(dst_owner, max=n_dev * cap_send - 1).long()
    back = halo.all_to_all(reply)
    return torch.where(ok[:, None], back[idx], fallback)


def build_sharded_step_fn(sim, solver_cfg, forces, num_fluids: int, halos,
                          sharded_binning: bool = False,
                          send_cap: int = None,
                          send_cap_boundary: int = None):
    """The dense solver step (DFSPH or IISPH) over ``halos.n_dev`` slabs
    of the grid's x-axis (``salva_tpu``'s ``build_sharded_step_fn``).

    ``halos``: the backend, :class:`LocalHalos` or
    :class:`DistributedHalos`. The step has ``step.build_step_fn``'s
    signature, ``step(fluids, boundaries, solver_state, es, dt,
    gravity)``. Requires the dense grid layout (a static ``sim.domain``),
    grid (not compact) indexing and halo-aware forces.

    With replicated binning (the default) the step takes and returns the
    whole state. With ``sharded_binning`` the particle axis is cut into
    ``n_dev`` equal contiguous blocks of rows, one a rank, which migrate
    to their slabs each substep (module docstring); ``send_cap`` /
    ``send_cap_boundary`` bound the rows a rank sends to one rank, and
    rows that do not fit are counted in ``candidate_overflow``. Under
    :class:`LocalHalos` the caller passes and gets back the whole state
    (rank r takes block r, and the blocks come back in rank order), whose
    capacities ``n_dev`` must divide; under :class:`DistributedHalos` this
    rank's block (``sharding.shard_states``' local block). Reorder a
    spatially sorted state with :func:`shard_interleave` first."""
    from ..solver.forces_dense import (
        Akinci2013SurfaceTensionDense,
        ArtificialViscosityDense,
        DFSPHViscosityDense,
        He2014SurfaceTensionDense,
        ParticleWiseForce,
        WCSPHSurfaceTensionDense,
        XSPHViscosityDense,
    )
    from ..step import _dense_config

    if getattr(sim, "dense_compact", False):
        raise ValueError("domain decomposition requires dense_compact=False")
    if getattr(sim, "fitted_dims", None) is not None:
        # The slabs cover the full static domain; the fluid-extent window
        # is a single-device optimization.
        sim = sim.replace(fitted_dims=None)
    if getattr(sim, "dense_spill_columns", None):
        sim = sim.replace(dense_spill_columns=None)
    if solver_cfg.kind == "dfsph":
        from ..solver.dfsph_dense import build_dense_substep
    elif solver_cfg.kind == "iisph":
        from ..solver.iisph_dense import build_dense_substep
    else:
        raise ValueError(
            f"domain decomposition: unsupported solver {solver_cfg.kind!r}"
        )
    dense = _dense_config(sim, solver_cfg, forces)
    if dense is None or sim.layout == "brute":
        raise ValueError(
            "domain decomposition requires the dense layout "
            "(set a static sim.domain)"
        )
    spec_f, spec_b, dense_forces = dense

    halo_ok = (
        XSPHViscosityDense,  # single pass; reads rho_j (exchanged in ctx)
        ArtificialViscosityDense,  # single pass; reads rho_j
        WCSPHSurfaceTensionDense,  # single pass over positions/masses
        Akinci2013SurfaceTensionDense,  # exchanges its normals mid-force
        He2014SurfaceTensionDense,  # exchanges color + |grad c|^2
        ParticleWiseForce,  # particle layout (replicated), no grid pass
        DFSPHViscosityDense,  # per-iteration ghost exchange of the
        # strain iterate + psum'd global mean error
    )
    for f in dense_forces:
        if not isinstance(f, halo_ok):
            raise ValueError(
                f"{type(f).__name__} is not halo-aware yet (multi-stage "
                "neighbor reads); use the single-device path"
            )

    n_dev = halos.n_dev
    spec_f = pad_spec_for_devices(spec_f, n_dev)
    spec_b = spec_b.replace(dims=spec_f.dims, clamp_nx=spec_f.clamp_nx)
    nxl = spec_f.dims[0] // n_dev
    nyz = int(np.prod(spec_f.dims[1:]))
    n_sub = sim.n_substeps

    def substep_for(halo):
        return build_dense_substep(sim, solver_cfg, num_fluids, spec_f,
                                   spec_b, dense_forces, halo=halo)

    if not sharded_binning:
        def step(fluids, boundaries, solver_state, es, dt, gravity):
            def run(halo):
                substep = substep_for(halo)
                fl, bd, ss = fluids, boundaries, solver_state
                sub_dt = dt / n_sub
                diag = None
                for _ in range(n_sub):
                    fl, bd, ss, diag = substep(fl, bd, ss, es, sub_dt,
                                               gravity)
                return fl, bd, ss, diag

            # Every rank ends with the same merged state; rank 0's is
            # returned.
            return halos.run(nxl, nyz, run)[0]

        return step

    pw_forces = tuple(f for f in dense_forces
                      if isinstance(f, ParticleWiseForce))

    def pw_accel(halo, fl, es):
        """The particle-wise forces' acceleration on this rank's HOME rows:
        every rank's rows gathered (one collective), the forces evaluated
        on all of them (replicated, as in the JAX package: the elasticity's
        rest contacts index home rows), this rank's block kept."""
        nl = fl.positions.shape[0]
        leaves = state_leaves(fl)
        full = state_from_leaves(fl, _unpack_rows(
            torch.cat(halo._gather(_pack_rows(leaves))), leaves))
        a_full = torch.zeros((n_dev * nl, sim.dim), dtype=torch.float32,
                             device=fl.positions.device)
        for f in pw_forces:
            a_full = a_full + f.force.apply_particles(full, es, sim.dim)
        return a_full[halo.rank * nl:(halo.rank + 1) * nl]

    def mig_substep(halo, substep, fl, bd, ss, es, dt, gravity):
        nl = fl.positions.shape[0]
        # Rows a rank sends to one rank: ~N / n_dev^2 with x-decorrelated
        # blocks (shard_interleave), x 2.5 for imbalance, + 64.
        cap_f = send_cap or max(64, -(-5 * nl // (2 * n_dev)) + 64)
        # Boundaries lie by geometry (a side wall in ONE slab): up to the
        # whole block goes to one rank.
        cap_b = send_cap_boundary or max(64, bd.positions.shape[0])

        fl_ss = state_leaves(fl) + state_leaves(ss)
        rows_f = _pack_rows(fl_ss)
        send = rows_f
        if pw_forces:
            a_pw = pw_accel(halo, fl, es)
            send = torch.cat([rows_f, _pack_rows([a_pw])], dim=1)
        tf = _slab_targets(spec_f, nxl, n_dev, fl.positions, fl.alive)
        recv_f, dst_f, over_f = _route_out(halo, send, tf, cap_f)
        got = _unpack_rows(recv_f, fl_ss + ([a_pw] if pw_forces else []))
        nf = len(state_leaves(fl))
        lfl = state_from_leaves(fl, got[:nf])
        lss = state_from_leaves(ss, got[nf:len(fl_ss)])
        l_apw = got[-1] if pw_forces else None

        bd_leaves = state_leaves(bd)
        rows_b = _pack_rows(bd_leaves)
        tb = _slab_targets(spec_b, nxl, n_dev, bd.positions, bd.alive)
        recv_b, dst_b, over_b = _route_out(halo, rows_b, tb, cap_b)
        lbd = state_from_leaves(bd, _unpack_rows(recv_b, bd_leaves))

        nfl, nbd, nss, diag = substep(lfl, lbd, lss, None, dt, gravity,
                                      a_pw=l_apw)

        back_f = _route_back(
            halo, _pack_rows(state_leaves(nfl) + state_leaves(nss)), dst_f,
            rows_f, tf.shape[1], cap_f)
        back = _unpack_rows(back_f, fl_ss)
        fl2 = state_from_leaves(fl, back[:nf])
        ss2 = state_from_leaves(ss, back[nf:])
        back_b = _route_back(halo, _pack_rows(state_leaves(nbd)), dst_b,
                             rows_b, tb.shape[1], cap_b)
        bd2 = state_from_leaves(bd, _unpack_rows(back_b, bd_leaves))

        send_over = halo.psum(over_f + over_b)
        diag = diag.replace(
            candidate_overflow=diag.candidate_overflow + send_over)
        return fl2, bd2, ss2, diag

    def step(fluids, boundaries, solver_state, es, dt, gravity):
        whole = halos.in_process
        if whole:
            for what, st in (("fluid", fluids), ("boundary", boundaries)):
                cap = state_leaves(st)[0].shape[0]
                if cap % n_dev:
                    raise ValueError(
                        f"sharded binning: the {what} capacity {cap} is not "
                        f"divisible by the {n_dev} slabs")

        def run(halo):
            def block(st):
                if not whole:
                    return st
                n = state_leaves(st)[0].shape[0] // n_dev
                return map_state(
                    lambda a: a[halo.rank * n:(halo.rank + 1) * n], st)

            substep = substep_for(halo)
            fl, bd, ss = block(fluids), block(boundaries), block(
                solver_state)
            sub_dt = dt / n_sub
            diag = None
            for _ in range(n_sub):
                fl, bd, ss, diag = mig_substep(halo, substep, fl, bd, ss,
                                               es, sub_dt, gravity)
            return fl, bd, ss, diag

        outs = halos.run(nxl, nyz, run, migrate=True)
        if not whole:
            return outs[0]
        # The blocks in rank order; the psum'd diagnostics agree on every
        # rank.
        joined = [
            state_from_leaves(outs[0][i], [
                torch.cat(parts) for parts in zip(
                    *(state_leaves(o[i]) for o in outs))])
            for i in range(3)
        ]
        return (*joined, outs[0][3])

    return step


@functools.lru_cache(maxsize=16)
def get_sharded_step_fn(sim, solver_cfg, forces, num_fluids: int, halos,
                        sharded_binning: bool = False, send_cap: int = None,
                        send_cap_boundary: int = None):
    """:func:`build_sharded_step_fn`, cached per configuration and
    backend (``get_jitted_sharded_step_fn``'s counterpart)."""
    return build_sharded_step_fn(
        sim, solver_cfg, forces, num_fluids, halos,
        sharded_binning=sharded_binning, send_cap=send_cap,
        send_cap_boundary=send_cap_boundary)


def dryrun(n_devices: int, device=None) -> None:
    """Build and run ONE sharded-binning step on ``n_devices`` slabs
    (``LocalHalos``) and check it (``salva_tpu``'s ``domain.dryrun``):
    the migration's all-to-alls, the per-iteration ghost exchanges and
    the summed convergence errors, on a 6^3 block lifted 0.5 m over a
    sampled floor in the JAX dry run's domain. Asserts finite positions,
    at least one pressure iteration and no send overflow. Runs on the
    card unless ``device`` names another (``"cpu"``)."""
    from .. import shapes
    from ..config import DFSPHConfig, NeighborConfig
    from ..sampling import shape_surface_sample
    from ..scenes import cube_fluid
    from ..world import Boundary, Fluid, LiquidWorld

    radius = 0.05
    world = LiquidWorld(
        solver=DFSPHConfig(), particle_radius=radius, dim=3,
        neighbors=NeighborConfig(max_neighbors=48, max_candidates=192,
                                 query_chunk=16384),
        domain=((-1.2, -0.5, -1.2), (1.2, 1.6, 1.2)),
        layout="dense", device=device,
    )
    pos = cube_fluid((6, 6, 6), radius)
    pos[:, 1] += 0.5
    world.add_fluid(Fluid(pos, density0=1000.0))
    world.add_boundary(Boundary(shape_surface_sample(
        shapes.Cuboid((1.0, 0.1, 1.0)), radius, 3)))
    world._prepare()
    sim = world._boundary_volume_mode(world._effective_sim(), None)
    migrated = get_sharded_step_fn(
        sim, world.solver_config, world._force_set, 1,
        LocalHalos(n_devices), sharded_binning=True)
    # Decorrelate storage order from x (cube emission order), the solver
    # state's rows with their fluid rows.
    fluids = shard_interleave(world.fluids_state, n_devices)
    boundaries = shard_interleave(world.boundaries_state, n_devices)
    solver_state = shard_interleave(world._solver_state, n_devices)
    gravity = torch.tensor([0.0, -9.81, 0.0], dtype=torch.float32,
                           device=world.device)
    fl, _bd, _ss, diag = migrated(fluids, boundaries, solver_state, None,
                                  1.0 / 200.0, gravity)
    assert bool(torch.isfinite(fl.positions).all())
    # The step must have solved something (a run that dropped every
    # particle would trivially be finite).
    assert diag.solver.pressure_iters >= 1
    assert int(diag.candidate_overflow) == 0, (
        f"migration send overflow: {int(diag.candidate_overflow)}")
