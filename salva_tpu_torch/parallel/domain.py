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
one backend to the other. Sharded binning (particle migration,
``migrate=True`` in the JAX package) is not ported yet.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

# Seconds a LocalHalos rank waits at a collective before the run raises.
BARRIER_TIMEOUT_S = 60.0


class Halo:
    """Ghost-layer exchange and collectives for one slab (``salva_tpu``'s
    ``Halo``): rank ``rank`` of ``n_dev`` owns x-layers ``[x0, x0 + nxl)``.

    Local grid arrays are ``[..., cap, C_local]`` with
    ``C_local = (nxl + 2) * nyz``; layers 0 and ``nxl + 1`` are the ghost
    layers mirroring the neighbours' border layers. Subclasses move the
    data (:meth:`_shift`, :meth:`_gather`)."""

    def __init__(self, n_dev: int, rank: int, nxl: int, nyz: int):
        self.n_dev = n_dev
        self.rank = rank
        self.nxl = nxl
        self.nyz = nyz

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

    def merge_particles(self, values, covered, fallback):
        """Combine the ranks' unbinned particle arrays: each particle is
        interior on exactly one rank (``covered``) and the others give
        zeros; a particle no rank covers keeps ``fallback``."""
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

    def __init__(self, group: _LocalGroup, n_dev, rank, nxl, nyz):
        super().__init__(n_dev, rank, nxl, nyz)
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


class LocalHalos:
    """The in-process backend: ``n_dev`` slabs, one thread each, in this
    process. A rank that waits BARRIER_TIMEOUT_S seconds at a collective
    for the others raises, and so does every other rank."""

    def __init__(self, n_dev: int):
        if n_dev < 1:
            raise ValueError(f"LocalHalos: n_dev must be >= 1, got {n_dev}")
        self.n_dev = n_dev

    def run(self, nxl: int, nyz: int, fn):
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
                                             nyz))
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

    def __init__(self, group, n_dev, rank, nxl, nyz):
        super().__init__(n_dev, rank, nxl, nyz)
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


class DistributedHalos:
    """The ``torch.distributed`` backend: one slab per rank of ``group``
    (the default group when None), initialised by the caller
    (``init_process_group`` with its address, world size and rank)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistributedHalos: torch.distributed is not "
                               "initialised (init_process_group)")
        self.group = group
        self.n_dev = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def run(self, nxl: int, nyz: int, fn):
        """``[fn(halo)]`` for this process's slab."""
        return [fn(DistributedHalo(self.group, self.n_dev, self.rank, nxl,
                                   nyz))]


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


def build_sharded_step_fn(sim, solver_cfg, forces, num_fluids: int, halos):
    """The dense solver step (DFSPH or IISPH) over ``halos.n_dev`` slabs
    of the grid's x-axis, with replicated binning (``salva_tpu``'s
    ``build_sharded_step_fn`` with ``sharded_binning=False``).

    ``halos``: the backend, :class:`LocalHalos` or
    :class:`DistributedHalos`. The step has ``step.build_step_fn``'s
    signature, ``step(fluids, boundaries, solver_state, es, dt,
    gravity)``, and takes and returns the same replicated state. Requires
    the dense grid layout (a static ``sim.domain``), grid (not compact)
    indexing and halo-aware forces."""
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

    def step(fluids, boundaries, solver_state, es, dt, gravity):
        def run(halo):
            substep = build_dense_substep(
                sim, solver_cfg, num_fluids, spec_f, spec_b, dense_forces,
                halo=halo,
            )
            fl, bd, ss = fluids, boundaries, solver_state
            sub_dt = dt / n_sub
            diag = None
            for _ in range(n_sub):
                fl, bd, ss, diag = substep(fl, bd, ss, es, sub_dt, gravity)
            return fl, bd, ss, diag

        # Every rank ends with the same merged state; rank 0's is returned.
        return halos.run(nxl, nyz, run)[0]

    return step


@functools.lru_cache(maxsize=16)
def get_sharded_step_fn(sim, solver_cfg, forces, num_fluids: int, halos):
    """:func:`build_sharded_step_fn`, cached per configuration and
    backend (``get_jitted_sharded_step_fn``'s counterpart)."""
    return build_sharded_step_fn(sim, solver_cfg, forces, num_fluids, halos)
