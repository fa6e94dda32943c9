"""Kernel evaluation over neighbour tables.

Port of ``salva_tpu.geometry.contacts`` (the reference's ``Contact
{weight, gradient}`` pass, ``src/solver/helper.rs:9-65``): once per
substep, W and the kernel gradient are evaluated for every (particle,
neighbour slot) pair and reused by every solver iteration — positions
are frozen during a substep's loops.

Layout is ``[N, K]`` / ``[N, K, dim]``; invalid slots carry ``w = 0`` and
``grad = 0``. Terms not proportional to W or grad (the Akinci cohesion
kernel) use ``mask`` explicitly.

``Contacts.scatter_table`` is the port's addition: the inverse of the
table (for each source particle, the flat slots that name it, in flat
order), built once per substep and used by every boundary-force scatter
(``solver.common.scatter_boundary_forces``) in place of a float-atomic
``index_add_``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import counters
from ..kernels import sph
from .neighbors import NeighborLists


@dataclasses.dataclass
class Contacts:
    """Evaluated contacts of one query set against one source set.

    - ``j``: [N, K] int64 neighbour indices (safe to gather with);
    - ``valid``: [N, K] bool;
    - ``mask``: [N, K] f32 (1.0 where valid);
    - ``w``: [N, K] f32 kernel weights (0 on invalid slots);
    - ``grad``: [N, K, dim] f32 kernel gradients w.r.t. the query point;
    - ``count``: [N] int32 valid-neighbour count (pre-truncation).
    """

    j: torch.Tensor
    valid: torch.Tensor
    mask: torch.Tensor
    w: torch.Tensor
    grad: torch.Tensor
    count: torch.Tensor
    _table: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    def gather(self, src_arr):
        """Gather a per-source-particle array over the neighbour table."""
        return src_arr[self.j]

    def scatter_table(self, n_src: int) -> torch.Tensor:
        """[n_src, kmax] int64: row s lists the flat slots ``i * K + k``
        of the valid contacts naming source particle s, in flat order,
        padded with ``N * K`` (a zero row). Built on first use (one host
        sync for kmax) and kept: the table is frozen for the substep."""
        if self._table is None:
            flat_j = self.j.reshape(-1)
            sel = torch.nonzero(self.valid.reshape(-1)).squeeze(1)
            js = flat_j[sel]
            order = torch.argsort(js, stable=True)
            js_sorted = js[order]
            counts = torch.bincount(js, minlength=n_src)
            kmax = (int(counters.fetch("scatter_table", counts.max()))
                    if js.numel() else 0)
            starts = torch.cumsum(counts, 0) - counts
            rank = (torch.arange(js.numel(), device=js.device)
                    - starts[js_sorted])
            table = torch.full((n_src, kmax), flat_j.numel(),
                               dtype=torch.int64, device=js.device)
            table[js_sorted, rank] = sel[order]
            self._table = table
        return self._table


def evaluate_contacts(query_pos, src_pos, neighbors: NeighborLists, h,
                      dim: int, w_fn=sph.cubic_w,
                      dw_fn=sph.cubic_dw) -> Contacts:
    """Fill W / grad for a neighbour table (`helper.rs:9-65`)."""
    j = neighbors.idx
    dpos = query_pos[:, None, :] - src_pos[j]
    r, grad = sph.grad_from_dpos(dpos, h, dim, dw_fn=dw_fn)
    w = w_fn(r, h, dim)
    mask = neighbors.valid.to(query_pos.dtype)
    return Contacts(
        j=j,
        valid=neighbors.valid,
        mask=mask,
        w=w * mask,
        grad=grad * mask[..., None],
        count=neighbors.count,
    )
