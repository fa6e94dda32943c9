"""The full-stencil plain folds of the dense solvers.

Port of the folds ``salva_tpu.solver.dense_common.DenseCtx`` runs where
neither its half stencil nor a Pallas kernel applies: ``_hot_blocks``
with the full ``t_pass`` / ``k_pass`` folds, the fluid-fluid hoist fold
of ``_hoist`` and its fluid-boundary roll fold. Each walks every offset
of ``dense_grid.stencil_offsets(spec)`` (the 3^dim neighbor cells of a
grid, or the cyclic offsets 0..C-1 of the brute tier), one
``[cap_i, cap_j, C]`` pair block per offset, accumulated offset by offset
in the JAX fold's order.

They are plain PyTorch on every device. The brute tier runs them on the
CPU and on the card alike (the JAX package runs no Pallas kernel there);
a grid with ``dense_half_stencil=False`` runs them for CPU tensors, and
the hand kernels of ``ops/pair.py`` (which walk the full stencil) for
CUDA tensors. The compact active-cell layout runs them on every device
too, with its neighbour-table gathers as the j-side views (``jview``)
in place of the rolls, as the JAX package does (its compact layout runs
no Pallas kernel).
"""

from __future__ import annotations

import torch

from ..geometry import dense_grid as dg
from ..kernels import get_kernel, w_dwr
from ..ops.pair import _fb_body, fold_pairs


def _jview(spec, offsets):
    return lambda arr, o: dg.shift_j(spec, arr, offsets[o])


def _hot_blocks(spec, h, dim, kernel_gradient, P, jview=None):
    """(dpos, dwr, view) per offset, mask-free (empty slots hold the far
    position sentinel); ``view(arr)`` is the j-side view of that offset:
    ``jview(arr, o)``, by default the roll of the grid ``spec``."""
    kg_w, kg_dw = get_kernel(kernel_gradient)
    offsets = dg.stencil_offsets(spec)
    jview = jview or _jview(spec, offsets)
    for o in range(len(offsets)):
        pj = jview(P, o)
        dpos = [P[d][:, None, :] - pj[d][None, :, :] for d in range(dim)]
        r2 = dpos[0] * dpos[0]
        for d in range(1, dim):
            r2 = r2 + dpos[d] * dpos[d]
        _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        yield dpos, dwr, (lambda arr, o=o: jview(arr, o))


def t_pass(spec, h, dim, kernel_gradient, P, M, Q, jview=None):
    """T_i = sum_j m_j (Q_j . grad_ij) -> [cap, C]; ``jview``: the j-side
    views (see :func:`_hot_blocks`)."""
    acc = torch.zeros_like(M)
    for dpos, dwr, view in _hot_blocks(spec, h, dim, kernel_gradient, P,
                                       jview):
        mj = view(M)
        qj = view(Q)
        t = torch.zeros_like(dwr)
        for d in range(dim):
            t = t + qj[d][None, :, :] * dpos[d]
        acc = acc + torch.sum(t * dwr * mj[None, :, :], dim=1)
    return acc


def k_pass(spec, h, dim, kernel_gradient, P, M, K, jview=None):
    """K_i = sum_j k_j m_j grad_ij -> [dim, cap, C]."""
    acc = [torch.zeros_like(M) for _ in range(dim)]
    for dpos, dwr, view in _hot_blocks(spec, h, dim, kernel_gradient, P,
                                       jview):
        coeff = view(K)[None, :, :] * view(M)[None, :, :] * dwr
        for d in range(dim):
            acc[d] = acc[d] + torch.sum(dpos[d] * coeff, dim=1)
    return torch.stack(acc)


def ff_body(h, dim, kernel_density, kernel_gradient, need_s2):
    """``DenseCtx._hoist``'s ``ff_body``: the fluid-fluid sums (rho, Gf,
    sq, s2, count) of one [cap_i, cap_j, n] pair block."""
    kd_w, kd_dw = get_kernel(kernel_density)
    kg_w, kg_dw = get_kernel(kernel_gradient)

    def body(acc, dpos, r2, within, j):
        rho, gf, sq, s2, cnt = acc
        _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        wd, _ = w_dwr(r2, h, dim, kd_w, kd_dw)
        mj = torch.where(within, j["m"][None, :, :], 0.0)
        rho = rho + torch.sum(mj * wd, dim=1)
        gsq = torch.zeros_like(r2)
        gf_new = []
        for d in range(dim):
            g_d = dpos[d] * dwr
            gf_new.append(gf[d] + torch.sum(g_d * mj, dim=1))
            gsq = gsq + g_d * g_d
        sq = sq + torch.sum(gsq * mj * mj, dim=1)
        if need_s2:
            s2 = s2 + torch.sum(gsq * mj, dim=1)
        cnt = cnt + torch.sum(within, dim=1, dtype=torch.int32)
        return rho, torch.stack(gf_new), sq, s2, cnt

    return body


def hoist_ff(spec, h, dim, kernel_density, kernel_gradient, P, M, maskf,
             need_s2=True, jview=None):
    """(rho_ff, Gf, sq_ff, s2_ff, cnt_ff) over the live slots ``maskf``;
    s2 is zero unless ``need_s2``."""
    offsets = dg.stencil_offsets(spec)
    z = torch.zeros_like(maskf)
    return fold_pairs(
        offsets, h, dim, P, maskf, P, maskf,
        jview or _jview(spec, offsets), {"m": M},
        ff_body(h, dim, kernel_density, kernel_gradient, need_s2),
        (z, torch.zeros_like(P), z, z,
         torch.zeros_like(maskf, dtype=torch.int32)),
    )


def hoist_fb(spec, h, dim, kernel_density, kernel_gradient, P, maskf, Pb,
             maskb, Volb, Vbvel, need_s2=True, jview=None):
    """(rho_fb, Gb, sq_fb, s2_fb, Sb, cnt_fb) over the live fluid slots
    ``maskf``, the boundary binned on the same columns as the fluid
    ([cap_b, C]: the brute tier, or a grid's full-grid boundary binning)
    or read through ``jview`` (the compact layout's boundary table)."""
    offsets = dg.stencil_offsets(spec)
    z = torch.zeros_like(maskf)
    return fold_pairs(
        offsets, h, dim, P, maskf, Pb, maskb,
        jview or _jview(spec, offsets),
        {"vol": Volb, "vb": Vbvel},
        _fb_body(h, dim, kernel_density, kernel_gradient, need_s2),
        (z, torch.zeros_like(P), z, z, z,
         torch.zeros_like(maskf, dtype=torch.int32)),
    )
