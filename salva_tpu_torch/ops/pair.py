"""The four dense pair passes of the DFSPH and IISPH solvers, and the
fluid-fluid term of the dense artificial viscosity.

Each pass has a hand-written CUDA kernel (``csrc/pair_passes.cu``) and a
plain PyTorch version beside it:

======================  ======================================  =============================
wrapper                 computes, per live slot i of the grid   plain version
======================  ======================================  =============================
``k_pass``              K_i = sum_j (m k)_j grad_ij [dim,cap,C]  ``k_pass_plain``
``t_pass``              T_i = sum_j m_j (Q_j . grad_ij) [cap,C]  ``t_pass_plain``
``hoist_ff``            rho, Gf, sq, s2, pair count (j fluid)    ``hoist_ff_plain``
``hoist_fb``            rho, Gb, sq, s2, Sb, count (j boundary)  ``hoist_fb_plain``
``k_pass_v2``           ``k_pass`` in 8-slot groups (below)      ``k_pass_plain``
``artificial_visc_ff``  Monaghan viscosity, same fluid [dim,...] ``artificial_visc_ff_plain``
======================  ======================================  =============================

(grad_ij = (p_i - p_j) dW/dr / r, summed over the 3^dim cell stencil.)

``k_pass_v2`` computes what ``k_pass`` computes, in the slot-group
formulation of ``salva_tpu.ops.pallas_pair2.k_pass_pallas2``: a pair block
runs only where both 8-slot groups are live (group g of cell c is live iff
``counts[c] > 8 g``); the dead slots inside a live group must hold the
sentinel position and zero mass, as every binned grid does, and then add
nothing. So its kernel is ``k_pass``'s tiled body, which walks each
cell's true count (one launch, counted under ``k_pass_v2``). As in the
JAX package, no solver calls it.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback. Every launch adds
one to ``LAUNCHES[name]``, so a run can show which passes went through
the kernels. Every pass takes the SPH kernel of each of its roles by name
(``kernel_gradient`` for dW/dr / r, and for the hoists ``kernel_density``
for W): ``"cubic"``, ``"poly6"``, ``"spiky"`` or ``"viscosity"``, on both
devices; an unknown name raises ``KeyError``.

The fluid-fluid plain versions are the half-stencil folds of
``salva_tpu.solver.dense_common.DenseCtx`` (``_k_pass_half``,
``_t_pass_half``, ``_hoist_ff_half``): each +/- offset pair of the
stencil shares one ``[cap, cap, C]`` pair block, whose mirrored j-side
sum is rolled back onto cell c + s. ``hoist_fb_plain`` is the same
class's fluid-boundary fold (``_hoist_fb_sparse`` and the roll fold of
``_hoist``). The kernels walk the full stencil per output slot instead,
so the two agree to float32 summation order.

All passes take the per-cell live counts ``counts`` ([C] int32, ranks
fill from 0, so slot (r, c) is live iff r < counts[c]); the plain hoists
rebuild the occupancy masks from them (``hoist_fb`` takes the boundary
side's counts ``counts_b`` the same way).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..geometry import dense_grid as dg
from ..kernels.sph import (
    EPSILON,
    _cubic_normalizer,
    _poly6_normalizer,
    _spiky_normalizer,
    _viscosity_normalizer,
    get_kernel,
    w_dwr,
)

LAUNCHES = {"k_pass": 0, "t_pass": 0, "hoist_ff": 0, "hoist_fb": 0,
            "k_pass_v2": 0, "artificial_visc_ff": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fold_pairs(offsets, h, dim, pos_i, mask_i, pos_j, mask_j, jview,
               j_arrays: Dict, body, init):
    """Fold ``body(acc, dpos, r2, within, j) -> acc`` over all 3^dim
    neighbor views produced by ``jview(arr, o)``."""
    acc = init
    h2 = h * h
    for o in range(len(offsets)):
        pj = jview(pos_j, o)
        mj = jview(mask_j, o)
        j = {k: jview(v, o) for k, v in j_arrays.items()}
        dpos = [pos_i[d][:, None, :] - pj[d][None, :, :] for d in range(dim)]
        r2 = dpos[0] * dpos[0]
        for d in range(1, dim):
            r2 = r2 + dpos[d] * dpos[d]
        within = (r2 <= h2) & (mask_i[:, None, :] > 0) & (mj[None, :, :] > 0)
        acc = body(acc, dpos, r2, within, j)
    return acc


# -- plain PyTorch versions (half-stencil folds) ------------------------------


def _rollj(arr, s: int):
    """j-side view at flat shift ``s`` (cell c sees cell c + s)."""
    return arr if s == 0 else torch.roll(arr, -s, dims=-1)


def _blocks_half(spec, dim, P):
    """(dpos, r2, s) for s in {0} + the positive flat shifts: each s > 0
    block covers the unordered cell-pair set {(c, c + s)}."""
    pos_shifts = tuple(s for s in dg.flat_shifts(spec) if s > 0)
    for s in (0,) + pos_shifts:
        pj = _rollj(P, s)
        dpos = [P[d][:, None, :] - pj[d][None, :, :] for d in range(dim)]
        r2 = dpos[0] * dpos[0]
        for d in range(1, dim):
            r2 = r2 + dpos[d] * dpos[d]
        yield dpos, r2, s


def _live_mask(counts, cap: int):
    r = torch.arange(cap, dtype=counts.dtype, device=counts.device)
    return (r[:, None] < counts[None, :]).to(torch.float32)


def t_pass_plain(spec, h, dim, kernel_gradient, P, M, Q, counts):
    kg_w, kg_dw = get_kernel(kernel_gradient)
    acc = torch.zeros_like(M)
    for dpos, r2, s in _blocks_half(spec, dim, P):
        _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        mj = _rollj(M, s)
        qj = _rollj(Q, s)
        t = qj[0][None, :, :] * dpos[0]
        for d in range(1, dim):
            t = t + qj[d][None, :, :] * dpos[d]
        acc = acc + torch.sum(t * dwr * mj[None, :, :], dim=1)
        if s:
            # Mirror: T_j += m_i (Q_i . (p_j - p_i)) dwr = -(Q_i . dpos) dwr m_i
            ti = Q[0][:, None, :] * dpos[0]
            for d in range(1, dim):
                ti = ti + Q[d][:, None, :] * dpos[d]
            r = torch.sum(ti * dwr * M[:, None, :], dim=0)
            acc = acc - torch.roll(r, s, dims=-1)
    return acc


def k_pass_plain(spec, h, dim, kernel_gradient, P, M, K, counts):
    kg_w, kg_dw = get_kernel(kernel_gradient)
    MK = M * K
    acc = [torch.zeros_like(M) for _ in range(dim)]
    for dpos, r2, s in _blocks_half(spec, dim, P):
        _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        coeff_j = _rollj(MK, s)[None, :, :] * dwr
        if s:
            coeff_i = MK[:, None, :] * dwr
        for d in range(dim):
            acc[d] = acc[d] + torch.sum(dpos[d] * coeff_j, dim=1)
            if s:
                # Mirror: K_j,d += (k m)_i (p_j - p_i)_d dwr.
                r = torch.sum(dpos[d] * coeff_i, dim=0)
                acc[d] = acc[d] - torch.roll(r, s, dims=-1)
    return torch.stack(acc)


def hoist_ff_plain(spec, h, dim, kernel_density, kernel_gradient, P, M,
                   counts, need_s2=True):
    """(rho_ff, Gf, sq_ff, s2_ff, cnt_ff): every hoisted sum has an
    i<->j mirror on the shared pair block (rho: m_i W; Gf: -grad m_i;
    sq: |grad|^2 m_i^2; s2: |grad|^2 m_i; cnt: the symmetric ``within``)."""
    kd_w, kd_dw = get_kernel(kernel_density)
    kg_w, kg_dw = get_kernel(kernel_gradient)
    h2 = h * h
    maskm = _live_mask(counts, M.shape[0])
    z = torch.zeros_like(maskm)
    rho, sq, s2 = z, z, z
    cnt = torch.zeros_like(maskm, dtype=torch.int32)
    gf = [z for _ in range(dim)]
    mask_i = maskm[:, None, :] > 0
    for dpos, r2, s in _blocks_half(spec, dim, P):
        wd, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        if (kd_w, kd_dw) != (kg_w, kg_dw):
            wd, _ = w_dwr(r2, h, dim, kd_w, kd_dw)
        within = (r2 <= h2) & mask_i & (_rollj(maskm, s)[None, :, :] > 0)
        mj = torch.where(within, _rollj(M, s)[None, :, :], 0.0)
        rho = rho + torch.sum(mj * wd, dim=1)
        cnt = cnt + torch.sum(within, dim=1, dtype=torch.int32)
        if s:
            mi = torch.where(within, M[:, None, :], 0.0)
            rho = rho + torch.roll(torch.sum(mi * wd, dim=0), s, dims=-1)
            cnt = cnt + torch.roll(
                torch.sum(within, dim=0, dtype=torch.int32), s, dims=-1
            )
        gsq = torch.zeros_like(r2)
        for d in range(dim):
            g_d = dpos[d] * dwr
            gf[d] = gf[d] + torch.sum(g_d * mj, dim=1)
            if s:
                # grad_ji = -grad_ij.
                gf[d] = gf[d] - torch.roll(
                    torch.sum(g_d * mi, dim=0), s, dims=-1
                )
            gsq = gsq + g_d * g_d
        sq = sq + torch.sum(gsq * mj * mj, dim=1)
        if need_s2:
            s2 = s2 + torch.sum(gsq * mj, dim=1)
        if s:
            sq = sq + torch.roll(torch.sum(gsq * mi * mi, dim=0), s, dims=-1)
            if need_s2:
                s2 = s2 + torch.roll(
                    torch.sum(gsq * mi, dim=0), s, dims=-1
                )
    return rho, torch.stack(gf), sq, s2, cnt


def _fb_body(h, dim, kernel_density, kernel_gradient, need_s2):
    """``DenseCtx._hoist``'s ``fb_body``: the fluid-boundary sums of one
    [cap_f, cap_b, n] pair block."""
    kd_w, kd_dw = get_kernel(kernel_density)
    kg_w, kg_dw = get_kernel(kernel_gradient)

    def fb_body(acc, dpos, r2, within, j):
        rho, gb, sq, s2, sb, cnt = acc
        _, dwr = w_dwr(r2, h, dim, kg_w, kg_dw)
        wd, _ = w_dwr(r2, h, dim, kd_w, kd_dw)
        vj = torch.where(within, j["vol"][None, :, :], 0.0)
        rho = rho + torch.sum(vj * wd, dim=1)
        gsq = torch.zeros_like(r2)
        vdotg = torch.zeros_like(r2)
        gb_new = []
        for d in range(dim):
            g_d = dpos[d] * dwr
            gb_new.append(gb[d] + torch.sum(g_d * vj, dim=1))
            gsq = gsq + g_d * g_d
            vdotg = vdotg + j["vb"][d][None, :, :] * g_d * vj
        sq = sq + torch.sum(gsq * vj * vj, dim=1)
        if need_s2:
            s2 = s2 + torch.sum(gsq * vj, dim=1)
        sb = sb + torch.sum(vdotg, dim=1)
        cnt = cnt + torch.sum(within, dim=1, dtype=torch.int32)
        return rho, torch.stack(gb_new), sq, s2, sb, cnt

    return fb_body


def hoist_fb_plain(spec, h, dim, kernel_density, kernel_gradient, P, counts,
                   Pb, Volb, Vbvel, counts_b, cell_to_col=None, cols=None,
                   need_s2=True):
    """(rho_fb, Gb, sq_fb, s2_fb, Sb, cnt_fb) on the full [cap_f, C] fluid
    grid: per live fluid slot, over the boundary particles of its 3^dim
    neighbor cells, sum Volb_j W, Volb_j grad, |grad|^2 Volb_j^2,
    |grad|^2 Volb_j (zero unless ``need_s2``), Volb_j (vb_j . grad) and
    the pairs within h.

    - ``Pb`` / ``Vbvel`` [dim, cap_b, Cb], ``Volb`` [cap_b, Cb] and
      ``counts_b`` [Cb]: the boundary grid, one column per boundary cell
      of the binning;
    - ``cell_to_col`` [C + 1]: the boundary column of each fluid-grid cell
      (``cell_to_active`` of the sparse binning, whose void column is
      empty); None for the full-grid binning (Cb == C, identity);
    - ``cols`` [n]: the fluid columns to visit (the sparse hoist's
      boundary-adjacency table over the compact binning; entries outside
      [0, C) are unused), or None for every column. Columns not visited
      get zeros.

    With both None this is ``DenseCtx._hoist``'s roll fold; with a table,
    ``_hoist_fb_sparse`` (gathered blocks, scattered back)."""
    cap, C = P.shape[-2], P.shape[-1]
    maskf = _live_mask(counts, cap)
    maskb = _live_mask(counts_b, Pb.shape[-2])
    shifts = dg.flat_shifts(spec)
    if cols is None:
        Pi, maski = P, maskf
    else:
        got = (cols >= 0) & (cols < C)
        cg = torch.where(got, cols, 0).long()
        Pi = P[..., cg]
        maski = torch.where(got[None, :], maskf[..., cg], 0.0)
    if cell_to_col is None:
        def jview(arr, o):
            return _rollj(arr, shifts[o])
    else:
        base = (cg if cols is not None
                else torch.arange(C, dtype=torch.int64, device=P.device))
        sh = torch.tensor(shifts, dtype=torch.int64, device=P.device)
        nb = torch.clamp(base[:, None] + sh[None, :], 0, C)  # [n, 3^dim]
        nb = cell_to_col.long()[nb]

        def jview(arr, o):
            return arr[..., nb[:, o]]

    z = torch.zeros_like(maski)
    rho, gb, sq, s2, sb, cnt = fold_pairs(
        dg.neighbor_offsets(dim), h, dim, Pi, maski, Pb, maskb, jview,
        {"vol": Volb, "vb": Vbvel},
        _fb_body(h, dim, kernel_density, kernel_gradient, need_s2),
        (z, torch.zeros_like(Pi), z, z, z,
         torch.zeros_like(maski, dtype=torch.int32)),
    )
    if cols is None:
        return rho, gb, sq, s2, sb, cnt
    # Scatter back to the grid (unused table slots target the spare
    # column C, which is cut off).
    af_sc = torch.where(got, cols, C).long()
    packed = torch.cat([rho[None], gb, sq[None], s2[None], sb[None]], dim=0)
    fullf = torch.zeros(packed.shape[:-1] + (C + 1,), dtype=packed.dtype,
                        device=P.device)
    fullf[..., af_sc] = packed
    fulli = torch.zeros(cnt.shape[:-1] + (C + 1,), dtype=cnt.dtype,
                        device=P.device)
    fulli[..., af_sc] = cnt
    fullf, fulli = fullf[..., :C], fulli[..., :C]
    return (fullf[0], fullf[1:1 + dim], fullf[1 + dim], fullf[2 + dim],
            fullf[3 + dim], fulli)


def per_slot(values, FID):
    """Per-fluid coefficient tuple -> per-slot grid (static unrolled)."""
    out = torch.zeros(FID.shape, dtype=torch.float32, device=FID.device)
    for fid, v in enumerate(values):
        if v != 0.0:
            out = torch.where(
                FID == fid,
                torch.tensor(v, dtype=torch.float32, device=FID.device),
                out,
            )
    return out


def artificial_visc_ff_fold(n_offsets, jview, mask, h, dim, kernel_gradient,
                            P, V, VOL, RHO, R0, FID, coefficients, alphas,
                            betas, speeds_of_sound):
    """The fluid-fluid term of the dense Monaghan artificial viscosity
    (``artificial_viscosity.rs:40-125``: same fluid, v.r < 0) as a fold
    over ``n_offsets`` neighbour views ``jview(arr, o)`` (rolls of a grid,
    the brute tier's cyclic offsets, the compact layout's tables), live
    slots where ``mask`` > 0 -> [dim, cap, C]. The per-fluid tuples are
    ``ArtificialViscosityForce``'s."""
    kg_w, kg_dw = get_kernel(kernel_gradient)
    coeff = per_slot(coefficients, FID)
    alpha = per_slot(alphas, FID)
    beta = per_slot(betas, FID)
    sos = per_slot(speeds_of_sound, FID)
    eta2 = h * h * 0.01

    def body(accel, dpos, r2, within, j):
        dwr = w_dwr(r2, h, dim, kg_w, kg_dw)[1]
        vr = torch.zeros_like(r2)
        for d in range(dim):
            vr = vr + dpos[d] * (V[d][:, None, :] - j["v"][d][None, :, :])
        rho_avg = (RHO[:, None, :] + j["rho"][None, :, :]) * 0.5
        mu = h * vr / (r2 + eta2)
        visc = sos[:, None, :] * alpha[:, None, :] * mu \
            - beta[:, None, :] * mu * mu
        ok = within & (vr < 0.0) \
            & (FID[:, None, :] == j["fid"][None, :, :])
        scale = torch.where(
            ok,
            coeff[:, None, :] * visc * j["vol"][None, :, :]
            * R0[:, None, :] / torch.clamp(rho_avg, min=EPSILON),
            0.0,
        )
        return accel + torch.stack(
            [torch.sum(dpos[d] * dwr * scale, dim=1) for d in range(dim)]
        )

    return fold_pairs(range(n_offsets), h, dim, P, mask, P, mask, jview,
                      {"v": V, "vol": VOL, "rho": RHO, "fid": FID}, body,
                      torch.zeros_like(P))


def artificial_visc_ff_plain(spec, h, dim, kernel_gradient, P, V, VOL, RHO,
                             R0, FID, counts, coefficients, alphas, betas,
                             speeds_of_sound):
    """:func:`artificial_visc_ff_fold` over the grid's 3^dim rolls, the
    live slots rebuilt from ``counts``."""
    offs = dg.stencil_offsets(spec)
    return artificial_visc_ff_fold(
        len(offs), lambda arr, o: dg.shift_j(spec, arr, offs[o]),
        _live_mask(counts, P.shape[-2]), h, dim, kernel_gradient, P, V, VOL,
        RHO, R0, FID, coefficients, alphas, betas, speeds_of_sound)


# -- CUDA kernel wrappers ------------------------------------------------------


def _is_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(
            f"pair passes run on CPU (plain) or CUDA (kernel) tensors, "
            f"got {t.device}"
        )
    return False


def _check(name, spec, dim, kernel_names, channels, counts):
    """Validate the operands of a pass (on any device) and, for CUDA
    tensors, what the kernel takes; raise on anything else.
    ``channels``: (tensor, expected shape) pairs, all float32. Returns
    whether the operands lie on the CPU."""
    P = channels[0][0]
    on_cpu = _is_cpu(P)
    for kn in kernel_names:
        get_kernel(kn)  # KeyError for an unknown name
    if dim not in (2, 3) or spec.dim != dim:
        raise ValueError(f"{name}: dim {dim} does not match the grid spec")
    if P.ndim != 3:
        raise ValueError(f"{name}: expected positions [dim, cap, C]")
    cap, C = P.shape[-2], P.shape[-1]
    if C != spec.num_cells:
        raise ValueError(
            f"{name}: {C} columns but the grid spec has {spec.num_cells}"
        )
    for t, shape in channels:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if tuple(t.shape) != shape(dim, cap, C):
            raise ValueError(
                f"{name}: expected shape {shape(dim, cap, C)}, got "
                f"{tuple(t.shape)}"
            )
        if t.device != P.device or not (on_cpu or t.is_contiguous()):
            raise ValueError(
                f"{name}: every operand must be a contiguous tensor on "
                f"{P.device}"
            )
    if counts.dtype != torch.int32 or tuple(counts.shape) != (C,):
        raise ValueError(f"{name}: counts must be int32 of shape ({C},)")
    if counts.device != P.device or not (on_cpu or counts.is_contiguous()):
        raise ValueError(f"{name}: counts must be contiguous on {P.device}")
    return on_cpu


def _vec(dim, cap, C):
    return (dim, cap, C)


def _scl(dim, cap, C):
    return (cap, C)


# The kernels' ids in the CUDA source (``Kern``).
_KERNEL_IDS = {"cubic": 0, "poly6": 1, "spiky": 2, "viscosity": 3}


@functools.lru_cache(maxsize=None)
def _pair_params(h, dim):
    """The constants of every SPH kernel as the C entry points take them:
    the floats of ``Params`` in ``csrc/pair_passes.cu``, in its order,
    folded in float64 and rounded to float32 once (as ``kernels/sph.py``
    hands its Python-float constants to float32 tensors). ``queue_r2``
    bounds r^2 of every pair with sqrtf(r^2) <= float32(h) (such an r is
    below h (1 + 2^-24)): rounded up from (h (1 + 2^-22))^2."""
    import ctypes

    from . import _build

    inv_h2 = 1.0 / (h * h)
    norm = _cubic_normalizer(h, dim)
    hf = float(np.float32(h))
    queue_r2 = np.nextafter(np.float32((hf * (1.0 + 2.0**-22)) ** 2),
                            np.float32(np.inf))
    vals = (inv_h2, norm, norm * inv_h2, h * h, h, float(queue_r2),
            _poly6_normalizer(h, dim), _spiky_normalizer(h, dim),
            _viscosity_normalizer(h, dim), 2.0 * h, 2.0 * (h * h * h))
    if len(vals) != _build.load().salva_pair_params():
        raise RuntimeError("pair passes: the kernels read another Params")
    return (ctypes.c_float * len(vals))(*vals)


def _grid_args(spec, dim, P):
    """(dim, cap, C, ny, nz): the grid shape as the C entry points take
    it (flat shifts are computed in the kernel from ny and nz)."""
    dims = spec.dims
    nz = dims[2] if len(dims) == 3 else 1
    return dim, P.shape[1], P.shape[2], dims[1], nz


def _launch(name, fn, *args, device):
    """Launch the C entry ``fn``, counting it under ``LAUNCHES[name]``
    unless there was nothing to launch (``_build.launch``)."""
    from . import _build

    _build.launch(LAUNCHES, name, fn, *args, device=device)


# The tiled kernels, as ``salva_pass_tiling`` numbers them (hoist_ff
# without and with s2).
_TILED = {("k_pass", False): 0, ("t_pass", False): 1,
          ("hoist_ff", False): 2, ("hoist_ff", True): 3,
          ("artificial_visc_ff", False): 4}


def tiling(name, dim, cap, C, need_s2=False, kernel_density="cubic",
           kernel_gradient="cubic"):
    """How the ``k_pass``, ``t_pass``, ``hoist_ff`` (with or without
    ``need_s2``) or ``artificial_visc_ff`` kernel of the named SPH kernels
    tiles a [cap, C] grid on
    the current CUDA device: ``tile`` (consecutive cells a block owns),
    ``smem`` (bytes of shared memory a block takes), ``blocks`` (blocks a
    launch runs) and ``per_sm`` (blocks resident on one SM)."""
    import ctypes

    from . import _build

    key = (name, bool(need_s2) and name == "hoist_ff")
    if key not in _TILED:
        raise ValueError(f"only k_pass, t_pass, hoist_ff and "
                         f"artificial_visc_ff are tiled, not {name!r}")
    shape = (ctypes.c_int * 4)()
    err = _build.load().salva_pass_tiling(
        _TILED[key], dim, cap, C, _KERNEL_IDS[kernel_density],
        _KERNEL_IDS[kernel_gradient], ctypes.addressof(shape))
    if err != 0:
        raise RuntimeError(f"{name}: no tiling for dim {dim}, cap {cap} "
                           f"(CUDA error {err})")
    return dict(zip(("tile", "smem", "blocks", "per_sm"), shape))


def k_pass(spec, h, dim, kernel_gradient, P, M, K, counts):
    """K_i = sum_ff (k m)_j grad_ij -> [dim, cap, C]. On CUDA tensors
    one launch of the tiled kernel, which writes every slot: zeros for
    dead slots and air cells, an all-air grid included."""
    if _check("k_pass", spec, dim, (kernel_gradient,),
              [(P, _vec), (M, _scl), (K, _scl)], counts):
        return k_pass_plain(spec, h, dim, kernel_gradient, P, M, K, counts)
    out = torch.empty_like(P)
    _launch("k_pass", "salva_k_pass", P.data_ptr(), M.data_ptr(),
            K.data_ptr(), counts.data_ptr(), out.data_ptr(),
            *_grid_args(spec, dim, P), _KERNEL_IDS[kernel_gradient],
            _pair_params(h, dim), device=P.device)
    return out


def k_pass_v2(spec, h, dim, kernel_gradient, P, M, K, counts):
    """``k_pass`` by live 8-slot groups (``k_pass_pallas2``) -> [dim, cap,
    C]; dead slots of a live group must hold the sentinel and zero mass.
    On CUDA tensors one launch of the tiled ``k_pass`` kernel."""
    if _check("k_pass_v2", spec, dim, (kernel_gradient,),
              [(P, _vec), (M, _scl), (K, _scl)], counts):
        return k_pass_plain(spec, h, dim, kernel_gradient, P, M, K, counts)
    out = torch.empty_like(P)
    _launch("k_pass_v2", "salva_k_pass_v2", P.data_ptr(), M.data_ptr(),
            K.data_ptr(), counts.data_ptr(), out.data_ptr(),
            *_grid_args(spec, dim, P), _KERNEL_IDS[kernel_gradient],
            _pair_params(h, dim), device=P.device)
    return out


def t_pass(spec, h, dim, kernel_gradient, P, M, Q, counts):
    """T_i = sum_ff m_j (Q_j . grad_ij) -> [cap, C]; launched and written
    as :func:`k_pass`."""
    if _check("t_pass", spec, dim, (kernel_gradient,),
              [(P, _vec), (M, _scl), (Q, _vec)], counts):
        return t_pass_plain(spec, h, dim, kernel_gradient, P, M, Q, counts)
    out = torch.empty_like(M)
    _launch("t_pass", "salva_t_pass", P.data_ptr(), M.data_ptr(),
            Q.data_ptr(), counts.data_ptr(), out.data_ptr(),
            *_grid_args(spec, dim, P), _KERNEL_IDS[kernel_gradient],
            _pair_params(h, dim), device=P.device)
    return out


def hoist_ff(spec, h, dim, kernel_density, kernel_gradient, P, M, counts,
             need_s2=True):
    """(rho_ff, Gf, sq_ff, s2_ff, cnt_ff); s2 is zero unless ``need_s2``.
    On CUDA tensors one launch of the tiled kernel, which writes every
    slot of one packed [dim + 4, cap, C] allocation; the outputs are
    contiguous views of it (the count plane as int32)."""
    if _check("hoist_ff", spec, dim, (kernel_density, kernel_gradient),
              [(P, _vec), (M, _scl)], counts):
        return hoist_ff_plain(spec, h, dim, kernel_density, kernel_gradient,
                              P, M, counts, need_s2=need_s2)
    out = torch.empty((dim + 4,) + tuple(M.shape), dtype=torch.float32,
                      device=P.device)
    _launch("hoist_ff", "salva_hoist_ff", P.data_ptr(), M.data_ptr(),
            counts.data_ptr(), out.data_ptr(), *_grid_args(spec, dim, P),
            int(bool(need_s2)), _KERNEL_IDS[kernel_density],
            _KERNEL_IDS[kernel_gradient], _pair_params(h, dim),
            device=P.device)
    return (out[0], out[1:1 + dim], out[1 + dim], out[2 + dim],
            out[3 + dim].view(torch.int32))


def _check_fb(dim, C, on_cpu, device, Pb, Volb, Vbvel, counts_b,
              cell_to_col, cols):
    """Validate ``hoist_fb``'s boundary-side operands (see
    :func:`hoist_fb_plain`); raise on anything the kernel does not take."""
    if Pb.ndim != 3 or Pb.shape[0] != dim:
        raise ValueError("hoist_fb: expected boundary positions "
                         "[dim, cap_b, Cb]")
    cap_b, Cb = Pb.shape[1], Pb.shape[2]
    ints = [(counts_b, (Cb,), "counts_b")]
    if cell_to_col is None:
        if Cb != C or cols is not None:
            raise ValueError(
                "hoist_fb: without a cell_to_col map the boundary grid is "
                f"the fluid grid ({C} columns, got {Cb}) and every column "
                "is visited (cols=None)"
            )
    else:
        ints.append((cell_to_col, (C + 1,), "cell_to_col"))
    if cols is not None:
        if cols.ndim != 1:
            raise ValueError("hoist_fb: cols must be one-dimensional")
        ints.append((cols, tuple(cols.shape), "cols"))
    for t, shape in ((Pb, (dim, cap_b, Cb)), (Volb, (cap_b, Cb)),
                     (Vbvel, (dim, cap_b, Cb))):
        if t.dtype != torch.float32:
            raise TypeError(f"hoist_fb: expected float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"hoist_fb: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    for t, shape, name in ints:
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"hoist_fb: {name} must be int32 of shape "
                             f"{shape}")
    for t in [Pb, Volb, Vbvel] + [t for t, _, _ in ints]:
        if t.device != device or not (on_cpu or t.is_contiguous()):
            raise ValueError(
                f"hoist_fb: every operand must be a contiguous tensor on "
                f"{device}"
            )
    return cap_b, Cb


def hoist_fb(spec, h, dim, kernel_density, kernel_gradient, P, counts, Pb,
             Volb, Vbvel, counts_b, cell_to_col=None, cols=None,
             need_s2=True):
    """(rho_fb, Gb, sq_fb, s2_fb, Sb, cnt_fb) on the full [cap_f, C] fluid
    grid; operands as :func:`hoist_fb_plain`. On CUDA tensors two
    launches: one zero fill of a packed [dim + 5, cap, C] allocation, of
    which the outputs are contiguous views (the count plane as int32),
    and the kernel, which writes the live slots of the listed columns."""
    on_cpu = _check("hoist_fb", spec, dim, (kernel_density, kernel_gradient),
                    [(P, _vec)], counts)
    cap_b, Cb = _check_fb(dim, P.shape[2], on_cpu, P.device, Pb, Volb, Vbvel,
                          counts_b, cell_to_col, cols)
    if on_cpu:
        return hoist_fb_plain(spec, h, dim, kernel_density, kernel_gradient,
                              P, counts, Pb, Volb, Vbvel, counts_b,
                              cell_to_col=cell_to_col, cols=cols,
                              need_s2=need_s2)
    dim_, cap, C, ny, nz = _grid_args(spec, dim, P)
    out = torch.zeros((dim + 5, cap, C), dtype=torch.float32,
                      device=P.device)
    n_cols = C if cols is None else cols.shape[0]
    _launch("hoist_fb", "salva_hoist_fb", P.data_ptr(), counts.data_ptr(),
            None if cols is None else cols.data_ptr(), n_cols,
            Pb.data_ptr(), Volb.data_ptr(), Vbvel.data_ptr(),
            counts_b.data_ptr(),
            None if cell_to_col is None else cell_to_col.data_ptr(),
            out.data_ptr(), dim_, cap, C, cap_b, Cb, ny, nz,
            int(bool(need_s2)), _KERNEL_IDS[kernel_density],
            _KERNEL_IDS[kernel_gradient], _pair_params(h, dim),
            device=P.device)
    return (out[0], out[1:1 + dim], out[1 + dim], out[2 + dim], out[3 + dim],
            out[4 + dim].view(torch.int32))


@functools.lru_cache(maxsize=None)
def _fluid_table(rows, device):
    """[n_fluids, 4] float32 on ``device``: each fluid's (coeff, alpha,
    beta, c_s), rounded to float32 as :func:`per_slot` rounds them; one
    copy to the device per distinct table."""
    return torch.tensor(rows, dtype=torch.float32, device=device)


def artificial_visc_ff(spec, h, dim, kernel_gradient, P, V, VOL, RHO, R0,
                       FID, counts, coefficients, alphas, betas,
                       speeds_of_sound):
    """The artificial viscosity's fluid-fluid acceleration -> [dim, cap,
    C]: ``P`` / ``V`` [dim, cap, C], ``VOL`` / ``RHO`` / ``R0`` [cap, C]
    float32, ``FID`` [cap, C] int32, and the per-fluid coefficient, alpha,
    beta and speed-of-sound tuples (one entry per fluid; see
    :func:`artificial_visc_ff_fold`). On CUDA tensors one launch of the
    tiled kernel, which writes every slot: zeros for dead slots and air
    cells."""
    tables = (coefficients, alphas, betas, speeds_of_sound)
    if _check("artificial_visc_ff", spec, dim, (kernel_gradient,),
              [(P, _vec), (V, _vec), (VOL, _scl), (RHO, _scl), (R0, _scl)],
              counts):
        return artificial_visc_ff_plain(spec, h, dim, kernel_gradient, P, V,
                                        VOL, RHO, R0, FID, counts, *tables)
    if (FID.dtype != torch.int32 or FID.shape != VOL.shape
            or FID.device != P.device or not FID.is_contiguous()):
        raise ValueError("artificial_visc_ff: FID must be contiguous int32 "
                         f"of shape {tuple(VOL.shape)} on {P.device}")
    n_fluids = len(coefficients)
    if n_fluids == 0 or any(len(t) != n_fluids for t in tables):
        raise ValueError("artificial_visc_ff: one coefficient, alpha, beta "
                         "and speed of sound per fluid")
    table = _fluid_table(tuple(zip(*(map(float, t) for t in tables))),
                         P.device)
    out = torch.empty_like(P)
    _launch("artificial_visc_ff", "salva_visc_ff", P.data_ptr(),
            V.data_ptr(), VOL.data_ptr(), RHO.data_ptr(), R0.data_ptr(),
            FID.data_ptr(), table.data_ptr(), n_fluids, counts.data_ptr(),
            out.data_ptr(), *_grid_args(spec, dim, P),
            _KERNEL_IDS[kernel_gradient], h * h * 0.01,
            _pair_params(h, dim), device=P.device)
    return out
