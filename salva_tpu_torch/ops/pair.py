"""The three dense pair passes of the DFSPH main path.

Each pass has a hand-written CUDA kernel (``csrc/pair_passes.cu``) and a
plain PyTorch version beside it:

============  ==========================================  ===============
wrapper       computes, per live slot i of the [cap, C] grid  plain version
============  ==========================================  ===============
``k_pass``    K_i = sum_j (m k)_j grad_ij       [dim,cap,C]  ``k_pass_plain``
``t_pass``    T_i = sum_j m_j (Q_j . grad_ij)   [cap, C]     ``t_pass_plain``
``hoist_ff``  rho, Gf, sq, s2, pair count                    ``hoist_ff_plain``
============  ==========================================  ===============

(grad_ij = (p_i - p_j) dW/dr / r, summed over the 3^dim cell stencil.)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback. Every launch adds
one to ``LAUNCHES[name]``, so a run can show which passes went through
the kernels.

The plain versions are the half-stencil folds of
``salva_tpu.solver.dense_common.DenseCtx`` (``_k_pass_half``,
``_t_pass_half``, ``_hoist_ff_half``): each +/- offset pair of the
stencil shares one ``[cap, cap, C]`` pair block, whose mirrored j-side
sum is rolled back onto cell c + s. The kernels walk the full stencil
per output slot instead, so the two agree to float32 summation order.

All passes take the per-cell live counts ``counts`` ([C] int32, ranks
fill from 0, so slot (r, c) is live iff r < counts[c]); the plain hoist
rebuilds the occupancy mask from them.
"""

from __future__ import annotations

import torch

from ..geometry import dense_grid as dg
from ..kernels.sph import _cubic_normalizer, get_kernel, w_dwr

LAUNCHES = {"k_pass": 0, "t_pass": 0, "hoist_ff": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    if not on_cpu:
        for kn in kernel_names:
            if kn != "cubic":
                raise NotImplementedError(
                    f"{name}: the CUDA kernel implements the cubic spline "
                    f"only, got kernel {kn!r}"
                )
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


def _cubic_args(h, dim):
    inv_h2 = 1.0 / (h * h)
    norm = _cubic_normalizer(h, dim)
    return inv_h2, norm, norm * inv_h2, h * h


def _grid_args(spec, dim, P):
    """(dim, cap, C, ny, nz): the grid shape as the C entry points take
    it (flat shifts are computed in the kernel from ny and nz)."""
    dims = spec.dims
    nz = dims[2] if len(dims) == 3 else 1
    return dim, P.shape[1], P.shape[2], dims[1], nz


def _launch(name, fn, *args, device):
    from . import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {err})")
    LAUNCHES[name] += 1


def k_pass(spec, h, dim, kernel_gradient, P, M, K, counts):
    """K_i = sum_ff (k m)_j grad_ij -> [dim, cap, C]."""
    if _check("k_pass", spec, dim, (kernel_gradient,),
              [(P, _vec), (M, _scl), (K, _scl)], counts):
        return k_pass_plain(spec, h, dim, kernel_gradient, P, M, K, counts)
    out = torch.empty_like(P)
    _launch("k_pass", "salva_k_pass", P.data_ptr(), M.data_ptr(),
            K.data_ptr(), counts.data_ptr(), out.data_ptr(),
            *_grid_args(spec, dim, P), *_cubic_args(h, dim), device=P.device)
    return out


def t_pass(spec, h, dim, kernel_gradient, P, M, Q, counts):
    """T_i = sum_ff m_j (Q_j . grad_ij) -> [cap, C]."""
    if _check("t_pass", spec, dim, (kernel_gradient,),
              [(P, _vec), (M, _scl), (Q, _vec)], counts):
        return t_pass_plain(spec, h, dim, kernel_gradient, P, M, Q, counts)
    out = torch.empty_like(M)
    _launch("t_pass", "salva_t_pass", P.data_ptr(), M.data_ptr(),
            Q.data_ptr(), counts.data_ptr(), out.data_ptr(),
            *_grid_args(spec, dim, P), *_cubic_args(h, dim), device=P.device)
    return out


def hoist_ff(spec, h, dim, kernel_density, kernel_gradient, P, M, counts,
             need_s2=True):
    """(rho_ff, Gf, sq_ff, s2_ff, cnt_ff); s2 is zero unless ``need_s2``."""
    if _check("hoist_ff", spec, dim, (kernel_density, kernel_gradient),
              [(P, _vec), (M, _scl)], counts):
        return hoist_ff_plain(spec, h, dim, kernel_density, kernel_gradient,
                              P, M, counts, need_s2=need_s2)
    rho = torch.empty_like(M)
    gf = torch.empty_like(P)
    sq = torch.empty_like(M)
    s2 = torch.empty_like(M)
    cnt = torch.empty(M.shape, dtype=torch.int32, device=P.device)
    dim_, cap, C, ny, nz = _grid_args(spec, dim, P)
    _launch("hoist_ff", "salva_hoist_ff", P.data_ptr(), M.data_ptr(),
            counts.data_ptr(), rho.data_ptr(), gf.data_ptr(), sq.data_ptr(),
            s2.data_ptr(), cnt.data_ptr(), dim_, cap, C, ny, nz,
            int(bool(need_s2)), *_cubic_args(h, dim), device=P.device)
    return rho, gf, sq, s2, cnt
