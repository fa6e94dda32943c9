"""The binning's sorted-to-slot expansion: per-particle channels into the
dense ``[cap, C]`` slot layout.

One binning (a ``Binned`` of the fluid grid or an ``ActiveBinned`` of the
compact boundary table) and a list of float32 per-particle channels, each
with its fill value, go in; for every slot (r, c) and channel k

    out_k[r, c] = vals_k[order[start[c] + r]]  if r < min(count[c], cap)
                = fill_k                        otherwise,

from the binning's run table (``order``: the stable sort of the particles
by cell; ``start`` / ``count``: each column's first sorted index and
particle count). It is every layout shuffle of the binnings into the
grid (``geometry.dense_grid.to_grid`` / ``to_grid_multi``), bitwise the
JAX package's ``packed[grid_src]`` gather: ``[N]`` values give a
``[cap, C]`` plane, ``[N, D]`` values a ``[D, cap, C]`` stack, every one a
contiguous view of one output buffer.

``expand`` launches the hand-written CUDA kernel (``csrc/expand.cu``,
the port of the Pallas prototype ``tools/exp_pallas_expand.py``) for CUDA
tensors, and runs ``expand_plain`` (the run-table index arithmetic in
PyTorch) for CPU tensors; every launch adds one to ``LAUNCHES["expand"]``.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"expand": 0}
MAX_CHANNELS = 16  # csrc/expand.cu kMaxChannels


def reset_launches():
    LAUNCHES["expand"] = 0


def _channels(items):
    """(per-channel [N] views, per-channel fills, per-item widths)."""
    chans, fills, widths = [], [], []
    for vals, fill in items:
        if vals.ndim == 1:
            chans.append(vals)
            fills.append(float(fill))
            widths.append(0)
        else:
            for d in range(vals.shape[1]):
                chans.append(vals[:, d])
                fills.append(float(fill))
            widths.append(vals.shape[1])
    return chans, fills, widths


def _split(out, widths):
    """The output buffer [nch, cap, C] as one view per item."""
    grids, k = [], 0
    for w in widths:
        grids.append(out[k] if w == 0 else out[k:k + w])
        k += max(w, 1)
    return grids


def _check(binned, items):
    """Validate the run table and the channels; returns (cap, C, the
    channels, their fills, the item widths)."""
    order, start, count = binned.order, binned.start, binned.count
    if order is None or start is None or count is None:
        raise ValueError("expand: the binning carries no run table")
    cap, C = binned.mask.shape
    dev = order.device
    for t, name in ((order, "order"), (start, "start"), (count, "count")):
        if t.dtype != torch.int32 or t.ndim != 1 or t.device != dev:
            raise ValueError(f"expand: {name} must be int32 [.] on {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"expand: {name} must be contiguous")
    if start.shape != (C,) or count.shape != (C,):
        raise ValueError(f"expand: start and count must have {C} entries")
    if not items:
        raise ValueError("expand: no channels")
    n = order.shape[0]
    for vals, _ in items:
        if vals.dtype != torch.float32:
            raise TypeError(f"expand: expected float32, got {vals.dtype}")
        if vals.ndim not in (1, 2) or vals.shape[0] != n:
            raise ValueError(f"expand: expected values [{n}] or [{n}, D], "
                             f"got {tuple(vals.shape)}")
        if vals.device != dev:
            raise ValueError(f"expand: values must lie on {dev}")
    chans, fills, widths = _channels(items)
    return cap, C, chans, fills, widths


def expand_plain(binned, items):
    """The plain PyTorch version: the slot -> sorted-row index arithmetic
    of the run table, then one gather per channel."""
    cap, C, chans, fills, widths = _check(binned, items)
    dev = binned.order.device
    r = torch.arange(cap, dtype=torch.int32, device=dev)
    valid = r[:, None] < torch.clamp(binned.count, max=cap)[None, :]
    src = torch.where(valid, binned.start[None, :] + r[:, None], 0).long()
    out = torch.empty((len(chans), cap, C), dtype=torch.float32, device=dev)
    idx = binned.order[src].long()  # [cap, C]
    for k, (vals, fill) in enumerate(zip(chans, fills)):
        out[k] = torch.where(valid, vals[idx], fill)
    return _split(out, widths)


def expand(binned, items):
    """``items``: ``[(values [N] or [N, D] float32, fill)]`` -> one grid
    per item, ``[cap, C]`` or ``[D, cap, C]`` (see the module note). CPU
    tensors run :func:`expand_plain`; CUDA tensors launch the kernel (one
    launch for all channels) or raise."""
    cap, C, chans, fills, widths = _check(binned, items)
    dev = binned.order.device
    if dev.type == "cpu":
        return expand_plain(binned, items)
    if dev.type != "cuda":
        raise RuntimeError(f"expand runs on CPU (plain) or CUDA (kernel) "
                           f"tensors, got {dev}")
    nch = len(chans)
    if nch > MAX_CHANNELS:
        raise ValueError(f"expand: {nch} channels, the kernel takes at most "
                         f"{MAX_CHANNELS}")
    out = torch.empty((nch, cap, C), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * nch)(*[v.data_ptr() for v in chans])
    strides = (ctypes.c_longlong * nch)(*[v.stride(0) for v in chans])
    fill_arr = (ctypes.c_float * nch)(*fills)
    from . import _build

    _build.launch(LAUNCHES, "expand", "salva_expand",
                  binned.order.data_ptr(), binned.start.data_ptr(),
                  binned.count.data_ptr(), cap, C, nch, ptrs, strides,
                  fill_arr, out.data_ptr(), device=dev)
    return _split(out, widths)
