"""Pair counts at near ties r^2 = h^2: the fixture of the ``gpu`` test
``tests/test_torch_kernels.py::test_pair_counts_at_near_ties``, checked
on the CPU.

The pair counts of ``hoist_ff`` / ``hoist_fb`` count a pair when r^2 <=
h^2. The plain versions (and the JAX package on the CPU) compute r^2 =
dp_0^2 + dp_1^2 (+ dp_2^2) rounding each product and each sum; a CUDA
compiler contracts ``r2 + dp * dp`` into a fused multiply-add, one
rounding fewer, fusing either product of a sum. :func:`near_tie_pairs`
finds seeded pairs on which every fused form and the rounded one fall on
either side of h^2 (fused <= h^2 < rounded), emulating the fused forms
in float64: each float32 product is exact in float64, and each fused sum
is taken only where float64 holds it exactly, so one rounding to float32
is the fused multiply-add's. :func:`near_tie_grid`
lays them out on a dense grid. This module imports numpy and the port
only (no JAX): the ``gpu`` test imports it on a machine without JAX.
"""

import types

import numpy as np
import pytest
import torch

from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.ops import pair

torch.set_num_threads(1)

H = 0.2
# Grid cells between two pairs' sites: a pair spans at most two cells, so
# particles of different sites lie more than h apart.
SITE_SPACING = 4


def _exact_sum(a, b):
    """a + b in float64, and whether it is exact (TwoSum's error is 0)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err == 0.0


def r2_rounded(dp):
    """r^2 of float32 [n, dim] differences, each product and sum rounded
    to float32 (the plain versions' form)."""
    r2 = dp[:, 0] * dp[:, 0]
    for d in range(1, dp.shape[1]):
        r2 = r2 + dp[:, d] * dp[:, d]
    return r2


def _fma(a, b, c):
    """(float32(a * b + c) with one rounding, whether float64 held the sum
    exactly): ``a``, ``b`` float64 holding float32 values, ``c`` float32."""
    s, exact = _exact_sum(a * b, c.astype(np.float64))
    return s.astype(np.float32), exact


def r2_fused_forms(dp):
    """r^2 of float32 [n, dim] differences under every way a compiler may
    contract ``r2 = dp_0 * dp_0; r2 = r2 + dp_d * dp_d`` into fused
    multiply-adds (at each sum either product may be fused; the last sum
    fuses dp_2^2): a list of (r^2, whether each step was emulated
    exactly)."""
    d = dp.astype(np.float64)
    p = [(d[:, k] * d[:, k]).astype(np.float32) for k in range(dp.shape[1])]
    forms = [_fma(d[:, 1], d[:, 1], p[0]), _fma(d[:, 0], d[:, 0], p[1])]
    # 3D: the inner sum fused either way or not at all, then dp_2^2 fused.
    if dp.shape[1] == 3:
        inner = forms + [(p[0] + p[1], np.ones(len(dp), bool))]
        forms = []
        for r2, ok in inner:
            out, ok2 = _fma(d[:, 2], d[:, 2], r2)
            forms.append((out, ok & ok2))
    return forms


def splits(dp, h2, forms=None):
    """Pairs whose rounded r^2 > h2 while each fused form of
    :func:`r2_fused_forms` named in ``forms`` (all when None) is <= h2,
    emulated exactly."""
    hit = r2_rounded(dp) > h2
    for k, (r2, exact) in enumerate(r2_fused_forms(dp)):
        if forms is None or k in forms:
            hit &= exact & (r2 <= h2)
    return hit


def near_tie_pairs(n_pairs: int, dim: int, seed: int, centers):
    """``n_pairs`` float32 pairs (p_i at ``centers[k]`` jittered, p_j about h
    away) whose rounded r^2 > float32(h^2) while fused r^2 <= h^2. Returns
    (p_i, p_j), each [n_pairs, dim].

    In 3D every pair splits under each fused form. In 2D no pair can: a
    form differs from the rounded r^2 by the rounding error of the one
    product it fuses, and the two forms fuse different products; so pair
    k splits under form k % 2 (the one that fuses the larger product),
    and either contraction a compiler picks miscounts half the pairs.

    p_j is searched around p_i + h u over a few float32 ulps of each
    coordinate. A step of one ulp in coordinate d moves r^2 by about
    2 |dp_d| ulp(p_d), tens of ulps of h^2 where |dp_d| ~ h; so one
    component of u is kept small, and that coordinate's steps sweep r^2
    across h^2 about one ulp of h^2 at a time."""
    rng = np.random.default_rng(seed)
    h2 = np.float32(H * H)
    out_i, out_j = [], []
    tries = 0
    while len(out_i) < n_pairs:
        k = len(out_i)
        # 2D: form 0 fuses dp_1^2 (small dp_0), form 1 fuses dp_0^2.
        tilt_axis, forms = ((k % 2, [k % 2]) if dim == 2 else (0, None))
        axes = [np.arange(-3, 4)] * dim
        axes[tilt_axis] = np.arange(-64, 65)
        steps = np.stack(np.meshgrid(*axes, indexing="ij"),
                         -1).reshape(-1, dim)
        c = np.asarray(centers[k], np.float64)
        pi = (c + rng.uniform(-0.2, 0.2, dim) * H).astype(np.float32)
        u = rng.normal(size=dim)
        u[tilt_axis] = 0.0
        tilt = rng.uniform(-0.03, 0.03)
        u = u / np.linalg.norm(u) * np.sqrt(1.0 - tilt * tilt)
        u[tilt_axis] = tilt
        pj0 = (pi + u * H).astype(np.float32)
        pj = (pj0 + steps * np.spacing(np.abs(pj0))).astype(np.float32)
        hit = splits(pi[None, :] - pj, h2, forms)
        if hit.any():
            out_i.append(pi)
            out_j.append(pj[np.flatnonzero(hit)[0]])
        tries += 1
        assert tries < 20 * n_pairs, "no near ties found"
    return np.stack(out_i), np.stack(out_j)


def near_tie_grid(dim: int, device, seed: int = 0):
    """The near-tie fixture on a dense grid of cell width h, one pair a
    site (sites SITE_SPACING cells apart), plus a third particle at h / 2
    from each p_i, away from p_j (every site counts a pair on both
    rules). Returns a
    namespace: ``spec``; the fluid of all three particles ``P``, ``M``,
    ``counts`` (``hoist_ff``); the fluid of the p_i and the third
    particles ``P_i``, ``M_i``, ``counts_i`` against the boundary of the
    p_j ``Pb``, ``Volb``, ``Vb``, ``counts_b`` (``hoist_fb``, full-grid
    layout); the pairs ``pi``, ``pj``."""
    per_axis = 4 if dim == 3 else 8
    dims = (SITE_SPACING * per_axis + 2,) * dim
    spec = tdg.DenseGridSpec(origin=(0.0,) * dim, dims=dims, cap=8,
                             cell_width=H)
    ticks = (2 + SITE_SPACING * np.arange(per_axis) + 0.5) * H
    centers = np.stack(np.meshgrid(*([ticks] * dim), indexing="ij"),
                       -1).reshape(-1, dim)
    pi, pj = near_tie_pairs(len(centers), dim, seed, centers)
    # The third particle on the far side of p_i from p_j (1.5 h from p_j).
    away = (pi - pj).astype(np.float64)
    pk = pi + 0.5 * H * away / np.linalg.norm(away, axis=1, keepdims=True)
    pk = pk.astype(np.float32)

    def grid(points):
        pos = torch.from_numpy(points).to(device)
        alive = torch.ones(len(points), dtype=torch.bool, device=device)
        b = tdg.bin_particles(spec, pos, alive)
        assert int(b.overflow) == 0 and int(b.clamped) == 0
        (P,) = tdg.to_grid_multi(spec, b, [(pos, tdg.POS_SENTINEL)])
        counts = (b.mask > 0).sum(dim=0, dtype=torch.int32)
        return P, b.mask, counts

    P, M, counts = grid(np.concatenate([pi, pj, pk]))
    P_i, M_i, counts_i = grid(np.concatenate([pi, pk]))
    Pb, Mb, counts_b = grid(pj)
    return types.SimpleNamespace(
        spec=spec, P=P, M=M, counts=counts, P_i=P_i, M_i=M_i,
        counts_i=counts_i, Pb=Pb, Volb=Mb * 1e-3,
        Vb=torch.zeros((dim,) + tuple(Mb.shape), device=device),
        counts_b=counts_b, pi=pi, pj=pj)


@pytest.mark.parametrize("dim", [2, 3])
def test_near_tie_fixture_separates_the_two_roundings(dim):
    """The fixture's pairs lie outside h under the rounded r^2 and inside
    under the fused forms (in 3D every form; in 2D every other pair under
    each), and the plain versions (on the CPU) count them as the rounded
    form does. So a kernel that fuses r^2, whichever product it fuses,
    counts at least a pair more at each end of half the sites in
    ``hoist_ff`` and at one end in ``hoist_fb``, and the ``gpu`` test
    cannot pass on kernels that fuse it."""
    h2 = np.float32(H * H)
    g = near_tie_grid(dim, "cpu")
    n = len(g.pi)
    assert n == 64
    dp = g.pi - g.pj
    forms = r2_fused_forms(dp)
    assert len(forms) == (2 if dim == 2 else 3)
    split = [splits(dp, h2, [k]) for k in range(len(forms))]
    assert (r2_rounded(dp) > h2).all()
    for k, hit in enumerate(split):
        if dim == 3:
            assert hit.all()
        else:
            assert hit[k::2].all()
    # Plain counts: each particle counts itself, and each p_i and its
    # third particle see one another; no p_j is seen.
    ff = pair.hoist_ff_plain(g.spec, H, dim, "cubic", "cubic", g.P, g.M,
                             g.counts)
    assert int(ff[-1].sum()) == 3 * n + 2 * n
    fb = pair.hoist_fb_plain(g.spec, H, dim, "cubic", "cubic", g.P_i,
                             g.counts_i, g.Pb, g.Volb, g.Vb, g.counts_b)
    assert int(fb[-1].sum()) == 0
    # All pairs of the grid's particles: under each fused form, each split
    # pair counts from both ends, and nothing else changes.
    pos = g.P.permute(1, 2, 0).reshape(-1, dim)[g.M.reshape(-1) > 0].numpy()
    d = (pos[:, None, :] - pos[None, :, :]).reshape(-1, dim)
    off_diag = ~np.eye(len(pos), dtype=bool).reshape(-1)
    assert int(((r2_rounded(d) <= h2) & off_diag).sum()) == 2 * n
    for (r2, exact), hit in zip(r2_fused_forms(d), split):
        assert exact[off_diag & (r2 <= 2 * h2)].all()
        assert int(((r2 <= h2) & off_diag).sum()) == 2 * n + 2 * int(
            hit.sum())
