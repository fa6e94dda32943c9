"""SPH smoothing kernels on torch tensors.

Port of ``salva_tpu.kernels.sph`` (the reference kernel set,
``src/kernel/``): cubic spline (the default for every solver), Poly6,
Spiky and Müller viscosity kernels. Every function is a branch-free
(``torch.where``) elementwise map over tensors of any shape.

All kernels take ``r`` (non-negative distances, float32), the support
radius ``h`` (a Python float) and the spatial dimension ``dim``; each
returns W(r, h) or the radial derivative dW/dr(r, h).
"""

from __future__ import annotations

import math

import torch

# Matches `Real::default_epsilon()` (f32::EPSILON) used by the reference to
# guard direction normalization (`src/kernel/kernel.rs:20-26`).
EPSILON = float(torch.finfo(torch.float32).eps)

# Derivative cutoff of the cubic spline (`cubic_spline_kernel.rs:71`).
_CUBIC_DIFF_EPS = 1.0e-5


def _cubic_normalizer(h, dim: int):
    # 2D: 40 / (7 pi h^2); 3D: 8 / (pi h^3)  (`cubic_spline_kernel.rs:15-18`).
    if dim == 2:
        return (40.0 / 7.0) / (math.pi * h * h)
    return 8.0 / (math.pi * h * h * h)


def cubic_w(r, h, dim: int):
    """Cubic spline kernel W(r, h) (`cubic_spline_kernel.rs:12-52`)."""
    normalizer = _cubic_normalizer(h, dim)
    q = r / h
    q2 = q * q
    near = 1.0 + (q2 * q - q2) * 6.0
    one_q = 1.0 - q
    far = one_q * one_q * one_q * 2.0
    rhs = torch.where(q <= 0.5, near, torch.where(q <= 1.0, far, 0.0))
    return normalizer * rhs


def cubic_dw(r, h, dim: int):
    """Cubic spline radial derivative (`cubic_spline_kernel.rs:55-101`)."""
    normalizer = _cubic_normalizer(h, dim)
    q = r / h
    near = (q * 3.0 - 2.0) * q * 6.0
    one_q = 1.0 - q
    far = -one_q * one_q * 6.0
    rhs = torch.where(
        (q > 1.0) | (q <= _CUBIC_DIFF_EPS),
        0.0,
        torch.where(q <= 0.5, near, far),
    )
    return normalizer * rhs / h


def _poly6_normalizer(h, dim: int):
    if dim == 2:
        return 4.0 / (math.pi * h**8)
    return (315.0 / 64.0) / (math.pi * h**9)


def poly6_w(r, h, dim: int):
    """Poly6 kernel (`poly6_kernel.rs:12-25`)."""
    hh_rr = h * h - r * r
    return torch.where(
        r <= h, _poly6_normalizer(h, dim) * hh_rr * hh_rr * hh_rr, 0.0
    )


def poly6_dw(r, h, dim: int):
    """Poly6 radial derivative (`poly6_kernel.rs:27-40`)."""
    hh_rr = h * h - r * r
    return torch.where(
        r <= h, _poly6_normalizer(h, dim) * hh_rr * hh_rr * r * -6.0, 0.0
    )


def _spiky_normalizer(h, dim: int):
    if dim == 2:
        return 10.0 / (math.pi * h**5)
    return 15.0 / (math.pi * h**6)


def spiky_w(r, h, dim: int):
    """Spiky kernel (`spiky_kernel.rs:12-25`)."""
    h_r = h - r
    return torch.where(
        r <= h, _spiky_normalizer(h, dim) * h_r * h_r * h_r, 0.0
    )


def spiky_dw(r, h, dim: int):
    """Spiky radial derivative (`spiky_kernel.rs:27-40`)."""
    h_r = h - r
    return torch.where(
        r <= h, -_spiky_normalizer(h, dim) * h_r * h_r * 3.0, 0.0
    )


def _rdiv(a: float, t):
    """``a / t`` for a Python number ``a``, as a true float32 division
    (torch evaluates ``a / t`` as ``reciprocal(t) * a``, which rounds
    twice)."""
    return torch.as_tensor(a, dtype=t.dtype, device=t.device) / t


def _viscosity_normalizer(h, dim: int):
    if dim == 2:
        return 10.0 / (3.0 * math.pi * h * h)
    return 15.0 / (2.0 * math.pi * h**3)


def viscosity_w(r, h, dim: int):
    """Müller viscosity kernel (`viscosity_kernel.rs:12-30`)."""
    normalizer = _viscosity_normalizer(h, dim)
    r_safe = torch.where(r > 0.0, r, 1.0)
    rr_hh = r * r / (h * h)
    val = normalizer * (
        rr_hh * (1.0 - r / (2.0 * h)) + _rdiv(h, 2.0 * r_safe) - 1.0
    )
    return torch.where((r > 0.0) & (r <= h), val, 0.0)


def viscosity_dw(r, h, dim: int):
    """Müller viscosity radial derivative (`viscosity_kernel.rs:32-51`)."""
    normalizer = _viscosity_normalizer(h, dim)
    rr = r * r
    hh = h * h
    hhh = hh * h
    rr_safe = torch.where(rr > 0.0, rr, 1.0)
    val = normalizer * (
        -3.0 * rr / (2.0 * hhh) + 2.0 * r / hh - _rdiv(h, 2.0 * rr_safe)
    )
    return torch.where((r > 0.0) & (r <= h), val, 0.0)


KERNELS = {
    "cubic": (cubic_w, cubic_dw),
    "poly6": (poly6_w, poly6_dw),
    "spiky": (spiky_w, spiky_dw),
    "viscosity": (viscosity_w, viscosity_dw),
}


def get_kernel(name: str):
    """Return the (W, dW/dr) pair for a kernel name."""
    try:
        return KERNELS[name]
    except KeyError:
        raise KeyError(
            f"unknown SPH kernel {name!r}; available: {sorted(KERNELS)}"
        ) from None


def w_dwr(r2, h, dim, w_fn, dw_fn):
    """(W, dW/dr / r) from squared distances, with the r ~ 0 gradient
    cutoff (`kernel.rs:19-26`); ``salva_tpu.solver.dense_common.w_dwr``.

    The cubic-spline default takes a fused path that evaluates dW/r
    directly from r² — one sqrt and one rsqrt, no division — the same
    arithmetic as the hand kernels of ``ops/pair.py``."""
    if w_fn is cubic_w and dw_fn is cubic_dw:
        norm = _cubic_normalizer(h, dim)
        inv_h2 = 1.0 / (h * h)
        q2 = r2 * inv_h2
        q = torch.sqrt(q2)
        # W(q): 1 + 6(q^3 - q^2) near, 2(1-q)^3 far.
        near_w = 1.0 + (q2 * q - q2) * 6.0
        one_q = 1.0 - q
        far_w = one_q * one_q * one_q * 2.0
        w = norm * torch.where(
            q <= 0.5, near_w, torch.where(q <= 1.0, far_w, 0.0)
        )
        # dW/dr / r = norm/h^2 * [ (18q - 12)          q <= 0.5
        #                          -6 (1-q)^2 / q      0.5 < q <= 1 ].
        rq = torch.rsqrt(torch.clamp(q2, min=1.0e-12))
        far_d = -6.0 * one_q * one_q * rq
        near_d = 18.0 * q - 12.0
        cut = (q > 1.0) | (q <= _CUBIC_DIFF_EPS)
        dwr = (norm * inv_h2) * torch.where(
            cut, 0.0, torch.where(q <= 0.5, near_d, far_d)
        )
        return w, dwr
    r = torch.sqrt(r2)
    w = w_fn(r, h, dim)
    safe_r = torch.where(r > EPSILON, r, 1.0)
    dwr = torch.where(r > EPSILON, dw_fn(r, h, dim) / safe_r, 0.0)
    return w, dwr
