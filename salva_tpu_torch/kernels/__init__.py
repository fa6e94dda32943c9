"""SPH smoothing kernels (torch)."""

from .sph import (
    EPSILON,
    KERNELS,
    adhesion_kernel,
    cohesion_kernel,
    cubic_dw,
    cubic_w,
    get_kernel,
    grad_from_dpos,
    poly6_dw,
    poly6_w,
    spiky_dw,
    spiky_w,
    viscosity_dw,
    viscosity_w,
    w_dwr,
)

__all__ = [
    "EPSILON",
    "KERNELS",
    "adhesion_kernel",
    "cohesion_kernel",
    "cubic_w",
    "cubic_dw",
    "poly6_w",
    "poly6_dw",
    "spiky_w",
    "spiky_dw",
    "viscosity_w",
    "viscosity_dw",
    "get_kernel",
    "grad_from_dpos",
    "w_dwr",
]
