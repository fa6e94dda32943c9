"""Hand-written CUDA kernels for the hot dense pair passes (``pair``) and
the binning's sorted-to-slot expansion (``binning``), with their plain
PyTorch versions. Importing this package builds nothing: the kernels
compile at their first launch (``_build``)."""

from .pair import (
    LAUNCHES,
    hoist_ff,
    hoist_ff_plain,
    k_pass,
    k_pass_plain,
    k_pass_v2,
    reset_launches,
    t_pass,
    t_pass_plain,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "k_pass",
    "k_pass_plain",
    "k_pass_v2",
    "t_pass",
    "t_pass_plain",
    "hoist_ff",
    "hoist_ff_plain",
]
