"""Hand-written CUDA kernels for the hot dense pair passes, with their
plain PyTorch versions (``pair``). Importing this package builds nothing:
the kernels compile at their first launch (``_build``)."""

from .pair import (
    LAUNCHES,
    hoist_ff,
    hoist_ff_plain,
    k_pass,
    k_pass_plain,
    reset_launches,
    t_pass,
    t_pass_plain,
)

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "k_pass",
    "k_pass_plain",
    "t_pass",
    "t_pass_plain",
    "hoist_ff",
    "hoist_ff_plain",
]
