"""The yardstick of the hand pair kernels: the least time the card could
take for a call, from the work the call's inputs need.

bound = max(bytes / HBM rate, float32 operations / float32 rate), the
form of ``chip_smoke.py``'s ``bound``, with its per-pair operation counts
(counted from ``csrc/pair_passes.cu``): for each pair within h, the cubic
gradient (14: one sqrt, one rsqrt), the cubic W for the hoists (11, one
shared with the gradient) and the pass's accumulations. What the inputs
need is counted, not what one algorithm spends: no operation for the
candidate pairs a cell list tests and rejects, and bytes only for each
live particle's inputs read once and its outputs written once, not the
padded cell grid of the program's layout. So neither a search nor a
layout can move the yardstick.
"""

from __future__ import annotations

# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM3
# bandwidth and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

OPS_DWR_CUBIC = 14
OPS_W_CUBIC = 11
OPS_ACC = {"k_pass": 8, "t_pass": 8, "hoist_ff": 24, "hoist_fb": 33}

# Each hand kernel by a substring of its profiler (demangled) name.
KERNEL_NAMES = (("k_pass", "KPass"), ("t_pass", "TPass"),
                ("hoist_ff", "HoistFF"), ("hoist_fb", "hoist_fb_warps"))


def kernel_kind(name: str):
    for kind, key in KERNEL_NAMES:
        if key in name:
            return kind
    return None


def ops_within(kind: str) -> int:
    """Float32 operations of one pair within h (cubic kernels): 22 for
    k_pass / t_pass, 48 for hoist_ff, 57 for hoist_fb."""
    ops = OPS_ACC[kind] + OPS_DWR_CUBIC
    if kind.startswith("hoist"):
        ops += OPS_W_CUBIC - 1
    return ops


def bound_s(read_bytes, written_bytes, within, kind):
    """(seconds, "bytes" or "operations") of a call over ``within`` pairs
    within h."""
    ops = ops_within(kind) * within
    t_bytes = (read_bytes + written_bytes) / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def call_bound_s(kind: str, st) -> float:
    """The bound of one call of ``kind`` at step state ``st`` (see
    ``step_state``): inputs and outputs per live particle, in float32."""
    nf, nb, d = st["n_f"], st["n_b"], 3
    if kind == "k_pass":      # reads x, m, k; writes a vector
        rw = (nf * (d + 2) * 4, nf * d * 4)
    elif kind == "t_pass":    # reads x, m, q; writes a scalar
        rw = (nf * (2 * d + 1) * 4, nf * 4)
    elif kind == "hoist_ff":  # reads x, m; writes rho, G, sq, s2, count
        rw = (nf * (d + 1) * 4, nf * (d + 4) * 4)
    else:                     # hoist_fb: x; boundary x, v, V; 5 + d sums
        rw = (nf * d * 4 + nb * (2 * d + 1) * 4, nf * (d + 5) * 4)
    within = st["within_fb"] if kind == "hoist_fb" else st["within_ff"]
    return bound_s(rw[0], rw[1], within, kind)[0]


def step_state(n_f, n_b, within_ff, within_fb):
    """The roofline inputs of one step: live particles, and the pairs
    within h (the step's own contact counts)."""
    return dict(n_f=int(n_f), n_b=int(n_b), within_ff=int(within_ff),
                within_fb=int(within_fb))


def kernels_roofline(profile):
    """(sum of the hand pair kernels' bounds, their device time), seconds,
    over the profiled steps; (0, 0) when none ran."""
    bound = time = 0.0
    for op in profile.ops:
        kind = kernel_kind(op.name)
        if kind is None:
            continue
        bound += call_bound_s(kind, profile.states[op.step])
        time += op.dur_us / 1e6
    return bound, time
