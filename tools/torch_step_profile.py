#!/usr/bin/env python3
"""Where the time of one salva_tpu_torch step goes, on one CUDA device.

Runs a 97k dam-break main path of ``chip_smoke.py`` (``--path``, one of
its ``PATHS``: DFSPH or IISPH, with or without the fluid's forces, under
the cubic or the poly6 / spiky kernels) for 10 warm-up steps, then:

1. stage timing: each leaf stage of the step (binning, layout shuffles,
   the pair passes, boundary volumes and forces, the non-pressure
   forces, the convergence reductions and host syncs) is wrapped in
   ``torch.cuda.synchronize()``
   and a host clock over ``--steps`` steps; "everything else" is the
   synchronized step time minus the stages. The synchronizes add their
   own cost, so the total is above the unsynchronized ms/step;
2. ``torch.profiler`` over 3 unsynchronized steps: device time summed
   over kernels against the wall clock (the device's busy share, against
   the profiled steps and against the unprofiled ms/step of part 1), and
   the kernels with the most device time, and each hand kernel's device
   time per step.

Usage, from the repository root on a machine with a CUDA device:

    python3 tools/torch_step_profile.py --path dfsph
    python3 tools/torch_step_profile.py --path iisph --json out.json
    python3 tools/torch_step_profile.py --path dfsph_tension

Prints one table per part and, with ``--json``, writes the numbers.
"""

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402  (the dam-break scene)
from salva_tpu_torch.geometry import dense_grid as dg  # noqa: E402
from salva_tpu_torch.ops import binning, pair  # noqa: E402
from salva_tpu_torch.solver import dense_common, dfsph_dense, iisph_dense  # noqa: E402,E501

# The hand kernels, by a substring of their (demangled) profiler name.
HAND_KERNELS = (("k_pass", "KPass"), ("t_pass", "TPass"),
                ("hoist_ff", "HoistFF"), ("hoist_fb", "hoist_fb_warps"),
                ("expand", "expand_kernel"))
_TIMES = collections.defaultdict(float)
_CALLS = collections.defaultdict(int)
_DEPTH = [0]


def _timed(label, fn):
    """``fn`` with a synchronized host clock around it (outermost timed
    call only, so nested stages are not counted twice)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _DEPTH[0]:
            return fn(*args, **kwargs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _DEPTH[0] -= 1
            torch.cuda.synchronize()
            _TIMES[label] += time.perf_counter() - t0
            _CALLS[label] += 1

    return wrapper


def _instrument():
    """Wrap the step's leaf stages (module attributes, so every caller
    goes through the wrapper)."""
    for mod, name, label in (
        (dg, "bin_particles", "binning, full grid (fluid; boundary on the "
         "full-grid layout)"),
        (dg, "bin_particles_active", "binning, compact (boundary)"),
        (binning, "expand", "expand kernel (to_grid, to_grid_multi)"),
        (dg, "from_grid_multi", "from_grid_multi (unbin)"),
        (pair, "hoist_ff", "hoist_ff kernel"),
        (pair, "hoist_fb", "hoist_fb kernel"),
        (dfsph_dense, "per_fluid_mean_max_grid", "convergence reductions"),
        (iisph_dense, "per_fluid_mean_max_grid", "convergence reductions"),
        (dfsph_dense, "_converged", "convergence host syncs"),
        (iisph_dense, "_converged", "convergence host syncs"),
    ):
        setattr(mod, name, _timed(label, getattr(mod, name)))
    ctx = dense_common.DenseCtx
    for name, label in (
        ("k_pass", "k_pass kernel"),
        ("t_pass", "t_pass kernel"),
        ("boundary_forces", "boundary forces (plain torch fold)"),
        ("_compute_boundary_volumes", "boundary volumes (plain torch fold)"),
        ("_fb_table", "fb adjacency table (topk)"),
        ("apply_forces", "non-pressure forces (plain torch passes)"),
    ):
        setattr(ctx, name, _timed(label, getattr(ctx, name)))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=tuple(chip_smoke.PATHS),
                    default="dfsph", help="a main path of chip_smoke.PATHS")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device available", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}", flush=True)
    path = args.path
    world = chip_smoke.path_world(path)
    for _ in range(10):
        world.step(chip_smoke.DT, chip_smoke.GRAVITY)
    torch.cuda.synchronize()

    # Unsynchronized reference over the same number of steps.
    t0 = time.perf_counter()
    iters = []
    for _ in range(args.steps):
        world.step(chip_smoke.DT, chip_smoke.GRAVITY)
        s = world.last_diagnostics.solver
        iters.append((s.pressure_iters, s.divergence_iters))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) / args.steps * 1e3

    # 1. stage timing.
    _instrument()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        world.step(chip_smoke.DT, chip_smoke.GRAVITY)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) / args.steps * 1e3
    stages = sorted(((label, t / args.steps * 1e3, _CALLS[label] / args.steps)
                     for label, t in _TIMES.items()), key=lambda r: -r[1])
    rest = sync_ms - sum(ms for _, ms, _ in stages)
    print(f"\n{path}: {plain_ms:.3f} ms/step unsynchronized, "
          f"{sync_ms:.3f} ms/step with a synchronize around each stage "
          f"({args.steps} steps each; iterations per step {iters})")
    print(f"{'stage':<62} {'ms/step':>9} {'calls/step':>10}")
    for label, ms, calls in stages:
        print(f"{label:<62} {ms:9.3f} {calls:10.1f}")
    print(f"{'everything else (elementwise torch ops, host)':<62} "
          f"{rest:9.3f}")

    # 2. torch.profiler over 3 unsynchronized steps (the wrappers pass
    # straight through: they are disabled by raising their depth).
    _DEPTH[0] = 1
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            world.step(chip_smoke.DT, chip_smoke.GRAVITY)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _DEPTH[0] = 0
    # Device-side events only: the aten ops that launch kernels carry
    # the same time again as their own device time.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        print("torch_step_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    print(f"\nprofiler, 3 steps: {device_ms:.3f} ms of device time "
          f"({device_ms / 3:.3f} ms/step) in {wall_ms:.3f} ms of profiled "
          f"wall clock; busy share {device_ms / wall_ms:.3f} of the "
          f"profiled wall clock, {device_ms / 3 / plain_ms:.3f} of the "
          f"unprofiled {plain_ms:.3f} ms/step")
    print(f"{'kernel (device time)':<62} {'ms/step':>9} {'calls/step':>10}")
    for e in top:
        print(f"{e.key[:62]:<62} {e.self_device_time_total / 3e3:9.3f} "
              f"{e.count / 3:10.1f}")
    hand = {}
    for name, key in HAND_KERNELS:
        evs = [e for e in kernels if key in e.key]
        hand[name] = dict(
            ms_per_step=sum(e.self_device_time_total for e in evs) / 3e3,
            calls_per_step=sum(e.count for e in evs) / 3)
    print(f"\n{'hand kernel (device time)':<62} {'ms/step':>9} "
          f"{'calls/step':>10}")
    for name, h in hand.items():
        print(f"{name:<62} {h['ms_per_step']:9.4f} "
              f"{h['calls_per_step']:10.1f}")
    print(f"\ncard: {card}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(
                card=card, solver=chip_smoke.PATHS[path]["solver"],
                path=path, steps=args.steps,
                iters=iters, ms_per_step=plain_ms, sync_ms_per_step=sync_ms,
                stages=[dict(stage=l, ms=m, calls=c) for l, m, c in stages],
                rest_ms=rest, profiler_device_ms_3_steps=device_ms,
                profiler_wall_ms_3_steps=wall_ms,
                top=[dict(op=e.key, ms_per_step=e.self_device_time_total
                          / 3e3, calls_per_step=e.count / 3) for e in top],
                hand_kernels=hand,
            ), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
