#!/usr/bin/env python3
"""Benchmark of salva_tpu_torch (the PyTorch + CUDA port) on one NVIDIA
GPU: the port of ``bench.py``.

It runs ``bench.py``'s scene (``run_config``): a cube of
round(N^(1/3))^3 fluid particles (``radius=0.05``, ``smoothing_factor=2``)
one radius above a sampled ``Cuboid`` floor, falling at 2 m/s in a static
domain, ``dt = 1/200``; ``BENCH_WARMUP`` warm-up steps reach impact, then
a timed window of ``BENCH_STEPS`` steps ends in
``torch.cuda.synchronize()``. Rows (``ROWS``):

========================  =========  ======  ===========  =============
row                       N          solver  forces       layout
========================  =========  ======  ===========  =============
``dfsph_97k`` (primary)   BENCH_N    DFSPH   none         BENCH_LAYOUT
``iisph_97k``             BENCH_N    IISPH   none         BENCH_LAYOUT
``dfsph_4k_auto``         <= 4,096   DFSPH   none         BENCH_LAYOUT
``dfsph_4k_dense``        <= 4,096   DFSPH   none         dense
``dfsph_97k_visc``        BENCH_N    DFSPH   VISC         BENCH_LAYOUT
``iisph_97k_visc``        BENCH_N    IISPH   VISC         BENCH_LAYOUT
``dfsph_1m``              1,000,000  DFSPH   none         BENCH_LAYOUT
========================  =========  ======  ===========  =============

``BENCH_N`` defaults to 100,000 (46^3 = 97,336 particles) and
``BENCH_LAYOUT`` to ``auto``: the grid at 97k and 1M, the brute
all-pairs tier at 4,096 (16^3, whose fluid capacity sits at the brute
ceiling), against which ``dfsph_4k_dense`` runs the grid. The small
rows run min(4,096, BENCH_N) particles; the 1M row takes
min(BENCH_STEPS, 10) steps. VISC: the fluid carries
``ArtificialViscosity(1.0, 0.0)`` and ``XSPHViscosity(0.5, 1.0)``.

Each row is rebuilt from the same inputs ``BENCH_REPEATS`` times
(default 3) and reports the median and min-max of ms/step and of
particle-steps/s, the host-dispatch sentinel (the round trip of a trivial
device op and a synchronize), and the device ms/step that
``torch.profiler``'s kernel events give over 3 steps after the window
(``null`` when three profiles return no device events, never 0). Each
row is stamped with its resolved layout, caps and window, the device's
name and power limit, and the source it ran.

Gates, on every repeat of every row: neighbor overflow under
max(1, N // 1000) (``bench.py``'s), finite positions, a peak density
ratio in [0.9, 2.0], and identical iteration counts across the repeats
(they start from identical inputs). A row that fails a gate stays in the
output with its failures, and the script exits 1 after printing.

Budget: the script times itself against ``BENCH_BUDGET`` seconds (default
540). Before the visc rows, and then the 1M row, it estimates their cost
from the primary row's time (``ROW_FACTOR``) and skips them with a
``skipped_*`` marker when the estimate would exceed the budget.

Knobs (as in ``bench.py``): ``BENCH_N``, ``BENCH_STEPS`` (20),
``BENCH_WARMUP`` (10), ``BENCH_SKIP_1M``, ``BENCH_BUDGET``,
``BENCH_LAYOUT``, ``BENCH_CAP`` (the fluid cap; default auto-sized),
``BENCH_WARM`` (the DFSPH warm-start factor); ``BENCH_REPEATS``.
``BENCH_PALLAS``, ``BENCH_FROZEN`` and ``BENCH_SPILL`` raise: the port
has no Pallas switch (its hand kernels run on every CUDA tensor), and
neither frozen pair coefficients nor the dense+spill structure.

Usage:  python3 bench_torch.py [--device cuda|cpu]
It runs on the card; ``--device cpu`` runs the plain PyTorch passes on
the CPU (for a test of the script, not a measurement: no device time).
The last line of stdout is one JSON object.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent

RADIUS = 0.05
DT = 1.0 / 200.0
GRAVITY = (0.0, -9.81, 0.0)
PROFILED_STEPS = 3
# ArtificialViscosity (salva_tpu/scenes.py:176, basic3) and XSPH
# (:231, the elasticity scenes), as (class name, arguments).
VISC = (("ArtificialViscosity", (1.0, 0.0)), ("XSPHViscosity", (0.5, 1.0)))
SMALL_N = 16 ** 3  # the brute tier's fluid ceiling, brute_max_particles
# name: (N, solver, forces, layout; None = BENCH_LAYOUT), in run order;
# "N" = BENCH_N, "small" = min(SMALL_N, BENCH_N).
ROWS = {
    "dfsph_97k": ("N", "dfsph", False, None),
    "iisph_97k": ("N", "iisph", False, None),
    "dfsph_4k_auto": ("small", "dfsph", False, None),
    "dfsph_4k_dense": ("small", "dfsph", False, "dense"),
    "dfsph_97k_visc": ("N", "dfsph", True, None),
    "iisph_97k_visc": ("N", "iisph", True, None),
    "dfsph_1m": (1_000_000, "dfsph", False, None),
}
VISC_ROWS = ("dfsph_97k_visc", "iisph_97k_visc")
# Budget estimate of a row: this factor x the primary row's seconds (its
# repeats, warm-up, window and profiles). On an H100 (700 W) each visc
# row took 2.5x the primary row's time and the 1M row 0.74x.
ROW_FACTOR = {"visc": 4.0, "1m": 3.0}
# Gates.
DENSITY_RATIO = (0.9, 2.0)


def _elapsed() -> float:
    return time.perf_counter() - _T0


def _env_int(name, default):
    v = os.environ.get(name, "")
    return int(v) if v else default


def _refuse_unported_knobs():
    for knob, what in (
        ("BENCH_PALLAS", "the port has no Pallas kernels to switch: its "
                         "hand kernels run on every CUDA tensor"),
        ("BENCH_FROZEN", "frozen pair coefficients (dense_frozen_pairs) "
                         "are not ported"),
        ("BENCH_SPILL", "the dense+spill structure (dense_spill_auto) is "
                        "not ported"),
    ):
        if os.environ.get(knob):
            raise NotImplementedError(f"{knob}: {what}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(device):
    """(name, power limit) as nvidia-smi reports them; the CPU has
    neither."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    name, power = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


def source_stamp():
    """(``git rev-parse HEAD`` or None outside a git checkout, the sha256
    of the port's sources and this script)."""
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = None
    h = hashlib.sha256()
    files = sorted((ROOT / "salva_tpu_torch").rglob("*.py"))
    files += sorted((ROOT / "salva_tpu_torch" / "csrc").glob("*.cu"))
    for path in files + [ROOT / "bench_torch.py"]:
        h.update(path.relative_to(ROOT).as_posix().encode())
        h.update(path.read_bytes())
    return rev, h.hexdigest()[:16]


def dispatch_us(device, reps=30):
    """Host-dispatch sentinel: the mean round trip of a trivial device op
    and a synchronize (``bench.py`` times a trivial jitted dispatch). A
    loaded host inflates it without touching device time."""
    x = torch.zeros(8, device=device)
    x = x + 1.0
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = x + 1.0
        _sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def build_world(n_target, solver, forces, layout, device):
    """``bench.py``'s ``run_config`` scene on the port."""
    from salva_tpu_torch import forces as force_specs
    from salva_tpu_torch import shapes
    from salva_tpu_torch.config import DFSPHConfig, IISPHConfig
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    n_side = max(2, round(n_target ** (1.0 / 3.0)))
    half = n_side * RADIUS
    wall = max(1.5 * half, half + 0.5)
    domain = (
        (-wall - 0.3, -0.4, -wall - 0.3),
        (wall + 0.3, 2.0 * half + 1.0, wall + 0.3),
    )
    if solver == "dfsph":
        warm = os.environ.get("BENCH_WARM", "")
        cfg = DFSPHConfig(warm_start=float(warm)) if warm else DFSPHConfig()
    else:
        cfg = IISPHConfig()
    cap = os.environ.get("BENCH_CAP", "")
    world = LiquidWorld(solver=cfg, particle_radius=RADIUS,
                        smoothing_factor=2.0, dim=3, domain=domain,
                        layout=layout, dense_cap=int(cap) if cap else None,
                        dense_cap_boundary=None, device=device)
    pos = cube_fluid((n_side, n_side, n_side), RADIUS)
    pos[:, 1] += half + RADIUS
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    nonpressure = ([getattr(force_specs, name)(*args)
                    for name, args in VISC] if forces else [])
    world.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                          nonpressure_forces=nonpressure))
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), RADIUS, 3)
    floor[:, 1] -= 0.1
    world.add_boundary(Boundary(floor))
    return world


def device_ms_per_step(world, device, tries=3):
    """Device time per step from ``torch.profiler``'s kernel events over
    PROFILED_STEPS steps, and the profiled wall ms/step. A profile that
    returns no device events is retried; after ``tries`` such profiles
    the device time is None (never 0)."""
    if device.type != "cuda":
        return None, None
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    wall = None
    for _ in range(tries):
        _sync(device)
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(PROFILED_STEPS):
                world.step(DT, GRAVITY)
            _sync(device)
        wall = (time.perf_counter() - t0) / PROFILED_STEPS * 1e3
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / PROFILED_STEPS / 1e3, wall
    return None, wall


def run_once(n_target, solver, forces, layout, steps, warmup, device):
    """Build the row's world, warm up, time the window (rerun once if a
    grid refit lands in it, as ``bench.py`` does), then profile."""
    t0 = time.perf_counter()
    world = build_world(n_target, solver, forces, layout, device)
    n = int(world.fluids_state.alive.sum())
    sentinel = dispatch_us(device)
    for _ in range(warmup):
        world.step(DT, GRAVITY)
    _sync(device)
    setup_s = time.perf_counter() - t0
    for _attempt in range(2):
        refits0 = world.grid_refit_count
        iters = []
        t1 = time.perf_counter()
        for _ in range(steps):
            world.step(DT, GRAVITY)
            s = world.last_diagnostics.solver
            iters.append((s.pressure_iters, s.divergence_iters))
        _sync(device)
        elapsed = time.perf_counter() - t1
        refits = world.grid_refit_count - refits0
        if refits == 0:
            break
    d = world.last_diagnostics
    sim = world._effective_sim()
    alive = world.fluids_state.alive
    out = dict(
        n=n, ms=elapsed / steps * 1e3, iters=iters, refits=refits,
        overflow=int(d.neighbor_overflow),
        clamped=int(d.candidate_overflow),
        max_density_ratio=float(d.max_density_ratio),
        finite=bool(torch.isfinite(world.fluids_state.positions[alive]).all()),
        dispatch_us=sentinel, setup_s=setup_s,
        # "auto" stays in the sim when it resolves to the grid.
        layout="dense" if sim.layout == "auto" else sim.layout,
        dense_cap=sim.dense_cap,
        dense_cap_boundary=sim.dense_cap_boundary,
        fitted_dims=(list(sim.fitted_dims) if sim.fitted_dims else None),
        brute_cells=sim.brute_cells if sim.layout == "brute" else None,
        grid_refits=world.grid_refit_count,
    )
    t2 = time.perf_counter()
    out["device_ms"], out["profiled_wall_ms"] = device_ms_per_step(
        world, device)
    out["profile_s"] = time.perf_counter() - t2
    return out


def _spread(values):
    return dict(median=statistics.median(values), min=min(values),
                max=max(values))


def run_row(name, n_target, solver, forces, layout, steps, warmup, repeats,
            device, stamp):
    """One row: ``repeats`` runs from identical inputs, their spread and
    the gates. Returns (row, seconds it took)."""
    t0 = time.perf_counter()
    runs = [run_once(n_target, solver, forces, layout, steps, warmup,
                     device) for _ in range(repeats)]
    first = runs[0]
    n = first["n"]
    ms = [r["ms"] for r in runs]
    pps = [n * 1e3 / m for m in ms]
    dev = [r["device_ms"] for r in runs if r["device_ms"] is not None]
    p_iters = [int(p) for p, _ in first["iters"]]
    d_iters = [int(v) for _, v in first["iters"]]
    failures = []
    limit = max(1, n // 1000)
    for k, r in enumerate(runs):
        if r["overflow"] >= limit:
            failures.append(f"repeat {k}: neighbor overflow {r['overflow']} "
                            f">= {limit}")
        if not r["finite"]:
            failures.append(f"repeat {k}: non-finite positions")
        lo, hi = DENSITY_RATIO
        if not lo <= r["max_density_ratio"] <= hi:
            failures.append(f"repeat {k}: peak density ratio "
                            f"{r['max_density_ratio']} outside [{lo}, {hi}]")
        if r["iters"] != first["iters"]:
            failures.append(f"repeat {k}: iterations {r['iters']} differ "
                            f"from repeat 0's {first['iters']}")
    forces_txt = " + viscosity forces" if forces else ""
    row = dict(
        name=name,
        metric=(f"particle-steps/sec, {n}-particle 3D {solver.upper()}"
                f"{forces_txt} dam break"),
        n=n, solver=solver, forces=[f"{c}{a}" for c, a in VISC]
        if forces else [], layout_requested=layout, layout=first["layout"],
        dense_cap=first["dense_cap"],
        dense_cap_boundary=first["dense_cap_boundary"],
        fitted_dims=first["fitted_dims"],
        window_cells=(int(np.prod(first["fitted_dims"]))
                      if first["fitted_dims"] else None),
        brute_cells=first["brute_cells"], steps=steps, warmup=warmup,
        repeats=repeats,
        value=statistics.median(pps), value_spread=_spread(pps),
        ms_per_step=statistics.median(ms), ms_per_step_spread=_spread(ms),
        ms_per_step_by_repeat=ms,
        device_ms_per_step=statistics.median(dev) if dev else None,
        device_ms_per_step_spread=_spread(dev) if dev else None,
        profiled_wall_ms_per_step=[r["profiled_wall_ms"] for r in runs],
        pressure_iters=sum(p_iters), divergence_iters=sum(d_iters),
        iters_per_step=[[p, v] for p, v in zip(p_iters, d_iters)],
        grid_refits_in_window=max(r["refits"] for r in runs),
        neighbor_overflow=max(r["overflow"] for r in runs),
        overflow_limit=limit,
        clamped=max(r["clamped"] for r in runs),
        max_density_ratio=max(r["max_density_ratio"] for r in runs),
        host_dispatch_us=statistics.median(r["dispatch_us"] for r in runs),
        setup_s=[r["setup_s"] for r in runs],
        gates_checked=["neighbor_overflow", "finite_positions",
                       "density_ratio", "identical_iterations"],
        gate_failures=failures,
        **stamp,
    )
    return row, time.perf_counter() - t0


def log_row(row):
    """One line on stderr per row (stdout carries the JSON only)."""
    if "error" in row:
        msg = row["error"]
    else:
        sp = row["ms_per_step_spread"]
        msg = (f"{row['ms_per_step']:.3f} ms/step, median of "
               f"{row['repeats']} ({sp['min']:.3f}-{sp['max']:.3f}); "
               f"device {row['device_ms_per_step']} ms/step; layout "
               f"{row['layout']}; iterations {row['pressure_iters']} / "
               f"{row['divergence_iters']}")
    if row["gate_failures"]:
        msg += f"; GATES FAILED: {row['gate_failures']}"
    print(f"[bench_torch] {row['name']}: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default: the card) or cpu (the plain "
                         "passes, for a test of the script)")
    args = ap.parse_args(argv)
    _refuse_unported_knobs()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device (pass --device cpu "
                           "to run the plain passes on the CPU)")
    device = torch.device(args.device)
    sys.path.insert(0, str(ROOT))

    target_n = _env_int("BENCH_N", 100_000)
    steps = _env_int("BENCH_STEPS", 20)
    warmup = _env_int("BENCH_WARMUP", 10)
    repeats = _env_int("BENCH_REPEATS", 3)
    budget = float(os.environ.get("BENCH_BUDGET", "540"))
    layout_env = os.environ.get("BENCH_LAYOUT", "auto")
    name, power = card(device)
    rev, src = source_stamp()
    stamp = dict(device=name, power_limit=power, git_rev=rev,
                 source_sha256=src, torch=torch.__version__)

    rows, skipped, failed = [], {}, []
    primary_s = None  # the primary row's seconds: the budget's unit
    for row_name, (n_spec, solver, forces, layout) in ROWS.items():
        n_target = {"N": target_n, "small": min(SMALL_N, target_n)}.get(
            n_spec, n_spec)
        row_steps = min(steps, 10) if row_name == "dfsph_1m" else steps
        kind = ("1m" if row_name == "dfsph_1m"
                else "visc" if row_name in VISC_ROWS else None)
        if row_name == "dfsph_1m" and (target_n >= 1_000_000
                                       or os.environ.get("BENCH_SKIP_1M")):
            skipped["skipped_1m"] = ("BENCH_SKIP_1M set" if target_n
                                     < 1_000_000 else "BENCH_N >= 1M")
            continue
        if kind is not None and primary_s is None:
            skipped[f"skipped_{row_name}"] = "the primary row failed"
            continue
        if kind is not None:
            est = ROW_FACTOR[kind] * primary_s
            if _elapsed() + est > budget:
                key = "skipped_1m" if kind == "1m" else f"skipped_{row_name}"
                skipped[key] = (f"elapsed {_elapsed():.0f} s + estimate "
                                f"{est:.0f} s exceeds the budget "
                                f"{budget:.0f} s")
                continue
        try:
            row, took = run_row(row_name, n_target, solver, forces,
                                layout or layout_env, row_steps, warmup,
                                repeats, device, stamp)
        except Exception as exc:  # noqa: BLE001 - a row's failure is reported
            traceback.print_exc()
            row, took = dict(name=row_name, error=repr(exc),
                             gate_failures=[f"raised {exc!r}"], **stamp), 0.0
        row["seconds"] = took
        rows.append(row)
        if row["gate_failures"]:
            failed.append(row_name)
        log_row(row)
        if row_name == "dfsph_97k" and "error" not in row:
            primary_s = took

    primary = rows[0]
    out = {k: primary.get(k) for k in (
        "metric", "value", "ms_per_step", "pressure_iters",
        "divergence_iters", "grid_refits_in_window", "iters_per_step")}
    out["unit"] = "particle-steps/s"
    out.update(skipped)
    out["failed_rows"] = failed
    out["bench_elapsed_s"] = _elapsed()
    out["budget_s"] = budget
    out["rows"] = rows
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
