"""The benchmark's run of one cell: set-up, the timed window, the check.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of the configuration): the
  scene's sizes and settings; its ``scene``, ``solver`` and ``forces``
  name the files of ``parts.py`` (the scene's geometry and builder, the
  solver's state and reference step, each force's reference);
- ``traffic/<traffic>.json``: the episodes (warm-up W, length K), the
  steps the check samples and the steps the traced run profiles;
- ``limits/<workload>.json``: the limits of the numbers the check
  compares, and the control that set them;
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``, which
  returns a number or None (nothing to read: the metric is left out).
The modules among them are loaded through ``parts.py``.

A run builds the scene from the seed, takes W warm-up steps (the start
transient and the world's first overflow check), snapshots the whole
pipeline in memory, and then replays episodes of K steps from that
snapshot until the window's seconds have run out. A step is the user's
frame: ``FluidsPipeline.step(gravity, dt)`` and a synchronise. The run
reports on standard error what the garbage collector took in the steps
and in the restores.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import random
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from benchmark import parts

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the port was made from (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "salva_tpu")


def forbidden_modules_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def metrics(self, trace: bool) -> list:
        """The metric entries this cell reports in a run with or without
        the trace: those without ``workloads`` and those listing it."""
        group = self.per_layer if trace else self.end_to_end
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(wl)})")
    w = wl[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / cfgs[w["config"]]["file"])
    bench_dir = root / "benchmark"
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
    )


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return parts.load("metrics", name).read


@dataclasses.dataclass
class StepRecord:
    wall_s: float
    check: bool                 # the world ran its overflow check
    iters: int                  # pressure + divergence iterations
    coupling_s: Optional[float]  # the port's coupling timers (traced run)
    overflow: int = 0
    clamped: int = 0
    finite: bool = True
    raised: bool = False

    @property
    def failed(self) -> bool:
        return (self.raised or not self.finite or self.overflow > 0
                or self.clamped > 0)


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers take it."""

    n_live: int
    setup_s: float
    window_s: float
    steps: List[StepRecord]
    # The traced run's profiles (trace.Profile): without the Python stack
    # (device times, busy share) and with it (which module launched what).
    profile: Optional[object] = None
    stack_profile: Optional[object] = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# The controls a cell's limits may name: a lower precision put in the
# program's place. ``program_frozen_bfloat16`` is the program's own path
# (frozen bfloat16 pair coefficients, switched on before the first step);
# ``reference_bfloat16`` is the reference with its pair terms in bfloat16
# and its sums in float32, stepped from the program's states.
CONTROLS = ("program_frozen_bfloat16", "reference_bfloat16")


class Scene:
    """The pipeline of one configuration and what the check needs of it."""

    def __init__(self, cfg, seed: int, device=None, layout=None,
                 device_coupling=None, control=None):
        self.cfg = cfg
        self.seed = int(seed)
        scene = parts.scene(cfg)
        self.initial = scene.initial_fluid(cfg, self.seed)
        self.pipeline, self.fluid, self.boundaries = scene.build(
            cfg, self.initial, device=device, layout=layout,
            device_coupling=device_coupling)
        if control == "program_frozen_bfloat16":
            w = self.world
            w.sim = w.sim.replace(dense_frozen_pairs=True,
                                  dense_pair_dtype="bfloat16")
        self.gravity = tuple(float(g) for g in cfg["gravity"])
        self.dt = float(cfg["dt"])
        self.steps_taken = 0

    @property
    def world(self):
        return self.pipeline.liquid_world

    def slots(self):
        """(fluid slots in particle order, boundary slots in collider
        order), as index tensors on the world's device."""
        w = self.world
        dev = w.device
        f = torch.as_tensor(w.fluid_slots(self.fluid), device=dev)
        b = torch.as_tensor(np.concatenate(
            [w.boundary_slots(h) for h in self.boundaries]), device=dev)
        return f, b

    def state(self):
        """Clones of the state one step reads and writes (the solver's
        ``state``)."""
        return parts.solver(self.cfg).state(self.world)

    def step(self):
        self.pipeline.step(self.gravity, self.dt)
        self.steps_taken += 1


def take_step(scene: Scene, record_counters: bool):
    """One timed frame. Returns (record, diagnostics tensors or None)."""
    world = scene.world
    dev = world.device
    t0 = time.perf_counter()
    try:
        scene.step()
        _sync(dev)
    except Exception as exc:  # a step that raises is a failed step
        wall = time.perf_counter() - t0
        print(f"step {scene.steps_taken + 1} raised: {exc!r}",
              file=sys.stderr)
        scene.steps_taken += 1
        return StepRecord(wall, False, 0, None, raised=True), None
    wall = time.perf_counter() - t0
    d = world.last_diagnostics
    coupling = None
    if record_counters:
        c = world.counters
        coupling = c.cd.boundary_update_time.time + c.coupling_transmit_time.time
    interval = max(world.overflow_check_interval, 1)
    check = scene.steps_taken == 1 or scene.steps_taken % interval == 0
    fl = world.fluids_state
    finite = (torch.isfinite(fl.positions).all(-1) | ~fl.alive).all()
    rec = StepRecord(wall, check,
                     d.solver.pressure_iters + d.solver.divergence_iters,
                     coupling)
    return rec, torch.stack([d.neighbor_overflow.to(torch.int64),
                             d.candidate_overflow.to(torch.int64),
                             finite.to(torch.int64)])


def settle(records, flags):
    """Read every step's diagnostic tensors at once, after the window."""
    have = [f for f in flags if f is not None]
    vals = torch.stack(have).cpu().tolist() if have else []
    it = iter(vals)
    for rec, f in zip(records, flags):
        if f is None:
            continue
        over, clamp, fin = next(it)
        rec.overflow, rec.clamped, rec.finite = int(over), int(clamp), bool(fin)


def set_up(cell: Cell, seed: int, device=None, layout=None,
           device_coupling=None, control=None):
    """Build the scene, take the warm-up steps, keep the first step's
    states for the check. Returns (scene, first-step sample, warm-up
    records)."""
    scene = Scene(cell.config, seed, device, layout, device_coupling,
                  control)
    first = None
    recs, flags = [], []
    for k in range(int(cell.traffic["warmup_steps"])):
        rec, f = take_step(scene, False)
        recs.append(rec)
        flags.append(f)
        if k == 0:
            first = dict(after=scene.state(), slots=scene.slots())
    settle(recs, flags)
    return scene, first, recs


def window(snapshot: Scene, cell: Cell, seconds: float, seed: int,
           record_counters: bool):
    """Replay episodes of K steps from ``snapshot`` for ``seconds`` (one
    step at least). Returns (records, window seconds, the sampled steps,
    the scene of the last episode). The check's sample is a reservoir of
    the window's steps, drawn from the seed."""
    K = int(cell.traffic["episode_steps"])
    S = int(cell.traffic["check_steps"])
    rng = random.Random(seed)
    records, flags, sample = [], [], []
    # The collector's runs in the window: (in a restore, seconds).
    collections, started, restoring = [], [0.0], [False]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            collections.append((restoring[0],
                                time.perf_counter() - started[0]))

    gc.callbacks.append(on_gc)
    t_start = time.perf_counter()
    k = K
    while not records or time.perf_counter() - t_start < seconds:
        if k == K:
            restoring[0] = True
            scene = copy.deepcopy(snapshot)
            restoring[0] = False
            k = 0
        t = len(records) + 1
        slot = t - 1 if t <= S else rng.randrange(t)
        keep = slot < S
        before = scene.state() if keep else None
        rec, f = take_step(scene, record_counters)
        records.append(rec)
        flags.append(f)
        k += 1
        if keep:
            entry = dict(before=before, after=scene.state(),
                         slots=scene.slots(), step=scene.steps_taken)
            if slot < len(sample):
                sample[slot] = entry
            else:
                sample.append(entry)
        if rec.raised:
            k = K  # the state is broken: the next step starts an episode
    window_s = time.perf_counter() - t_start
    gc.callbacks.remove(on_gc)
    for where, flag in (("the steps", False), ("the restores", True)):
        secs = [s for r, s in collections if r == flag]
        print(f"garbage collector in {where}: {len(secs)} runs, "
              f"{sum(secs) * 1e3:.3f} ms, longest "
              f"{max(secs, default=0.0) * 1e3:.3f} ms", file=sys.stderr)
    settle(records, flags)
    return records, window_s, sample, scene


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", layout=None, device_coupling=None, control=None):
    """One run of ``cell``: returns the result object (see ``run.py``) and
    the check's rows (name, value, limit). ``control`` (one of
    ``CONTROLS``) puts the control in the program's place."""
    from benchmark import check

    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    dev = torch.device(device)
    scene, first, warm = set_up(cell, seed, dev, layout, device_coupling,
                                control)
    for k, rec in enumerate(warm):
        if rec.failed:
            print(f"warm-up step {k + 1} failed: {rec}", file=sys.stderr)
    if trace:
        scene.world.counters.enable()
    setup_s = time.monotonic() - t0
    records, window_s, sample, last = window(scene, cell, seconds, seed,
                                             trace)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    walls = sorted(r.wall_s * 1e3 for r in records)
    q = [walls[int(f * (len(walls) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
    print(f"window: {len(records)} steps in {window_s:.3f} s; step ms min "
          f"{q[0]:.3f} q1 {q[1]:.3f} median {q[2]:.3f} q3 {q[3]:.3f} max "
          f"{q[4]:.3f}", file=sys.stderr)
    n_live = int(scene.world.fluids_state.alive.sum())
    run = Run(n_live=n_live, setup_s=setup_s, window_s=window_s,
              steps=records)
    if trace:
        from benchmark import trace as tr

        scene.world.counters.disable()
        nsteps = int(cell.traffic["profile_steps"])
        run.profile = tr.profile_steps(scene, nsteps, False)
        run.stack_profile = tr.profile_steps(scene, nsteps, True)
    initial = scene.initial
    del scene, last
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stepper = (check.reference_stepper(torch.bfloat16, torch.float32)
               if control == "reference_bfloat16" else None)
    gaps = check.compare(cell.config, initial, [first] + sample, dev,
                         stepper=stepper)
    correct, rows = check.verdict(gaps, cell.limits)

    metrics = {}
    for m in cell.metrics(trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": sum(r.failed for r in records),
              "metrics": metrics, "device": devinfo}
    if trace:
        p = run.profile
        devinfo["busy_s"] = p.busy_us / 1e6
        devinfo["window_s"] = p.window_us / 1e6
        result["breakdown"] = {"device_ops": p.top_ops(10),
                               "idle_gaps": run.stack_profile.gaps}
    return result, rows
