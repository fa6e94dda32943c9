"""The port's own spans (``salva_tpu_torch.counters``) as the benchmark
reads them.

- The window's record. The traced run's window runs with the port's
  counters on, so the program records a span at each stage of every step
  (``world.step`` the root, ``sync.<site>`` around each host read of a
  device value). ``window_steps`` takes that record once per run and sums
  it per step: the step's host time, the part spent in host reads, and
  the number of reads.
- A profile with the spans on. ``profile_steps`` profiles a few replayed
  steps with CPU and CUDA activity, no stack and no shapes, the spans on:
  each span is then a ``user_annotation`` on the kernels' clock. ``read``
  joins each device operation to the innermost span open on its launching
  thread at its launch (the profiler's correlation id, the sweep of
  ``trace._stack_sites``) and names each idle gap of the device by the
  innermost span open on the host at the gap's start.

Run alone, it prints that profile's breakdown for one cell:

    python3 benchmark/spans.py --workload harness_basic3_n40.collapse \\
        --seed 7 [--steps 4]

One JSON line: the per-span table (``spans``: host ms, self host ms,
device ms, self device ms, device operations, host syncs and device idle
ms a step), the longest idle gaps by span (``idle_gaps_by_span``), the
device ms a step of ``solver.bin`` (``binning_device_ms``) and
``solver.boundary_volumes`` (``boundary_volumes_device_ms``), the share of
device time launched in no stage span of the step (``unstaged_share``:
the self time of ``world.step`` and ``world.substep``), and the idle share
of this profile beside the device-only profile's (``trace.py``) over the
same steps.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import trace  # noqa: E402

ROOT_SPAN = "world.step"
SYNC = "sync."
OUTSIDE = "(outside the program's spans)"
# The step's own spans, whose self device time is work no stage names.
UNSTAGED = ("world.step", "world.substep")


def window_steps(run):
    """Per step of ``run``'s window, ``(host ns, ns in host reads, host
    reads)`` from the spans the program recorded while its counters were
    on; taken from the program once and kept on ``run``. None when the
    program recorded none (a program without spans)."""
    if not hasattr(run, "program_steps"):
        from salva_tpu_torch import counters

        take = getattr(counters, "take_spans", None)
        run.program_steps = _per_step(take()) if take is not None else []
    return run.program_steps or None


def _per_step(spans):
    root, steps = {}, {}
    for i, (name, parent, _, _, t0, t1) in enumerate(spans):
        r = i if parent < 0 else root.get(parent)
        root[i] = r
        if r is None:
            continue
        if i == r:
            if name == ROOT_SPAN:
                steps[i] = [t1 - t0, 0, 0]
        elif name.startswith(SYNC) and r in steps:
            steps[r][1] += t1 - t0
            steps[r][2] += 1
    return [tuple(v) for v in steps.values()]


@dataclasses.dataclass
class SpanProfile:
    """What ``read`` finds in a trace of ``n_steps`` steps."""

    n_steps: int
    table: Dict[str, Dict[str, float]]   # per span name, a step each
    gaps: List[Tuple[str, float]]        # the longest idle gaps (name, s)
    device_us: float                     # device time in the steps
    busy_us: float
    window_us: float

    def device_ms(self, name: str):
        """Device ms a step of the operations launched inside ``name``, or
        None when none was."""
        row = self.table.get(name)
        return row["device_ms"] if row and row["device_ops"] else None

    def unstaged_share(self):
        """Share (%) of the steps' device time launched in no stage span:
        the self device time of ``world.step`` and ``world.substep``."""
        if self.device_us <= 0:
            return None
        own = sum(self.table[n]["self_device_ms"] for n in UNSTAGED
                  if n in self.table)
        return 100.0 * own * 1e3 * self.n_steps / self.device_us

    def idle_share(self):
        if self.window_us <= 0:
            return None
        return 100.0 * (1.0 - self.busy_us / self.window_us)


def _nest(spans):
    """Parent index of each span ``(ts, dur, tid, name)`` by containment on
    its thread (-1 for none); ``spans`` sorted by (ts, -dur)."""
    parent, open_by_tid = [], {}
    for i, (ts, dur, tid, _) in enumerate(spans):
        stack = open_by_tid.setdefault(tid, [])
        while stack and spans[stack[-1]][0] + spans[stack[-1]][1] <= ts:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    return parent


def _chain(i, parent):
    out = []
    while i >= 0:
        out.append(i)
        i = parent[i]
    return out


def read(path, n_steps: int) -> SpanProfile:
    """The per-span breakdown of a Chrome trace of ``n_steps`` steps, each
    a ``bench_step_<k>`` annotation that ends in a synchronise."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps, spans, launches, dev = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            ts, dur = float(ev["ts"]), float(ev["dur"])
            if ev["name"].startswith("bench_step_"):
                steps.append((ts, ts + dur))
            else:
                spans.append((ts, dur, ev.get("tid"), ev["name"]))
        elif cat in trace._LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches.append((float(ev["ts"]), ev.get("tid"), corr))
        elif cat in trace._DEVICE_CATS:
            dev.append(ev)
    steps.sort()
    spans.sort(key=lambda s: (s[0], -s[1]))
    parent = _nest(spans)
    names = [s[3] for s in spans]
    table: Dict[str, Dict[str, float]] = {}

    def row(name):
        return table.setdefault(name, dict(
            host_ms=0.0, self_host_ms=0.0, device_ms=0.0, self_device_ms=0.0,
            device_ops=0, syncs=0, idle_ms=0.0))

    for i, (ts, dur, _, name) in enumerate(spans):
        r = row(name)
        r["host_ms"] += dur
        r["self_host_ms"] += dur
        if parent[i] >= 0:
            row(names[parent[i]])["self_host_ms"] -= dur
        if name.startswith(SYNC):
            for n in {names[k] for k in _chain(i, parent)}:
                row(n)["syncs"] += 1
    # The innermost span open at each launch, by the sweep that joins
    # Python frames to launches (the span's index stands for the frame).
    open_at = trace._stack_sites(
        [(ts, dur, tid, k) for k, (ts, dur, tid, _) in enumerate(spans)],
        launches)
    ops, device_us = [], 0.0
    for ev in dev:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if not any(s <= ts < e for s, e in steps):
            continue
        device_us += dur
        ops.append((ts, dur))
        inner = open_at.get(ev.get("args", {}).get("correlation"), [])
        if not inner:
            r = row(OUTSIDE)
            r["device_ms"] += dur
            r["self_device_ms"] += dur
            r["device_ops"] += 1
            continue
        row(names[inner[0]])["self_device_ms"] += dur
        for n in {names[k] for k in _chain(inner[0], parent)}:
            r = row(n)
            r["device_ms"] += dur
            r["device_ops"] += 1
    busy, gaps = _busy_and_gaps(steps, ops)
    # Each gap named by the innermost span open on the host at its start
    # (on the thread that opened the most spans: the step's).
    tids = [s[2] for s in spans]
    main = max(set(tids), key=tids.count) if tids else None
    named = []
    for start, us in gaps:
        inner = [k for k, (ts, dur, tid, _) in enumerate(spans)
                 if tid == main and ts <= start < ts + dur]
        name = names[inner[-1]] if inner else OUTSIDE
        row(name)["idle_ms"] += us
        named.append((name, us))
    for r in table.values():
        for k in ("host_ms", "self_host_ms", "device_ms", "self_device_ms",
                  "idle_ms"):
            r[k] = r[k] / 1e3 / n_steps
        r["device_ops"] /= n_steps
        r["syncs"] /= n_steps
    named.sort(key=lambda g: -g[1])
    return SpanProfile(
        n_steps=n_steps, table=table,
        gaps=[[n, us / 1e6] for n, us in named[:10]], device_us=device_us,
        busy_us=busy, window_us=sum(e - s for s, e in steps))


def _busy_and_gaps(steps, ops):
    """The union of the device intervals inside each step, and the idle
    gaps between them as (start, us), the last from the last operation's
    end to the step's end."""
    busy, gaps = 0.0, []
    ops = sorted(ops)
    for s, e in steps:
        cur = s
        for ts, dur in ops:
            if not s <= ts < e:
                continue
            if ts > cur:
                gaps.append((cur, ts - cur))
            end = min(ts + dur, e)
            if end > cur:
                busy += end - max(ts, cur)
                cur = end
        if e > cur:
            gaps.append((cur, e - cur))
    return busy, gaps


def profile_steps(snapshot, nsteps: int) -> SpanProfile:
    """Profile ``nsteps`` steps of a fresh replay of ``snapshot`` with the
    port's spans on: CPU and CUDA activity, no stack, no shapes. The trace
    goes to a temporary directory under TMPDIR and is removed once read."""
    scene = copy.deepcopy(snapshot)
    dev = scene.world.device
    act = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        act.append(torch.profiler.ProfilerActivity.CUDA)
    counters = scene.world.counters
    counters.enable()
    try:
        with torch.profiler.profile(activities=act) as prof:
            for k in range(nsteps):
                with torch.profiler.record_function(f"bench_step_{k}"):
                    scene.step()
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
    finally:
        counters.disable()
    tmp = tempfile.mkdtemp(prefix="bench_spans_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        return read(path, nsteps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    from benchmark import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=None,
                    help="steps profiled (default: the traffic's "
                         "profile_steps)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    nsteps = args.steps or int(cell.traffic["profile_steps"])
    t0 = time.monotonic()
    scene, _, _ = harness.set_up(cell, args.seed, torch.device("cuda"))
    device_only = trace.profile_steps(scene, nsteps, False)
    p = profile_steps(scene, nsteps)
    out = dict(
        workload=args.workload, seed=args.seed, steps=nsteps,
        card=harness.card_line(), setup_s=time.monotonic() - t0,
        binning_device_ms=p.device_ms("solver.bin"),
        boundary_volumes_device_ms=p.device_ms("solver.boundary_volumes"),
        unstaged_share=p.unstaged_share(), idle_share=p.idle_share(),
        device_only_idle_share=100.0 * (
            1.0 - device_only.busy_us / device_only.window_us),
        busy_s=p.busy_us / 1e6, window_s=p.window_us / 1e6,
        device_s=p.device_us / 1e6,
        spans=dict(sorted(p.table.items(), key=lambda kv: -kv[1]["host_ms"])),
        idle_gaps_by_span=p.gaps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
