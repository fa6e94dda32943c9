"""The traced run's profiles: a few steps under ``torch.profiler``, read
from its Chrome trace.

Two profiles of the same replayed steps. The first records the device
only (kernels, copies, fills), which costs the host little: the device's
busy time (the union of its operations' intervals) against the steps'
wall time on the harness's clock, each kernel's time, the roofline. The
second adds the host with the Python stack, which slows the host: each
device operation is joined to the host call that launched it (the
profiler's correlation id) and so to the Python frames of the port open at
the launch, its ``modules`` (every ``salva_tpu_torch/...`` file on the
stack, innermost first) and its ``site`` (the innermost such frame's file
and function). There each step is a ``bench_step_<k>`` annotation that
ends in a synchronise, so its device operations start inside its span.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from benchmark import roofline

_FRAME = re.compile(r"(salva_tpu_torch/[\w/]+\.py)\(\d+\): (\S+)")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    step: int
    modules: Tuple[str, ...]
    site: str


@dataclasses.dataclass
class Profile:
    ops: List[DeviceOp]
    spans: List[Tuple[float, float]]      # the steps' spans, trace clock
    states: List[Dict[str, float]]        # roofline inputs, by op.step
    n_steps: int
    window_us: float                      # the profiled steps' wall time
    busy_us: float = 0.0
    gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def module_device_ms(self, module: str):
        """Device ms a step of the operations launched under ``module``, or
        None when none was."""
        us = [op.dur_us for op in self.ops if module in op.modules]
        return sum(us) / 1e3 / self.n_steps if us else None

    def top_ops(self, n=10):
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.dur_us
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v / 1e6] for k, v in top]


def _stack_sites(pyev, launches):
    """For each launch (ts, tid, key), the salva frames open at ts on its
    thread (innermost first), by a sweep over the nested Python events."""
    by_tid: Dict[object, list] = {}
    for ev in pyev:
        by_tid.setdefault(ev[2], []).append(ev)
    if not by_tid:
        return {}
    # A launch on a thread without Python events (a thread id the tracer
    # writes differently) goes with the busiest Python thread.
    main = max(by_tid, key=lambda t: len(by_tid[t]))
    todo_by = {}
    for lt, ltid, key in launches:
        todo_by.setdefault(ltid if ltid in by_tid else main, []).append(
            (lt, key))
    out = {}
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e[0], -e[1]))
        todo = sorted(todo_by.get(tid, []))
        stack, k = [], 0
        for lt, key in todo:
            while k < len(evs) and evs[k][0] <= lt:
                ev = evs[k]
                while stack and stack[-1][0] + stack[-1][1] <= ev[0]:
                    stack.pop()
                stack.append(ev)
                k += 1
            while stack and stack[-1][0] + stack[-1][1] < lt:
                stack.pop()
            frames = [fr for (_, _, _, fr) in reversed(stack)
                      if fr is not None]
            out[key] = frames
    return out


def _mean_state(states):
    return {k: sum(st[k] for st in states) / len(states) for k in states[0]}


def read_trace(path, states, host_walls_us=None) -> Profile:
    """The profile of a trace of ``len(states)`` steps. Without step
    annotations (a device-only trace) every operation belongs to one span
    from the first to the last, the roofline takes the steps' mean state,
    and the window is the steps' wall time ``host_walls_us``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, pyev, launches, dev = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev["name"].startswith("bench_step_"):
            spans.append((int(ev["name"][11:]), float(ev["ts"]),
                          float(ev["ts"]) + float(ev["dur"])))
        elif cat == "python_function":
            m = _FRAME.search(ev["name"])
            pyev.append((float(ev["ts"]), float(ev["dur"]), ev.get("tid"),
                         (m.group(1), m.group(2)) if m else None))
        elif cat in _LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches.append((float(ev["ts"]), ev.get("tid"), corr))
        elif cat in _DEVICE_CATS:
            dev.append(ev)
    spans.sort()
    n_steps = len(states)
    if not spans:
        lo = min((float(ev["ts"]) for ev in dev), default=0.0)
        hi = max((float(ev["ts"]) + float(ev.get("dur", 0.0)) for ev in dev),
                 default=0.0)
        spans = [(0, lo, hi + 1.0)]
        states = [_mean_state(states)]
    frames = _stack_sites(pyev, launches)
    ops = []
    for ev in dev:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        step = next((k for k, s, e in spans if s <= ts < e), None)
        if step is None:
            continue
        fr = frames.get(ev.get("args", {}).get("correlation"), [])
        ops.append(DeviceOp(
            name=ev["name"], start_us=ts, dur_us=dur, step=step,
            modules=tuple(dict.fromkeys(f for f, _ in fr)),
            site=f"{fr[0][0]}:{fr[0][1]}" if fr else "(no port frame)"))
    window = (sum(host_walls_us) if host_walls_us is not None
              else sum(e - s for _, s, e in spans))
    prof = Profile(ops=ops, spans=[(s, e) for _, s, e in spans],
                   states=states, n_steps=n_steps, window_us=window)
    _busy_and_gaps(prof)
    return prof


def _busy_and_gaps(prof: Profile):
    """The union of device intervals inside each step span, and the idle
    gaps between them, each named by the port frame that launched the
    operation the gap ends at ("step end" for the last gap)."""
    busy, gaps = 0.0, []
    for k, (s, e) in enumerate(prof.spans):
        ops = sorted((op for op in prof.ops if op.step == k),
                     key=lambda op: op.start_us)
        cur = s
        for op in ops:
            if op.start_us > cur:
                gaps.append((op.site, op.start_us - cur))
            end = min(op.start_us + op.dur_us, e)
            if end > cur:
                busy += end - max(op.start_us, cur)
                cur = end
        if e > cur:
            gaps.append(("step end (host after the last kernel)", e - cur))
    prof.busy_us = busy
    gaps.sort(key=lambda g: -g[1])
    prof.gaps = [[name, us / 1e6] for name, us in gaps[:10]]


def profile_steps(snapshot, nsteps: int, with_stack: bool) -> Profile:
    """Profile ``nsteps`` steps of a fresh replay of ``snapshot`` (one
    episode's first steps): the device only, or the host too with the
    Python stack. The trace goes to a temporary directory under TMPDIR and
    is removed once read."""
    scene = copy.deepcopy(snapshot)
    dev = scene.world.device
    states, walls = [], []
    act = [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if with_stack or not act:
        act.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=act,
                                with_stack=with_stack) as prof:
        for k in range(nsteps):
            w = scene.world
            fl, bd = w.fluids_state, w.boundaries_state
            # The step replaces these tensors; it does not write into them.
            pre = (fl.alive, bd.alive)
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"bench_step_{k}"):
                scene.step()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e6)
            d = w.last_diagnostics
            states.append((pre, d.ncontacts_ff, d.ncontacts_fb))
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        inputs = [roofline.step_state(fa.sum(), ba.sum(), ff, fb)
                  for (fa, ba), ff, fb in states]
        return read_trace(path, inputs,
                          None if with_stack else walls)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
