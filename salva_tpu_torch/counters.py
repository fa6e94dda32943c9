"""Performance counters and spans.

Plays the role of ``src/counters/`` (`counters/mod.rs:16-83`,
`timer.rs:13-19`): timers that are inert unless enabled, plus contact and
substep counts, printable as a profiling block:

- ``step_time``                 — ``LiquidWorld.step`` (the ``world.step``
  span), plus the device's finish when counters are enabled (``fetch_time``);
- ``dispatch_time``             — host time issuing the substeps
  (``world.substep``);
- ``cd.boundary_update_time``   — coupling boundary resampling
  (``coupling.update_boundaries``);
- ``coupling_transmit_time``    — boundary-force transmission
  (``coupling.transmit_forces``);
- ``fetch_time``                — the counters' own synchronise after the
  step, so that ``step_time`` is meaningful.

**Spans.** ``span(name)`` marks a stage of the step. While counters are on
(``Counters.enable()``, one switch for the process: ``DenseCtx`` holds no
world) each span appends ``(name, parent, step, substep, start_ns,
end_ns)`` to an in-memory record on ``time.perf_counter_ns``'s clock,
read by ``take_spans()``; while a ``torch.profiler`` session is active it
also enters ``torch.profiler.record_function(name)``, so the stage shows
as a ``user_annotation`` on the kernels' clock. Off (the default), ``span``
returns one shared object that does nothing. Each span that closes while
counters are on also adds its host time to a total by name, kept past the
record's cap and read by ``span_host_ns()``; ``Counters.enable()`` resets
it.

**Counts.** ``HOST_SYNCS`` counts the host reads of device values during a
step, by site: each read goes through ``fetch(site, tensor)``, counted
before it reads (counting never synchronises) and, with spans on, inside a
``sync.<site>`` span. ``FORCE_ITERATIONS`` counts the iterations of the
iterative non-pressure forces (the DFSPH viscosity's strain-rate
evaluations). Both count over every world since their reset, as
``ops.pair.LAUNCHES`` counts kernel launches, whether counters are on or
off.

Per-step solver iteration counts and error norms are returned in
``StepDiagnostics``; device-side stage times come from ``torch.profiler``.
"""

from __future__ import annotations

import threading
import time

import torch

FORCE_ITERATIONS = {"dfsph_viscosity": 0}

# The step's host reads of device values, by site:
# - ``converged``: the pressure and divergence solves' convergence test, once
#   per iteration from ``min_*_iter`` on (every solver and layout);
# - ``viscosity_converged``: the DFSPH viscosity's convergence test;
# - ``cfl``: the adaptive time step's speed bound, once a substep;
# - ``overflow_check``: the overflow check's reads (every 16th step, or
#   every step with ``debug_checks``);
# - ``cell_counts``: the auto cap tier's occupancy (and spill table) sizing;
# - ``fb_columns``: the sparse fb table's size, once per boundary capacity;
# - ``initial_fit``: the fitted grid window's first sizing;
# - ``full_boundary_volumes``: the fitted window's full-domain boundary
#   volumes, once per boundary-set change;
# - ``coupling``: the host coupling path's reads of emitted samples and
#   boundary forces (the device path reads nothing during a step);
# - ``scatter_table``: the gather layout's boundary-force table width.
HOST_SYNCS = dict.fromkeys(
    ("converged", "viscosity_converged", "cfl", "overflow_check",
     "cell_counts", "fb_columns", "initial_fit", "full_boundary_volumes",
     "coupling", "scatter_table"), 0)
_SYNC_SPANS = {site: "sync." + site for site in HOST_SYNCS}

# The record keeps at most this many spans between takes (about 15 MB); a
# run with counters on that nobody drains stops recording there, and its
# later spans still fill their timers.
MAX_SPANS = 100_000

_on = False
_spans = []  # [name, parent, step, substep, start_ns, end_ns] each
_host_ns = {}  # span name -> host ns of its closed spans since enable()
_host_lock = threading.Lock()  # the slab path closes spans on threads
_local = threading.local()  # .open: this thread's open span indices


def reset_force_iterations():
    for k in FORCE_ITERATIONS:
        FORCE_ITERATIONS[k] = 0


def reset_host_syncs():
    for k in HOST_SYNCS:
        HOST_SYNCS[k] = 0


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "timer", "step", "substep", "rec", "rf", "t0")

    def __init__(self, name, timer, step, substep):
        self.name, self.timer = name, timer
        self.step, self.substep = step, substep

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = None
        if len(_spans) < MAX_SPANS:
            parent = stack[-1] if stack else -1
            up = _spans[parent] if parent >= 0 else None
            step = self.step if self.step is not None else (
                up[2] if up is not None else -1)
            substep = self.substep if self.substep is not None else (
                up[3] if up is not None else -1)
            self.rec = [self.name, parent, step, substep, 0, 0]
            stack.append(len(_spans))
            _spans.append(self.rec)
        else:
            stack.append(-1)
        self.t0 = time.perf_counter_ns()
        if self.rec is not None:
            self.rec[4] = self.t0
        return None

    def __exit__(self, typ, value, tb):
        end = time.perf_counter_ns()
        if self.rec is not None:
            self.rec[5] = end
        _local.open.pop()
        with _host_lock:
            _host_ns[self.name] = _host_ns.get(self.name, 0) + (end - self.t0)
        if self.rf is not None:
            self.rf.__exit__(typ, value, tb)
        if self.timer is not None:
            self.timer.time += (end - self.t0) * 1e-9
        return False


def span(name: str, timer=None, step=None, substep=None):
    """A context marking one stage of a step (module note). ``timer``
    (a ``Timer``) takes the span's duration; ``step`` / ``substep`` (the
    world's step and substep counters) default to the enclosing span's."""
    if not _on:
        return NO_SPAN
    return _Span(name, timer, step, substep)


def fetch(site: str, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` copied to the host: one host sync counted at ``site`` (a
    key of ``HOST_SYNCS``), read inside a ``sync.<site>`` span."""
    HOST_SYNCS[site] += 1
    with span(_SYNC_SPANS[site]):
        return tensor.cpu()


def span_host_ns():
    """Host ns by span name of the spans closed since the last
    ``Counters.enable()``, counters on: ``{name: ns}``, a copy. Unlike
    ``take_spans`` it clears nothing and has no cap."""
    return dict(_host_ns)


def take_spans():
    """The spans recorded since the last call (or ``Counters.enable()``),
    oldest first, and clear the record: tuples ``(name, parent, step,
    substep, start_ns, end_ns)``, ``parent`` an index into the list (-1 for
    a root). Take them between steps, with no span open."""
    out = [tuple(r) for r in _spans]
    _spans.clear()
    return out


class Timer:
    """A duration in seconds (``time``), filled by the spans that name it."""

    def __init__(self):
        self.time = 0.0

    def __str__(self):
        return f"{self.time * 1000.0:.2f}ms"


class CollisionDetectionCounters:
    def __init__(self):
        self.boundary_update_time = Timer()
        self.diagnostics = None  # the last step's StepDiagnostics

    @property
    def ncontacts(self) -> int:
        """Fluid-fluid plus fluid-boundary contacts of the last step, read
        from its diagnostics when asked (never inside a step)."""
        d = self.diagnostics
        if d is None:
            return 0
        return int(d.ncontacts_ff + d.ncontacts_fb)


class Counters:
    """Aggregate of all counters (`counters/mod.rs:16-30`)."""

    def __init__(self):
        self.enabled = False
        self.nsubsteps = 0
        self.step_time = Timer()
        self.dispatch_time = Timer()
        self.coupling_transmit_time = Timer()
        self.fetch_time = Timer()
        self.cd = CollisionDetectionCounters()

    def _timers(self):
        return [
            self.step_time,
            self.dispatch_time,
            self.coupling_transmit_time,
            self.fetch_time,
            self.cd.boundary_update_time,
        ]

    def enable(self):
        """Turn the timers and the spans on; the span record and the host
        totals by name start anew."""
        global _on
        self.enabled = True
        _on = True
        _spans.clear()
        _host_ns.clear()

    def disable(self):
        global _on
        self.enabled = False
        _on = False

    def reset(self):
        self.nsubsteps = 0
        for t in self._timers():
            t.time = 0.0

    def finish_step(self, device, diagnostics):
        """After a step: keep its diagnostics for ``cd.ncontacts`` and,
        when enabled, wait for the device, adding the wait to
        ``step_time``."""
        self.cd.diagnostics = diagnostics
        if not self.enabled:
            return
        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.fetch_time.time = time.perf_counter() - t0
        self.step_time.time += self.fetch_time.time

    def __str__(self):
        return (
            f"Total timestep time: {self.step_time}\n"
            f"|_ boundary update (coupling): {self.cd.boundary_update_time}\n"
            f"|_ substep dispatch: {self.dispatch_time}\n"
            f"|_ coupling force transmit: {self.coupling_transmit_time}\n"
            f"|_ device sync (fetch): {self.fetch_time}\n"
            f"ncontacts: {self.cd.ncontacts}\n"
            f"nsubsteps: {self.nsubsteps}\n"
            "(stage spans: counters.take_spans(); device-side stage "
            "breakdown: torch.profiler; solver iterations/errors: "
            "StepDiagnostics)"
        )
