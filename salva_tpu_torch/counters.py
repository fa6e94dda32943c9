"""Performance counters.

Plays the role of ``src/counters/`` (`counters/mod.rs:16-83`,
`timer.rs:13-19`): wall-clock timers that are inert unless enabled, plus
contact/substep counts, printable as a profiling block. The same classes
as ``salva_tpu.counters``.

- ``step_time``          — the full ``LiquidWorld.step`` wall time
  (device-synchronized when counters are enabled, so it is meaningful);
- ``dispatch_time``      — host time spent issuing the substep's work;
- ``cd.boundary_update_time``   — coupling boundary resampling;
- ``coupling_transmit_time``    — boundary-force transmission;
- ``fetch_time``         — the end-of-step device sync.

Per-step solver iteration counts and error norms are returned in
``StepDiagnostics``; device-side stage times come from ``torch.profiler``.

``FORCE_ITERATIONS`` counts the iterations of the iterative non-pressure
forces (the DFSPH viscosity's strain-rate evaluations) since the last
``reset_force_iterations``, over every world, as ``ops.pair.LAUNCHES``
counts kernel launches.
"""

from __future__ import annotations

import time

FORCE_ITERATIONS = {"dfsph_viscosity": 0}


def reset_force_iterations():
    for k in FORCE_ITERATIONS:
        FORCE_ITERATIONS[k] = 0


class Timer:
    def __init__(self):
        self.enabled = False
        self._start = None
        self.time = 0.0

    def start(self):
        if self.enabled:
            self.time = 0.0
            self._start = time.perf_counter()

    def resume(self):
        if self.enabled:
            self._start = time.perf_counter()

    def pause(self):
        if self.enabled and self._start is not None:
            self.time += time.perf_counter() - self._start
            self._start = None

    def __str__(self):
        return f"{self.time * 1000.0:.2f}ms"


class CollisionDetectionCounters:
    def __init__(self):
        self.ncontacts = 0
        self.boundary_update_time = Timer()


class Counters:
    """Aggregate of all counters (`counters/mod.rs:16-30`)."""

    def __init__(self):
        self.enabled = False
        self.nsubsteps = 0
        self.step_time = Timer()
        self.dispatch_time = Timer()
        self.coupling_transmit_time = Timer()
        self.fetch_time = Timer()
        self.custom = Timer()
        self.cd = CollisionDetectionCounters()

    def _timers(self):
        return [
            self.step_time,
            self.dispatch_time,
            self.coupling_transmit_time,
            self.fetch_time,
            self.custom,
            self.cd.boundary_update_time,
        ]

    def enable(self):
        self.enabled = True
        for t in self._timers():
            t.enabled = True

    def disable(self):
        self.enabled = False
        for t in self._timers():
            t.enabled = False

    def reset(self):
        self.nsubsteps = 0
        for t in self._timers():
            t.time = 0.0

    def __str__(self):
        return (
            f"Total timestep time: {self.step_time}\n"
            f"|_ boundary update (coupling): {self.cd.boundary_update_time}\n"
            f"|_ substep dispatch: {self.dispatch_time}\n"
            f"|_ coupling force transmit: {self.coupling_transmit_time}\n"
            f"|_ device sync (fetch): {self.fetch_time}\n"
            f"ncontacts: {self.cd.ncontacts}\n"
            f"nsubsteps: {self.nsubsteps}\n"
            "(device-side stage breakdown: torch.profiler; solver "
            "iterations/errors: StepDiagnostics)"
        )
