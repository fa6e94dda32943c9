"""The IISPH Jacobi loop's span and the host totals by span name
(``salva_tpu_torch.counters``) on the CPU: one ``solver.jacobi`` span a
substep around the whole relaxed-Jacobi loop, holding each iteration's
``sync.converged``; a total by name filled as each span closes while the
counters are on, reset by ``Counters.enable()`` and left alone while they
are off; and the benchmark's ``jacobi_host_ms``, which reads that total."""

import sys
import threading

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from benchmark import harness
from salva_tpu_torch import counters
from salva_tpu_torch.config import IISPHConfig
from test_torch_package import _tiny_world

torch.set_num_threads(1)

GRAVITY = (0.0, -9.81)
DT = 1.0 / 200.0


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts with the spans off, the record and the totals
    empty (the switch is the process's)."""
    c = counters.Counters()
    c.enable()
    c.disable()
    counters.take_spans()
    yield
    c.enable()
    c.disable()
    counters.take_spans()


def _world(layout):
    """The tiny 2D dam break under IISPH on ``layout``, past its first
    step (the first step's one-off reads)."""
    if layout == "dense":
        w = _tiny_world(solver=IISPHConfig())
    else:
        w = st.LiquidWorld(solver=IISPHConfig(), particle_radius=0.05, dim=2,
                           layout="gather", device="cpu")
        xs = (np.arange(6) * 0.1).astype(np.float32)
        w.add_fluid(st.Fluid(np.stack(np.meshgrid(xs, xs + 0.1,
                                                  indexing="ij"),
                                      -1).reshape(-1, 2)))
        w.add_boundary(st.Boundary(np.stack(
            [np.arange(-0.5, 1.0, 0.1, dtype=np.float32),
             np.full(15, -0.05, np.float32)], -1)))
    w.step(DT, GRAVITY)
    return w


def _steps(w, n):
    """``n`` steps with the counters on; their pressure iterations."""
    w.counters.enable()
    iters = []
    for _ in range(n):
        w.step(DT, GRAVITY)
        iters.append(w.last_diagnostics.solver.pressure_iters)
    w.counters.disable()
    return iters


@pytest.mark.parametrize("layout,parent", [("dense", "solver.pressure"),
                                           ("gather", "world.substep")])
def test_one_jacobi_span_a_substep_holds_each_convergence_read(layout,
                                                               parent):
    w = _world(layout)
    counters.reset_host_syncs()
    iters = _steps(w, 3)
    spans = counters.take_spans()
    names = [s[0] for s in spans]
    jacobi = [k for k, n in enumerate(names) if n == "solver.jacobi"]
    assert len(jacobi) == names.count("world.substep") == 3
    for k in jacobi:
        assert names[spans[k][1]] == parent
    # Each iteration's convergence read nests in the loop's span, and the
    # loop opens no span of its own per iteration.
    inside = [k for k, s in enumerate(spans) if s[1] in jacobi]
    assert {names[k] for k in inside} == {"sync.converged"}
    assert len(inside) == names.count("sync.converged") == sum(
        i - IISPHConfig().min_pressure_iter for i in iters)
    assert counters.HOST_SYNCS["converged"] == len(inside)


def test_the_host_total_is_the_sum_of_the_recorded_spans():
    w = _world("dense")
    _steps(w, 2)
    spans = counters.take_spans()
    totals = counters.span_host_ns()
    assert totals["solver.jacobi"] > 0
    for name in {s[0] for s in spans}:
        assert totals[name] == sum(s[5] - s[4] for s in spans
                                   if s[0] == name), name
    # Taking the record leaves the totals alone.
    assert counters.span_host_ns() == totals


def test_enable_resets_the_totals_and_off_they_stay():
    w = _world("dense")
    assert counters.span_host_ns() == {}
    w.step(DT, GRAVITY)             # counters off
    assert counters.span_host_ns() == {}
    _steps(w, 1)
    on = counters.span_host_ns()
    assert on["solver.jacobi"] > 0
    w.step(DT, GRAVITY)             # off again: nothing added
    assert counters.span_host_ns() == on
    w.counters.enable()
    assert counters.span_host_ns() == {}
    w.counters.disable()


def test_spans_closed_on_many_threads_lose_no_host_time():
    """The slab path closes spans on one thread a slab: with more threads
    than cores and a short switch interval, the total still equals the
    sum of every recorded span."""
    counters.Counters().enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with counters.span("solver.jacobi"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        counters.Counters().disable()
    spans = counters.take_spans()
    assert len(spans) == 16 * 500
    assert counters.span_host_ns() == {
        "solver.jacobi": sum(s[5] - s[4] for s in spans)}


def _run(nsteps):
    rec = harness.StepRecord(0.01, False, 3, None)
    return harness.Run(n_live=36, setup_s=1.0, window_s=1.0,
                       steps=[rec] * nsteps)


def test_jacobi_host_ms_reads_the_total_over_the_window(monkeypatch):
    read = harness.metric_reader("jacobi_host_ms")
    w = _world("dense")
    _steps(w, 3)
    spans = counters.take_spans()
    ns = sum(s[5] - s[4] for s in spans if s[0] == "solver.jacobi")
    assert read(_run(3)) == pytest.approx(ns / 3 / 1e6, rel=1e-12)
    monkeypatch.setattr(counters, "span_host_ns",
                        lambda: {"solver.jacobi": 8_000_000})
    assert read(_run(4)) == pytest.approx(2.0)
    # Nothing to read: no step in the span (a DFSPH world), an empty
    # window, or a program without the totals.
    monkeypatch.setattr(counters, "span_host_ns", lambda: {"world.step": 5})
    assert read(_run(4)) is None
    monkeypatch.setattr(counters, "span_host_ns",
                        lambda: {"solver.jacobi": 8_000_000})
    assert read(_run(0)) is None
    monkeypatch.delattr(counters, "span_host_ns")
    assert read(_run(4)) is None
