"""The port's spans and host-sync counts (``salva_tpu_torch.counters``) on
the CPU: off, a span is one shared object that does nothing; on, a step
records the tree of its stages, each host read sits in a ``sync.<site>``
span and is counted in ``HOST_SYNCS``, and under ``torch.profiler`` every
span is a ``user_annotation`` of the trace."""

import json

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import counters
from salva_tpu_torch.coupling import ColliderSampling, FluidsPipeline
from salva_tpu_torch.shapes import Cuboid
from test_torch_package import _tiny_world

GRAVITY = (0.0, -9.81)
# The stages of a dense substep, in order (``solver.fb_table`` runs only
# with a sparse fb table, which the tiny world's grid does not take).
SUBSTEP = ["solver.bin", "solver.boundary_volumes", "solver.hoist",
           "solver.divergence", "solver.forces", "solver.pressure",
           "solver.boundary_forces", "solver.unbin"]


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts with the spans off and the record empty (the switch
    is the process's: a world enabled by an earlier test turns it on)."""
    counters.Counters().disable()
    counters.take_spans()
    yield
    counters.Counters().disable()
    counters.take_spans()


def test_off_a_span_is_one_shared_object_that_records_nothing(monkeypatch):
    """Off, ``span`` allocates no span (one shared object, whatever its
    arguments), reads no clock and enters no ``record_function``, even
    under a profiler; ``fetch`` still counts."""
    counters.take_spans()
    timer = counters.Timer()
    assert counters.span("world.step") is counters.NO_SPAN
    assert counters.span("world.substep", timer, step=3, substep=1) is \
        counters.NO_SPAN

    def refused(*args):
        raise AssertionError("entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(counters.time, "perf_counter_ns", refused)
    counters.reset_host_syncs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            with counters.span("world.step", timer) as s:
                assert s is None
        assert bool(counters.fetch("converged", torch.ones(())))
    assert counters.HOST_SYNCS["converged"] == 1
    assert timer.time == 0.0
    assert counters.take_spans() == []


def test_a_step_records_its_stage_tree_and_counts_its_host_reads():
    w = _tiny_world()
    counters.reset_host_syncs()
    w.counters.enable()
    w.step(1.0 / 200.0, GRAVITY)
    spans = counters.take_spans()
    names = [s[0] for s in spans]
    assert names[0] == "world.step" and spans[0][1] == -1
    assert [s for s in spans if s[1] == -1] == [spans[0]]
    children = {}
    for i, (name, parent, step, substep, t0, t1) in enumerate(spans):
        assert step == 0
        if parent >= 0:
            p = spans[parent]
            assert p[4] <= t0 <= t1 <= p[5]
            children.setdefault(parent, []).append(name)
    top = [n for n in children[0] if not n.startswith("sync.")]
    assert top == ["world.prepare", "world.substep", "world.overflow_check"]
    sub = names.index("world.substep")
    assert spans[sub][3] == 0
    assert [n for n in children[sub]] == SUBSTEP
    for stage in ("solver.divergence", "solver.pressure"):
        assert set(children[names.index(stage)]) == {"sync.converged"}
    # Every read was counted once, in its own sync span.
    d = w.last_diagnostics.solver
    cfg = w.solver_config
    converged = (d.divergence_iters - cfg.min_divergence_iter
                 + d.pressure_iters - cfg.min_pressure_iter)
    assert counters.HOST_SYNCS == dict(
        counters.HOST_SYNCS, converged=converged, viscosity_converged=0,
        cfl=0, coupling=0, scatter_table=0,
        # the first step: the auto caps' occupancy (fluid and boundary
        # positions and masks), the fitted window's first sizing and its
        # full-domain boundary volumes, the sparse fb table's size, and the
        # overflow check with its window refit
        cell_counts=4, initial_fit=3, full_boundary_volumes=3, fb_columns=2,
        overflow_check=5)
    assert sorted(n for n in names if n.startswith("sync.")) == sorted(
        f"sync.{k}" for k, v in counters.HOST_SYNCS.items() for _ in range(v))
    # A later step (no overflow check) reads only the convergence tests.
    counters.reset_host_syncs()
    w.step(1.0 / 200.0, GRAVITY)
    d = w.last_diagnostics.solver
    assert sum(counters.HOST_SYNCS.values()) == counters.HOST_SYNCS[
        "converged"] == d.divergence_iters + d.pressure_iters - 2
    spans = counters.take_spans()
    assert {s[2] for s in spans} == {1}
    assert [s[0] for s in spans if s[1] == 0] == [
        "world.prepare", "world.substep"]


def test_under_the_profiler_every_span_is_a_user_annotation(tmp_path):
    w = _tiny_world()
    w.step(1.0 / 200.0, GRAVITY)
    w.counters.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        w.step(1.0 / 200.0, GRAVITY)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    recorded = {s[0] for s in counters.take_spans()}
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert {"world.step", "solver.bin", "sync.converged"} <= recorded
    assert recorded <= annotated


def test_coupling_timers_and_reads_on_a_coupled_world():
    """``coupling_ms``'s two timers read the coupling spans; the host
    coupling path's reads of a dynamic body's boundary forces count."""
    pip = FluidsPipeline(0.05, dim=2, domain=((-1.0, -0.4), (1.0, 1.5)),
                         layout="dense", device="cpu")
    w = pip.liquid_world
    xs = (np.arange(6) * 0.1).astype(np.float32)
    w.add_fluid(st.Fluid(np.stack(np.meshgrid(xs, xs + 0.1, indexing="ij"),
                                  -1).reshape(-1, 2)))
    body = pip.bodies.add_body("dynamic", translation=(0.25, -0.1))
    co = pip.bodies.add_collider(body, Cuboid((0.3, 0.05)))
    bo = w.add_boundary(st.Boundary(np.zeros((0, 2), np.float32)))
    pts = np.stack([np.arange(-0.3, 0.31, 0.1, dtype=np.float32),
                    np.full(7, 0.05, np.float32)], -1)
    pip.coupling.register_coupling(bo, co,
                                   ColliderSampling.static_sampling(pts))
    counters.reset_host_syncs()
    w.counters.enable()
    pip.step((0.0, -9.81), 1.0 / 200.0)
    c = w.counters
    assert c.cd.boundary_update_time.time > 0.0
    assert c.coupling_transmit_time.time > 0.0
    assert c.step_time.time >= (c.cd.boundary_update_time.time
                                + c.coupling_transmit_time.time
                                + c.dispatch_time.time)
    assert counters.HOST_SYNCS["coupling"] == 2 * c.nsubsteps
    names = [s[0] for s in counters.take_spans()]
    assert names.count("coupling.update_boundaries") == c.nsubsteps
    assert names.count("sync.coupling") == 2 * c.nsubsteps
    assert c.cd.ncontacts > 0 and "ncontacts:" in str(c)


def test_the_record_stops_at_its_cap_and_the_timers_go_on(monkeypatch):
    """A run with counters on that nobody drains keeps at most
    ``MAX_SPANS`` spans; the spans past it still fill their timers."""
    monkeypatch.setattr(counters, "MAX_SPANS", 3)
    counters.Counters().enable()
    timer = counters.Timer()
    for step in range(3):
        with counters.span("world.step", timer, step=step):
            with counters.span("world.substep"):
                pass
    assert [(s[0], s[1], s[2]) for s in counters.take_spans()] == [
        ("world.step", -1, 0), ("world.substep", 0, 0), ("world.step", -1, 1)]
    assert timer.time > 0.0
    before = timer.time
    with counters.span("world.step", timer, step=3):
        pass
    assert timer.time > before
    assert [s[2] for s in counters.take_spans()] == [3]
