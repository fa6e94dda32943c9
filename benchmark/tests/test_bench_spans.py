"""The readers of the port's spans on the CPU: the window's record
(``host_issue_ms``, ``host_syncs_per_step``) and the profile with the spans
on (device time by span, idle gaps named by the span open at their start),
on synthetic records and a synthetic Chrome trace."""

import json

import pytest

from benchmark import harness, spans


def record(t0, name, parent, start, end):
    return (name, parent, 0, -1, t0 + start, t0 + end)


def synthetic_window():
    """Two steps (ns): 1,000 and 2,000 long, with 100 + 50 and 300 ns of
    host reads at different depths; a span on another thread (a root that
    is no step) counts for nothing."""
    out = [record(0, "world.step", -1, 0, 1000),
           record(0, "world.prepare", 0, 10, 200),
           record(0, "sync.cell_counts", 1, 20, 120),
           record(0, "world.substep", 0, 300, 900),
           record(0, "solver.pressure", 3, 400, 800),
           record(0, "sync.converged", 4, 500, 550),
           record(5000, "solver.bin", -1, 0, 100),
           record(9000, "world.step", -1, 0, 2000)]
    out.append(record(9000, "world.overflow_check", 7, 1000, 1900))
    out.append(record(9000, "sync.overflow_check", 8, 1100, 1400))
    return out


def test_window_readers_sum_the_steps_spans(monkeypatch):
    from salva_tpu_torch import counters

    taken = []
    monkeypatch.setattr(counters, "take_spans",
                        lambda: taken.append(1) or synthetic_window())
    run = harness.Run(1, 0, 1, [])
    issue = harness.metric_reader("host_issue_ms")(run)
    syncs = harness.metric_reader("host_syncs_per_step")(run)
    assert issue == pytest.approx((850 + 1700) / 2 / 1e6)
    assert syncs == pytest.approx(1.5)
    assert taken == [1]  # the record is taken once a run


def test_window_readers_read_nothing_without_spans(monkeypatch):
    """A program that records no spans (the parent of the spans) gives no
    reading, and no error."""
    from salva_tpu_torch import counters

    monkeypatch.delattr(counters, "take_spans")
    for m in ("host_issue_ms", "host_syncs_per_step"):
        assert harness.metric_reader(m)(harness.Run(1, 0, 1, [])) is None
    monkeypatch.setattr(counters, "take_spans", lambda: [], raising=False)
    assert harness.metric_reader("host_issue_ms")(
        harness.Run(1, 0, 1, [])) is None


def annotation(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur,
                tid=tid)


def launch(ts, corr):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts,
                dur=1, tid=1, args=dict(correlation=corr))


def kernel(ts, dur, corr):
    return dict(ph="X", cat="kernel", name=f"k{corr}", ts=ts, dur=dur, tid=7,
                args=dict(correlation=corr))


def test_device_time_and_idle_gaps_by_span(tmp_path):
    ev = [annotation("bench_step_0", 0, 100),
          annotation("world.step", 2, 88),
          annotation("world.substep", 5, 55),
          annotation("solver.bin", 6, 14),
          annotation("solver.pressure", 30, 25),
          annotation("sync.converged", 40, 10),
          launch(7, 1), kernel(10, 5, 1),          # in solver.bin
          launch(32, 2), kernel(35, 10, 2),        # in solver.pressure
          launch(62, 3), kernel(70, 5, 3),         # world.step's own
          launch(95, 4), kernel(96, 2, 4),         # after world.step
          kernel(150, 9, 5)]                       # outside the step
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    p = spans.read(path, 1)
    assert p.device_us == pytest.approx(22.0)
    assert p.device_ms("solver.bin") == pytest.approx(0.005)
    assert p.device_ms("solver.boundary_volumes") is None
    assert p.device_ms("world.substep") == pytest.approx(0.015)
    assert p.device_ms("world.step") == pytest.approx(0.020)
    t = p.table
    assert t["world.step"]["self_device_ms"] == pytest.approx(0.005)
    assert t["world.substep"]["self_device_ms"] == 0.0
    assert t["(outside the program's spans)"]["device_ms"] == \
        pytest.approx(0.002)
    assert p.unstaged_share() == pytest.approx(100.0 * 5 / 22)
    assert t["world.step"]["host_ms"] == pytest.approx(0.088)
    assert t["world.step"]["self_host_ms"] == pytest.approx(0.033)
    assert t["solver.pressure"]["self_host_ms"] == pytest.approx(0.015)
    assert t["world.step"]["syncs"] == t["sync.converged"]["syncs"] == 1
    assert t["solver.bin"]["syncs"] == 0
    # Busy 5 + 10 + 5 + 2 of 100 us; each gap named by the span open on
    # the host at its start.
    assert p.idle_share() == pytest.approx(78.0)
    assert [(n, round(s * 1e6, 6)) for n, s in p.gaps] == [
        ("sync.converged", 25.0), ("world.step", 21.0), ("solver.bin", 20.0),
        ("(outside the program's spans)", 10.0),
        ("(outside the program's spans)", 2.0)]
    assert t["solver.bin"]["idle_ms"] == pytest.approx(0.020)
