"""The harness on the CPU: the scene it builds, its replays, its metric
arithmetic, its trace reading, its yardstick and its data-driven files."""

import copy
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, harness, parts, roofline, trace
from benchmark.tests.test_bench_reference import config

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,builder", [("harness_basic3_n40",
                                           "harness_basic3"),
                                          ("basic3_n15", "basic3")])
def test_initial_state_equals_the_ports_scene(name, builder):
    """With the jitter off, the configuration builds the port's own scene:
    the fluid, the colliders and their samples, the forces, and after one
    step the same positions, boundary forces and caps."""
    from salva_tpu_torch import scenes

    n = 6
    cfg = config(name, nparticles=n, jitter=0.0)
    mine = harness.Scene(cfg, 0, "cpu")
    theirs = getattr(scenes, builder)(nparticles=n, device="cpu")
    wa, wb = mine.world, theirs.world
    np.testing.assert_array_equal(wa.fluid_positions(mine.fluid),
                                  wb.fluid_positions(theirs.fluid_handles[0]))
    assert [r.nonpressure_forces for r in wa._fluid_records] == [
        r.nonpressure_forces for r in wb._fluid_records]
    assert wa.sim == wb.sim
    pa, pb = mine.pipeline, theirs.pipeline
    assert len(pa.bodies.colliders) == len(pb.bodies.colliders) == 5
    for c in range(5):
        for x, y in zip(pa.bodies.collider_pose(c), pb.bodies.collider_pose(c)):
            np.testing.assert_array_equal(x, y)
    ea, eb = list(pa.coupling.entries.values()), list(pb.coupling.entries.values())
    for x, y in zip(ea, eb):
        np.testing.assert_array_equal(x.sampling.points, y.sampling.points)
    mine.step()
    theirs.step()
    np.testing.assert_array_equal(wa.fluid_positions(mine.fluid),
                                  wb.fluid_positions(theirs.fluid_handles[0]))
    torch.testing.assert_close(wa.boundaries_state.forces,
                               wb.boundaries_state.forces, rtol=0, atol=0)
    assert wa._auto_caps == wb._auto_caps


def small_cell(name="basic3_n15.collapse", n=4, **traffic):
    cell = harness.load_cell(name)
    cell.config["nparticles"] = n
    cell.traffic.update(dict(warmup_steps=1, episode_steps=2, check_steps=6,
                             profile_steps=1), **traffic)
    return cell


def test_replayed_episodes_are_bitwise_equal():
    cell = small_cell()
    snap, _, _ = harness.set_up(cell, 5, torch.device("cpu"), "brute", True)
    runs = []
    for _ in range(2):
        scene = copy.deepcopy(snap)
        pos, iters = [], []
        for _ in range(2):
            rec, _ = harness.take_step(scene, False)
            pos.append(scene.world.fluids_state.positions.clone())
            iters.append(rec.iters)
        runs.append((pos, iters))
    assert runs[0][1] == runs[1][1]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    # The snapshot itself never steps.
    assert snap.steps_taken == 1


def test_window_counts_failed_steps_and_restores():
    cell = small_cell(episode_steps=1)
    snap, _, _ = harness.set_up(cell, 6, torch.device("cpu"), "brute", True)
    recs, window_s, sample, _ = harness.window(snap, cell, 0.0, 6, False)
    assert len(recs) == 1 and len(sample) == 1
    assert sample[0]["step"] == 2 and window_s >= recs[0].wall_s
    rec = recs[0]
    assert not rec.failed
    assert dataclass_failed(overflow=1) and dataclass_failed(clamped=2)
    assert dataclass_failed(finite=False) and dataclass_failed(raised=True)


def dataclass_failed(**kw):
    return harness.StepRecord(0.1, False, 4, None, **kw).failed


def test_metric_arithmetic():
    steps = [harness.StepRecord(k / 1e3, k % 16 == 0, 4 + k % 2, 1e-3)
             for k in range(1, 101)]
    run = harness.Run(n_live=1000, setup_s=12.5, window_s=6.0, steps=steps)
    read = {m: harness.metric_reader(m)(run) for m in (
        "particle_steps_per_s", "step_ms_p95", "setup_s", "check_step_ms",
        "solver_iters", "coupling_ms")}
    # The rate is over the whole window (6 s), not the sum of the steps'
    # wall times (5.05 s): restores count.
    assert read["particle_steps_per_s"] == pytest.approx(1000 * 100 / 6.0)
    assert read["step_ms_p95"] == pytest.approx(95.05)
    assert read["setup_s"] == 12.5
    assert read["check_step_ms"] == pytest.approx(np.mean([16, 32, 48, 64,
                                                           80, 96]))
    assert read["solver_iters"] == pytest.approx(4.5)
    assert read["coupling_ms"] == pytest.approx(1.0)
    assert harness.metric_reader("device_idle_share")(run) is None


def synthetic_profile():
    ops = [trace.DeviceOp("k_a", 10.0, 20.0, 0, ("salva_tpu_torch/x.py",), "a"),
           trace.DeviceOp("k_b", 20.0, 20.0, 0, ("salva_tpu_torch/y.py",
                                                 "salva_tpu_torch/x.py"), "b"),
           trace.DeviceOp("k_c", 60.0, 10.0, 0, (), "c")]
    p = trace.Profile(ops=ops, spans=[(0.0, 100.0)], states=[{}], n_steps=1,
                      window_us=100.0)
    trace._busy_and_gaps(p)
    return p


def test_idle_share_and_gaps_from_synthetic_intervals():
    p = synthetic_profile()
    assert p.busy_us == pytest.approx(40.0)
    run = harness.Run(1, 0, 1, [], profile=p, stack_profile=p)
    assert harness.metric_reader("device_idle_share")(run) == pytest.approx(60)
    assert [g[0] for g in p.gaps] == ["step end (host after the last kernel)",
                                      "c", "a"]
    assert p.gaps[0][1] == pytest.approx(30e-6)
    assert p.module_device_ms("salva_tpu_torch/x.py") == pytest.approx(0.04)
    assert p.module_device_ms("salva_tpu_torch/y.py") == pytest.approx(0.02)
    assert p.module_device_ms("salva_tpu_torch/z.py") is None


def test_trace_reader_joins_kernels_to_port_frames(tmp_path):
    ev = [
        dict(ph="X", cat="user_annotation", name="bench_step_0", ts=0, dur=100,
             tid=1),
        dict(ph="X", cat="python_function", ts=1, dur=90, tid=1,
             name="/ck/salva_tpu_torch/solver/forces_dense.py(205): apply"),
        dict(ph="X", cat="python_function", ts=2, dur=10, tid=1,
             name="salva_tpu_torch/kernels/sph.py(205): w_dwr"),
        dict(ph="X", cat="python_function", ts=20, dur=10, tid=1,
             name="torch/functional.py(1): stack"),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=5, dur=1,
             tid=1, args=dict(correlation=7)),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=25,
             dur=1, tid=1, args=dict(correlation=8)),
        dict(ph="X", cat="kernel", name="tile_pass_kernel<3, KPass>", ts=8,
             dur=4, tid=7, args=dict(correlation=7)),
        dict(ph="X", cat="kernel", name="elementwise", ts=30, dur=10, tid=7,
             args=dict(correlation=8)),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    p = trace.read_trace(path, [{}])
    a, b = sorted(p.ops, key=lambda o: o.start_us)
    assert a.modules == ("salva_tpu_torch/kernels/sph.py",
                         "salva_tpu_torch/solver/forces_dense.py")
    assert a.site == "salva_tpu_torch/kernels/sph.py:w_dwr"
    assert b.modules == ("salva_tpu_torch/solver/forces_dense.py",)
    assert p.module_device_ms("salva_tpu_torch/solver/forces_dense.py") == \
        pytest.approx(0.014)
    assert p.busy_us == pytest.approx(14.0)
    assert roofline.kernel_kind(a.name) == "k_pass"


def test_device_only_trace_takes_the_host_walls(tmp_path):
    """Without step annotations every device operation counts, the window
    is the steps' wall time on the harness's clock, and the roofline takes
    the steps' mean state."""
    ev = [dict(ph="X", cat="kernel", name="hoist_fb_warps<3>", ts=1000,
               dur=30, args=dict(correlation=1)),
          dict(ph="X", cat="kernel", name="x", ts=1020, dur=20,
               args=dict(correlation=2)),
          dict(ph="X", cat="gpu_memset", name="Memset", ts=5000, dur=10)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    st = [roofline.step_state(10, 0, 0, w) for w in (10, 30)]
    p = trace.read_trace(path, st, host_walls_us=[150.0, 250.0])
    assert p.n_steps == 2 and p.window_us == 400.0
    assert p.busy_us == pytest.approx(50.0)
    assert p.states == [dict(n_f=10, n_b=0, within_ff=0, within_fb=20)]
    run = harness.Run(1, 0, 1, [], profile=p)
    assert harness.metric_reader("device_idle_share")(run) == pytest.approx(
        87.5)
    bound, time = roofline.kernels_roofline(p)
    assert time == pytest.approx(30e-6)
    assert bound == pytest.approx(roofline.call_bound_s("hoist_fb",
                                                        p.states[0]))


def test_roofline_counts_the_work_the_inputs_need():
    """k_pass at the DFSPH main path's state after 30 steps (PERF.md
    section 6: 97,336 live particles, 2,849,854 pairs within h): 22
    operations a pair within h, 62,696,788 in all, 0.000936 ms at 67
    TFLOP/s, against 3,114,752 B (x, m, k read and a vector written once a
    particle), 0.000930 ms at 3.35 TB/s. The candidate pairs a cell list
    rejects count nothing."""
    st = roofline.step_state(97336, 0, 2849854, 0)
    s, by = roofline.bound_s(97336 * 5 * 4, 97336 * 3 * 4, 2849854, "k_pass")
    assert by == "operations" and round(s * 1e3, 6) == 0.000936
    assert roofline.call_bound_s("k_pass", st) == s
    assert round(3114752 / roofline.HBM_BYTES_PER_S * 1e3, 6) == 0.00093
    assert [roofline.ops_within(k) for k in
            ("k_pass", "t_pass", "hoist_ff", "hoist_fb")] == [22, 22, 48, 57]


def test_the_boundary_hoist_is_bound_by_its_bytes():
    """hoist_fb reads the fluid's positions and every wall sample's
    position, velocity and volume, and writes 5 + 3 sums a particle: at
    64,000 fluid, 13,458 wall samples and 200,000 pairs within h its bytes
    (2,192,000 + 376,824 B) take longer than its 11.4 M operations."""
    st = roofline.step_state(64000, 13458, 0, 200000)
    s = roofline.call_bound_s("hoist_fb", st)
    nbytes = 64000 * 3 * 4 + 13458 * 7 * 4 + 64000 * 8 * 4
    assert s == pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)
    assert roofline.bound_s(0, 0, 200000, "hoist_fb")[0] < s


NEW_SCENE = """
from benchmark import parts

_box = parts.load("scenes", "basic3_box")
colliders, wall_samples, force_scale, build = (
    _box.colliders, _box.wall_samples, _box.force_scale, _box.build)


def initial_fluid(cfg, seed):
    pos = _box.initial_fluid(cfg, seed)
    pos[:, 1] += 0.3
    return pos


def domain(cfg):
    return _box.domain(dict(cfg, nparticles=cfg["nparticles"] + 6))
"""

NEW_SOLVER = """
from benchmark import parts

_d = parts.load("solvers", "dfsph")
program_solver, state, at_rest, moved_velocity, reference_step = (
    _d.program_solver, _d.state, _d.at_rest, _d.moved_velocity,
    _d.reference_step)
"""

NEW_FORCE = """
import torch


def accel(ctx, *args):
    return torch.zeros((ctx.n, 3), dtype=ctx.acc_dtype,
                       device=ctx.velocities.device)
"""


def test_a_new_scene_solver_and_force_are_files_alone(tmp_path, monkeypatch):
    """A configuration that names a scene, a solver and a force the
    benchmark did not have runs and is checked once their files are
    added: here a higher drop, DFSPH under another name, and a force
    whose reference is zero beside the port's viscosity at coefficient
    0."""
    d = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", d)
    (d / "scenes" / "basic3_drop.py").write_text(NEW_SCENE)
    (d / "solvers" / "dfsph_again.py").write_text(NEW_SOLVER)
    (d / "reference" / "forces" / "nothing.py").write_text(NEW_FORCE)
    monkeypatch.setattr(parts, "BENCH_DIR", d)
    cfg = json.loads((d / "configs" / "basic3_n15.json").read_text())
    cfg.update(nparticles=3, scene="basic3_drop", solver="dfsph_again",
               forces=[dict(program="ArtificialViscosity", args=[0.0, 0.0],
                            reference="nothing")])
    scene = harness.Scene(cfg, 9, "cpu", layout="brute", device_coupling=True)
    assert scene.initial[:, 1].min() > 0.5
    harness.take_step(scene, False)
    first = dict(after=scene.state(), slots=scene.slots())
    gaps = check.compare(cfg, scene.initial, [first], "cpu")
    assert gaps["pos_gap_m"] < 1e-6 and gaps["vel_gap"] < 1e-5


def test_a_new_cell_is_found_without_an_edit(tmp_path, monkeypatch):
    """A later change adds a configuration, a traffic mix, a cell's limits
    and a metric as files and entries; the harness finds them by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    monkeypatch.setattr(parts, "BENCH_DIR", tmp_path / "benchmark")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "benchmark"
    cfg = json.loads((d / "configs" / "basic3_n15.json").read_text())
    cfg.update(name="basic3_n10", nparticles=10)
    (d / "configs" / "basic3_n10.json").write_text(json.dumps(cfg))
    (d / "traffic" / "short.json").write_text(json.dumps(dict(
        warmup_steps=2, episode_steps=4, check_steps=2, profile_steps=1)))
    (d / "limits" / "basic3_n10.short.json").write_text(json.dumps(dict(
        pos_gap_m=1, vel_gap=1, force_gap=1, control="reference_bfloat16")))
    (d / "metrics" / "steps_done.py").write_text(
        "def read(run):\n    return len(run.steps)\n")
    bench["configs"].append(dict(name="basic3_n10", source="x",
                                 file="benchmark/configs/basic3_n10.json",
                                 reduced=["nparticles"], why="x"))
    bench["workloads"].append(dict(name="basic3_n10.short",
                                   config="basic3_n10", traffic="short",
                                   chips=1, why="x"))
    bench["per_layer"].append(dict(name="steps_done", unit="steps",
                                   better="higher", source="host_clock",
                                   layer="world", moves="particle_steps_per_s",
                                   workloads=["basic3_n10.short"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("basic3_n10.short", root=tmp_path)
    assert cell.config["nparticles"] == 10 and cell.traffic["episode_steps"] == 4
    assert "steps_done" in [m["name"] for m in cell.metrics(trace=True)]
    read = harness.metric_reader("steps_done")
    assert read(harness.Run(1, 0, 1, [None, None])) == 2
    old = harness.load_cell("basic3_n15.collapse", root=tmp_path)
    assert "steps_done" not in [m["name"] for m in old.metrics(trace=True)]
