#!/usr/bin/env python3
"""GPU smoke run of salva_tpu_torch, the PyTorch + CUDA port.

Drives the port's main path — the 3D DFSPH dense dam break of
``bench.py`` at 97,336 particles — on one NVIDIA GPU, in four phases:

1. setup: the card's name and power limit, and the build of the hand
   CUDA kernels from ``salva_tpu_torch/csrc`` (nvcc, at first use);
2. the main path: ``LiquidWorld(..., device="cuda")``, 10 warm-up and
   20 timed steps, with every kernel's launch count from that run;
3. each kernel against its plain PyTorch version on identical tensors
   taken from that world's state past impact (cells hold more than 8
   particles): per-output errors and tolerances, CUDA-event times, and
   planted faults that each output's tolerance must catch;
4. the same world stepped 5 times through the kernels and 5 times
   through the plain versions (substituted here, in the script), with
   identical iteration counts and matching positions required.

Usage, from the repository root:  python3 chip_smoke.py
Exits non-zero without a result line when no CUDA device is present or
any phase fails. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_TARGET = 100_000  # bench.py's BENCH_N: 46^3 = 97,336 particles
DT = 1.0 / 200.0
GRAVITY = (0.0, -9.81, 0.0)
# Kernel vs plain: float32 summation order only (the kernels walk the
# full stencil, the plain versions the half stencil). The numbers are the
# tolerances tests/test_pallas_ops.py holds the TPU kernels to on its
# small fixture; here each element must lie within
# ``atol * peak + rtol * |plain|``, where ``peak`` is max(1, max |plain|)
# of that one output tensor. At the dam break's state an output is a sum
# of ~200 pair terms of its peak's order that cancel almost exactly
# inside the block (a resting block has T ~ 0), so the float32 rounding
# of the terms, not the size of the result, sets the absolute error: a
# bare atol of 1e-5 failed t_pass on 1,826 of its 524,288 elements at
# the state after 12 steps on an H100, although its largest error was
# 5e-7 of its peak. The planted faults
# of phase 3 show that each output's rule still fails a wrong kernel.
KT_TOL = dict(rtol=1e-4, atol=1e-5)
HOIST_TOL = dict(rtol=1e-3, atol=1e-3)
# Output channels held to the tolerance, in the order the wrappers return
# them (hoist_ff's s2 and pair count are compared exactly).
OUTPUTS = {"k_pass": ("K",), "t_pass": ("T",), "hoist_ff": ("rho", "Gf", "sq")}
# A wrong kernel the tolerance must catch: output scaled by this factor.
FAULT_SCALE = 0.99
# Kernel run vs plain run of the whole step after 5 steps (positions,
# metres). Measured on an H100 (700 W): 6.9e-6 after 5 steps, growing
# to 1.9e-5 after 8, with identical iteration counts; the kernel run is
# bitwise reproducible. The lattice start is far more sensitive than
# that: a 1-ulp nudge of the initial positions moves the plain run by
# 3.3e-3 after one step (pairs sit exactly at r = h, and the divergence
# solve's neighbor-count gate flips on them). 5e-5 sits between the two.
PATH_POS_ATOL = 5e-5
REPLACES = {
    "k_pass": "salva_tpu/ops/pallas_pair.py:707",
    "t_pass": "salva_tpu/ops/pallas_pair.py:225",
    "hoist_ff": "salva_tpu/ops/pallas_pair.py:382",
}
SOURCE = "salva_tpu_torch/csrc/pair_passes.cu"


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def dam_break_world(device):
    """The bench.py dam break (``run_config``): a 46^3 cube one radius
    above a sampled Cuboid floor, moving down at 2 m/s, in a static
    domain; caps, window and fb table auto-resolve."""
    from salva_tpu_torch import shapes
    from salva_tpu_torch.config import DFSPHConfig
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.scenes import cube_fluid
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    n_side = max(2, round(N_TARGET ** (1.0 / 3.0)))
    radius = 0.05
    half = n_side * radius
    wall = max(1.5 * half, half + 0.5)
    domain = (
        (-wall - 0.3, -0.4, -wall - 0.3),
        (wall + 0.3, 2.0 * half + 1.0, wall + 0.3),
    )
    world = LiquidWorld(solver=DFSPHConfig(), particle_radius=radius,
                        smoothing_factor=2.0, dim=3, domain=domain,
                        dense_cap=None, dense_cap_boundary=None,
                        device=device)
    pos = cube_fluid((n_side, n_side, n_side), radius)
    pos[:, 1] += half + radius
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    world.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), radius, 3)
    floor[:, 1] -= 0.1
    world.add_boundary(Boundary(floor))
    return world


def step_ctx(world):
    """A DenseCtx of the world's current state, exactly as its next step
    builds it (the same resolved configuration)."""
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config

    sim = world._boundary_volume_mode(world._effective_sim(), None)
    spec_f, spec_b, _ = _dense_config(sim, world.solver_config, ForceSet())
    return DenseCtx(sim, spec_f, spec_b, world.fluids_state,
                    world.boundaries_state.clear_forces(), need_s2=False)


def cuda_ms(fn, reps):
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_output(label, got, want, tol):
    """Hold one output tensor to its plain version: every element within
    ``atol * peak + rtol * |want|``, ``peak`` = max(1, max |want|) of
    this tensor (``torch.testing.assert_close`` raises otherwise).
    Returns (max abs err, peak)."""
    peak = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * peak, msg=lambda m: (
                                   f"{label}: {m} (atol x peak {peak:.4e})"))
    return float((got - want).abs().max()), peak


def must_fail(label, got, want, tol):
    """A planted fault: ``got`` is a wrong result that ``check_output``
    has to reject. Returns its max abs err."""
    try:
        check_output(label, got, want, tol)
    except AssertionError:
        return float((got - want).abs().max())
    raise AssertionError(f"planted fault {label} passed the tolerance {tol}")


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def phase_main_path(pair):
    """Phase 2: the dam break through LiquidWorld on the card. Returns the
    world, past impact, for phase 3."""
    pair.reset_launches()
    world = dam_break_world("cuda")
    assert world.device.type == "cuda" and world.fluids_state.positions.is_cuda
    n = int(world.fluids_state.alive.sum())
    t0 = time.perf_counter()
    for _ in range(10):
        world.step(DT, GRAVITY)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    steps = 20
    iters = []
    refits0 = world.grid_refit_count
    t0 = time.perf_counter()
    for _ in range(steps):
        world.step(DT, GRAVITY)
        s = world.last_diagnostics.solver
        iters.append((s.pressure_iters, s.divergence_iters))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(pair.LAUNCHES)

    d = world.last_diagnostics
    overflow = int(d.neighbor_overflow)
    max_rho = float(d.max_density_ratio)
    pos = world.fluids_state.positions[world.fluids_state.alive]
    finite = bool(torch.isfinite(pos).all())
    ms = elapsed / steps * 1e3
    window = world._fitted_dims
    log(f"[main] N={n}: {ms:.3f} ms/step, {n * steps / elapsed:.6g} "
        f"particle-steps/s over {steps} timed steps "
        f"(10 warm-up steps took {warm_s:.2f} s)")
    log(f"[main] iterations per step (pressure, divergence): {iters}")
    log(f"[main] caps {world._auto_caps}, window dims {window} "
        f"({int(np.prod(window)) if window else 'full domain'} cells), "
        f"fb table {world._fb_cols_cache}, grid refits "
        f"{world.grid_refit_count} ({world.grid_refit_count - refits0} "
        f"in the timed window)")
    log(f"[main] last step: overflow {overflow}, clamped "
        f"{int(d.candidate_overflow)}, contacts ff {int(d.ncontacts_ff)} "
        f"fb {int(d.ncontacts_fb)}, max density ratio {max_rho:.4f}")
    log(f"[main] kernel launches in this run: {launches}")
    for name, count in launches.items():
        assert count > 0, f"{name} was never launched on the main path"
    assert overflow < max(1, n // 1000), f"overflow {overflow} at N={n}"
    assert finite, "non-finite fluid positions"
    assert 0.9 < max_rho < 2.0, f"max density ratio {max_rho}"
    return world, dict(n=n, ms=ms, launches=launches, iters=iters)


def phase_kernels(pair, world):
    """Phase 3: each kernel vs its plain version at the state of the main
    path's world after its 30 steps (the shapes the main path gives it)."""
    from salva_tpu_torch.geometry import dense_grid as tdg

    ctx = step_ctx(world)
    spec, h, dim, counts = ctx.spec_f, ctx.h, ctx.dim, ctx.counts
    occ = int(counts.max())
    log(f"[kernels] state after 30 steps: window dims {spec.dims} "
        f"({spec.num_cells} cells), cap {spec.cap}, max cell occupancy "
        f"{occ}, live slots {int(counts.sum())}")
    assert occ > 8, f"no cell above 8 particles (max {occ})"
    # Pair evaluations per pass: each live slot visits every particle of
    # its 3^dim neighbor cells (the ghost ring is empty, so a wrapping
    # roll adds nothing).
    c64 = counts.long()
    n_eval = sum(int((c64 * torch.roll(c64, -s)).sum())
                 for s in tdg.flat_shifts(spec))
    log(f"[kernels] pair evaluations per pass: {n_eval}")
    # Planted fault: the kernel is given one particle fewer in the fullest
    # cell (an off-by-one in the occupancy loop), and that slot itself is
    # then copied from the plain result, so only the neighbors' sums,
    # each short of one pair term, carry the fault.
    cell = int(torch.argmax(counts))
    rank = int(counts[cell]) - 1
    short = counts.clone()
    short[cell] -= 1
    P, M = ctx.P, ctx.M
    K = (ctx.rho * 1e-6 * ctx.maskf).contiguous()
    Q = ctx.V.contiguous()
    runs = {
        "k_pass": (
            lambda c: pair.k_pass(spec, h, dim, "cubic", P, M, K, c),
            lambda c: pair.k_pass_plain(spec, h, dim, "cubic", P, M, K, c),
            KT_TOL,
        ),
        "t_pass": (
            lambda c: pair.t_pass(spec, h, dim, "cubic", P, M, Q, c),
            lambda c: pair.t_pass_plain(spec, h, dim, "cubic", P, M, Q, c),
            KT_TOL,
        ),
        "hoist_ff": (
            lambda c: pair.hoist_ff(spec, h, dim, "cubic", "cubic", P, M, c,
                                    need_s2=False),
            lambda c: pair.hoist_ff_plain(spec, h, dim, "cubic", "cubic", P,
                                          M, c, need_s2=False),
            HOIST_TOL,
        ),
    }
    results = {}
    for name, (kern, plain, tol) in runs.items():
        out, ref = as_tuple(kern(counts)), as_tuple(plain(counts))
        again = as_tuple(kern(counts))
        for a, b in zip(out, again):
            assert torch.equal(a, b), f"{name}: not bitwise deterministic"
        bad = as_tuple(kern(short))
        names = OUTPUTS[name]
        if name == "hoist_ff":
            assert torch.equal(out[3], ref[3]), "hoist_ff: s2 differs"
            assert torch.equal(out[4], ref[4]), "hoist_ff: pair counts differ"
            cnt_bad = bad[4].clone()
            cnt_bad[rank, cell] = ref[4][rank, cell]
            assert not torch.equal(cnt_bad, ref[4]), \
                "hoist_ff: a dropped particle left the pair counts unchanged"
            log(f"[kernels] hoist_ff: pair counts exact "
                f"({int(out[4].sum())} pairs), s2 exact (zero, "
                f"need_s2=False); dropped particle changes "
                f"{int((cnt_bad != ref[4]).sum())} pair counts")
        abs_errs = []
        for i, o in enumerate(names):
            err, peak = check_output(f"{name}.{o}", out[i], ref[i], tol)
            wrong = bad[i].clone()
            wrong[..., rank, cell] = ref[i][..., rank, cell]
            err_drop = must_fail(f"{name}.{o} (dropped particle)", wrong,
                                 ref[i], tol)
            err_scale = must_fail(f"{name}.{o} (x {FAULT_SCALE})",
                                  out[i] * FAULT_SCALE, ref[i], tol)
            abs_errs.append(err)
            log(f"[kernels] {name}.{o}: max abs err {err:.4e} = "
                f"{err / peak:.4e} x peak {peak:.4e} (tol {tol}, atol x "
                f"peak = {tol['atol'] * peak:.4e}); planted faults caught: "
                f"dropped particle (max abs err {err_drop:.4e}), "
                f"x {FAULT_SCALE} (max abs err {err_scale:.4e})")
        ms = cuda_ms(lambda: kern(counts), 50)
        plain_ms = cuda_ms(lambda: plain(counts), 10)
        results[name] = dict(max_abs_err=max(abs_errs), ms=ms,
                             plain_ms=plain_ms)
        log(f"[kernels] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms (median CUDA-event time); {n_eval / ms / 1e6:.4g} G pair "
            f"evaluations/s in the kernel")
    return results


def phase_path_parity(pair):
    """Phase 4: 5 steps through the kernels vs 5 through the plain
    versions (substituted for the wrappers here, in the script)."""

    def run():
        world = dam_break_world("cuda")
        iters = []
        for _ in range(5):
            world.step(DT, GRAVITY)
            s = world.last_diagnostics.solver
            iters.append((s.pressure_iters, s.divergence_iters))
        alive = world.fluids_state.alive
        return iters, world.fluids_state.positions[alive].clone()

    it_k, pos_k = run()
    wrappers = (pair.k_pass, pair.t_pass, pair.hoist_ff)
    pair.k_pass, pair.t_pass, pair.hoist_ff = (
        pair.k_pass_plain, pair.t_pass_plain, pair.hoist_ff_plain
    )
    try:
        it_p, pos_p = run()
    finally:
        pair.k_pass, pair.t_pass, pair.hoist_ff = wrappers
    dpos = float((pos_k - pos_p).abs().max())
    log(f"[parity] iterations kernels {it_k} vs plain {it_p}; max "
        f"|dpos| {dpos:.3e} m (atol {PATH_POS_ATOL})")
    assert it_k == it_p, "iteration counts differ between kernels and plain"
    assert dpos <= PATH_POS_ATOL, f"positions differ by {dpos}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from salva_tpu_torch.ops import _build, pair

    card = card_line()
    log(f"[setup] {card}")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.load()
    log(f"[setup] kernels built and loaded in {time.perf_counter() - t0:.2f}"
        f" s: {lib}")

    t0 = time.perf_counter()
    world, main_run = phase_main_path(pair)
    log(f"[main] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_kernels(pair, world)
    del world
    torch.cuda.empty_cache()
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_path_parity(pair)
    log(f"[parity] phase took {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=main_run["launches"][name],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"])
        for name, k in kernels.items()
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
