#!/usr/bin/env python3
"""GPU smoke run of salva_tpu_torch, the PyTorch + CUDA port.

Drives the port's main paths — the 3D dense dam break of ``bench.py``
at 97,336 particles, solved with DFSPH and with IISPH, without and with
the fluid's XSPH and artificial-viscosity forces — on one NVIDIA GPU,
in these phases:

1. setup: the card's name and power limit, and the build of the hand
   CUDA kernels from ``salva_tpu_torch/csrc`` (one nvcc per source, all
   at once, at first use);
2. the DFSPH main path: ``LiquidWorld(..., device="cuda")``, 10 warm-up
   and 20 timed steps, with every kernel's launch count from that run;
3. the IISPH main path: the same scene with ``solver=IISPHConfig()``,
   10 warm-up and 20 timed steps, its launch counts and per-step
   pressure iterations;
4. the forces main paths: the same dam break whose fluid carries
   ``ArtificialViscosity(1.0, 0.0)`` and ``XSPHViscosity(0.5, 1.0)``,
   under DFSPH and under IISPH, 10 warm-up and 20 timed steps each;
5. each kernel against its plain PyTorch version on identical tensors
   taken from the DFSPH world's state past impact (cells hold more than
   8 particles), both hoists with their IISPH ``s2`` channel and
   without it (the DFSPH setting: ``s2`` exactly zero), the
   fluid-boundary hoist on both boundary layouts (the sparse one the
   world resolves, and the same state binned into the full grid), the
   slot-group ``k_pass_v2`` (which no main path runs, as in the JAX
   package) against ``k_pass``'s plain version, and the binning's
   ``expand`` on the fluid and the boundary binning (exact):
   per-output errors and tolerances, a bitwise rerun, CUDA-event times,
   the least time the card could take (bound: the bytes of the live
   slots the pass must read and of its outputs, or its float32
   operations), the library call's time where one computes the same
   function, the device launches one call of each hoist makes (the
   profiler's count), and planted faults that each output's rule must
   catch (for the tiled ``k_pass``, ``t_pass`` and ``hoist_ff``, whose
   tiling is logged, in the fullest cell on a tile's edge);
6. each main path (DFSPH and IISPH, without and with the forces)
   stepped 5 times through the kernels and 5 times through the plain
   versions (substituted here, in the script), with identical iteration
   counts and matching positions required; the DFSPH path again with the
   JAX package's packed gather ``packed[grid_src]`` in place of
   ``expand`` (bitwise equal);
7. the DFSPH dam break on the full-grid boundary binning
   (``dense_sparse_boundary=False``) for 5 steps, through the kernels,
   against the phase-6 kernel run on the sparse binning.

Usage, from the repository root:  python3 chip_smoke.py
Exits non-zero without a result line when no CUDA device is present or
any phase fails. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the line
before that the kernels' JSON record (``launches``: the count of the
run named by ``launches_path`` — the DFSPH forces path, this slice's,
and for ``k_pass_v2``, which no main path launches, its phase-5 checks
and timing; ``launches_by_path``: every main path's).
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
# full stencil, the plain versions the half stencil or gathered blocks).
# The numbers are the tolerances tests/test_pallas_ops.py holds the TPU
# kernels to on its small fixture; here each element must lie within
# ``atol * peak + rtol * |plain|``, where ``peak`` is max(1, max |plain|)
# of that one output tensor. At the dam break's state an output is a sum
# of ~200 pair terms of its peak's order that cancel almost exactly
# inside the block (a resting block has T ~ 0), so the float32 rounding
# of the terms, not the size of the result, sets the absolute error: a
# bare atol of 1e-5 failed t_pass on 1,826 of its 524,288 elements at
# the state after 12 steps on an H100, although its largest error was
# 5e-7 of its peak. The planted faults of phase 4 show that each
# output's rule still fails a wrong kernel.
KT_TOL = dict(rtol=1e-4, atol=1e-5)
HOIST_TOL = dict(rtol=1e-3, atol=1e-3)
# Float output channels held to the tolerance, in the order the wrappers
# return them; the hoists' last output, the pair count, is compared
# exactly.
OUTPUTS = {
    "k_pass": ("K",),
    "t_pass": ("T",),
    "hoist_ff": ("rho", "Gf", "sq", "s2"),
    "hoist_fb": ("rho", "Gb", "sq", "s2", "Sb"),
    "k_pass_v2": ("K",),
}
# A wrong kernel the tolerance must catch: output scaled by this factor.
FAULT_SCALE = 0.99
# Kernel run vs plain run of the whole step after 5 steps (positions,
# metres), per solver. Both kernel runs are bitwise reproducible. The
# lattice start is far more sensitive than either bound: a 1-ulp nudge
# of the initial positions moves the plain DFSPH run by 3.3e-3 after one
# step (pairs sit exactly at r = h, and the divergence solve's
# neighbor-count gate flips on them).
# - DFSPH: measured 6.9e-6 on an H100 (700 W) after 5 steps, growing to
#   1.9e-5 after 8, with identical iteration counts; 5e-5 sits between
#   that reading and the lattice sensitivity.
# - IISPH: measured 2.4e-7 on an H100 (700 W) after 5 steps, with
#   identical iteration counts. Its Jacobi update divides by a_ii (a
#   difference of near-equal terms), which amplifies summation-order
#   differences into the velocities (3.1e-6 m/s between the JAX package
#   and the port on the CPU), but 5 steps of dt = 5 ms keep positions
#   near 1e-7. 2e-6, the bound tests/test_torch_iisph_dam_break.py holds
#   the port's positions to against the JAX package, sits 8x above the
#   reading and three orders of magnitude below the lattice sensitivity.
# The forces paths are held to the same bounds.
PATH_POS_ATOL = {"dfsph": 5e-5, "iisph": 2e-6}
# The fluid's non-pressure forces on the forces main paths: the basic3
# scene's artificial viscosity and the elasticity scenes' XSPH (whose
# nonzero boundary coefficient drives the fluid-boundary passes), as
# (class name in salva_tpu_torch/forces.py, arguments).
FORCES = (("ArtificialViscosity", (1.0, 0.0)), ("XSPHViscosity", (0.5, 1.0)))
REPLACES = {
    "k_pass": "salva_tpu/ops/pallas_pair.py:707",
    "t_pass": "salva_tpu/ops/pallas_pair.py:225",
    "hoist_ff": "salva_tpu/ops/pallas_pair.py:382",
    "hoist_fb": "salva_tpu/ops/pallas_pair.py:562",
    "k_pass_v2": "salva_tpu/ops/pallas_pair2.py:191",
    "expand": "tools/exp_pallas_expand.py:37",
}
SOURCES = {name: "salva_tpu_torch/csrc/pair_passes.cu" for name in REPLACES}
SOURCES["expand"] = "salva_tpu_torch/csrc/expand.cu"
# The kernels every main path launches; k_pass_v2 runs on none (as in
# the JAX package, no solver calls it): phase 5 holds and times it.
MAIN_PATH_KERNELS = ("k_pass", "t_pass", "hoist_ff", "hoist_fb", "expand")
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM3
# bandwidth and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float32 operations per pair, counted from the kernel source (a sqrt or
# rsqrt counts as one): the distance test every candidate pair needs
# (dim subtractions, dim products, dim - 1 sums), and the rest of the
# pair's arithmetic, needed only for pairs within h (cubic dW/dr / r: 14,
# cubic W: 10, then each kernel's accumulations).
OPS_CANDIDATE = {2: 5, 3: 8}
OPS_WITHIN = {"k_pass": 22, "t_pass": 22, "hoist_ff": 48, "hoist_fb": 57,
              "k_pass_v2": 22}


def log(msg):
    print(msg, flush=True)


def reset_counts(pair):
    """Set every kernel's launch count to 0 (pair passes and binning)."""
    from salva_tpu_torch.ops import binning

    pair.reset_launches()
    binning.reset_launches()


def read_counts(pair):
    """Every kernel's launch count since the last ``reset_counts``."""
    from salva_tpu_torch.ops import binning

    return dict(pair.LAUNCHES, **binning.LAUNCHES)


def path_name(solver, forces=False, sparse_boundary=True):
    return (solver + ("_forces" if forces else "")
            + ("" if sparse_boundary else "_full_grid"))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def dam_break_world(device, solver="dfsph", sparse_boundary=True,
                    forces=False):
    """The bench.py dam break (``run_config``): a 46^3 cube one radius
    above a sampled Cuboid floor, moving down at 2 m/s, in a static
    domain; caps, window and fb table auto-resolve. ``forces``: the
    fluid carries FORCES."""
    from salva_tpu_torch import forces as force_specs
    from salva_tpu_torch import shapes
    from salva_tpu_torch.config import DFSPHConfig, IISPHConfig
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
    cfg = {"dfsph": DFSPHConfig, "iisph": IISPHConfig}[solver]()
    world = LiquidWorld(solver=cfg, particle_radius=radius,
                        smoothing_factor=2.0, dim=3, domain=domain,
                        dense_cap=None, dense_cap_boundary=None,
                        device=device)
    if not sparse_boundary:
        world.sim = world.sim.replace(dense_sparse_boundary=False)
    pos = cube_fluid((n_side, n_side, n_side), radius)
    pos[:, 1] += half + radius
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    nonpressure = ([getattr(force_specs, name)(*args)
                    for name, args in FORCES] if forces else [])
    world.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                          nonpressure_forces=nonpressure))
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), radius, 3)
    floor[:, 1] -= 0.1
    world.add_boundary(Boundary(floor))
    return world


def step_ctx(world, **sim_overrides):
    """A DenseCtx of the world's current state, exactly as its next step
    builds it (the same resolved configuration, with ``sim_overrides``),
    with the IISPH-only ``s2`` sums."""
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config

    sim = world._boundary_volume_mode(world._effective_sim(), None)
    sim = sim.replace(**sim_overrides)
    spec_f, spec_b, _ = _dense_config(sim, world.solver_config, ForceSet())
    return DenseCtx(sim, spec_f, spec_b, world.fluids_state,
                    world.boundaries_state.clear_forces(), need_s2=True)


def cuda_ms(fn, reps):
    """Mean time of ``fn()`` over ``reps`` runs issued back to back (CUDA
    events around the batch, elapsed time over the count), after two
    warm-up runs. The batch is queued behind a spin kernel
    (``torch.cuda._sleep``) sized to its host-side cost, so that a pass of
    one launch (a hand kernel) is timed on the device alone, without the
    host's launch cost between runs. A pass of many small launches (a
    plain version) fills CUDA's launch queue before the spin ends; its
    time is then that of whichever of the host and the device is
    slower."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Cycles at ~2 GHz for 1.5x the host-and-device time of the runs,
    # at most ~2 s.
    cycles = min(int((time.perf_counter() - t0) * reps * 3.0e9) + 10**6,
                 4 * 10**9)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def call_ms(fn, reps):
    """Median time of one ``fn()`` call as a caller sees it: CUDA events
    around a single call, so the host's launch cost is included when it
    exceeds the device's work (the device idles between the events until
    the launch arrives)."""
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


def device_launches(fn, tries=3):
    """Device activities (kernels and memory fills) of one ``fn()``, as
    ``torch.profiler`` records them: what one call of a wrapper launches.
    The most over ``tries`` profiled calls: a profile of one short call
    on an H100 now and then came back without its device events (an
    undercount, never an overcount)."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    counts = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=act) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def live_bytes(planes, live):
    """Bytes of ``live`` slots in every channel of the float32
    [.., cap, C] planes: what a pass must read of them when it reads
    only live slots."""
    return sum(4 * live * (t.numel() // (t.shape[-2] * t.shape[-1]))
               for t in planes)


def shift_flat(x, s):
    """``x[..., c + s]`` along the flat cell axis, zero where c + s lies
    outside the grid: the neighbor cell the kernels read at stencil
    shift ``s`` (``flat_shift`` in the CUDA source; a cell outside the
    grid counts as empty)."""
    out = torch.zeros_like(x)
    C = x.shape[-1]
    if s >= 0:
        out[..., :C - s] = x[..., s:]
    else:
        out[..., -s:] = x[..., :C + s]
    return out


def bound(name, dim, read_bytes, written_bytes, candidates, within):
    """(bound_ms, bound_by, ops): the larger of the bytes the call must
    move over the HBM rate and the float32 operations this state's pairs
    need over the float32 rate. ``read_bytes`` counts each input element
    the function needs read once (live slots only, from this run's
    counts); ``written_bytes`` the output tensors it returns, each
    element written once."""
    ops = OPS_CANDIDATE[dim] * candidates + OPS_WITHIN[name] * within
    t_bytes = (read_bytes + written_bytes) / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def boundary_slots_within(cf, counts, visit, h, shifts):
    """The boundary slots of the full-grid binning ``cf`` that lie within
    h of a live fluid slot of a visited column: the only boundary slots
    whose volume and velocity the fb hoist must read (a pair at exactly
    r = h may round either way here and in the kernel; a slot is 16 B)."""
    Pb, cb = cf.Pb, cf.counts_b
    hit = torch.zeros(Pb.shape[1:], dtype=torch.bool, device="cuda")
    live_f = counts * visit
    for s in shifts:
        # Boundary cell n pairs with fluid cell n - s.
        cnt = shift_flat(live_f, -s)
        Ps = shift_flat(cf.P, -s)
        for j in range(int(cnt.max())):
            d2 = ((Pb - Ps[:, j, None, :]) ** 2).sum(0)
            hit |= (d2 <= h * h) & (j < cnt)[None, :]
    rank = torch.arange(Pb.shape[1], device="cuda")[:, None]
    return int((hit & (rank < cb[None, :])).sum())


def phase_main_path(pair, solver, forces=False):
    """Phases 2-4: the dam break through LiquidWorld on the card, with
    the launch counts of this run alone. Returns the world, past impact."""
    tag = f"[main {path_name(solver, forces)}]"
    world = dam_break_world("cuda", solver, forces=forces)
    assert world.device.type == "cuda"
    assert world.fluids_state.positions.device.type == "cuda"
    n = int(world.fluids_state.alive.sum())
    reset_counts(pair)
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
    launches = read_counts(pair)

    d = world.last_diagnostics
    overflow = int(d.neighbor_overflow)
    max_rho = float(d.max_density_ratio)
    pos = world.fluids_state.positions[world.fluids_state.alive]
    finite = bool(torch.isfinite(pos).all())
    ms = elapsed / steps * 1e3
    window = world._fitted_dims
    log(f"{tag} N={n}: {ms:.3f} ms/step, {n * steps / elapsed:.6g} "
        f"particle-steps/s over {steps} timed steps "
        f"(10 warm-up steps took {warm_s:.2f} s)")
    log(f"{tag} iterations per step (pressure, divergence): {iters}")
    log(f"{tag} caps {world._auto_caps}, window dims {window} "
        f"({int(np.prod(window)) if window else 'full domain'} cells), "
        f"fb table {world._fb_cols_cache}, grid refits "
        f"{world.grid_refit_count} ({world.grid_refit_count - refits0} "
        f"in the timed window)")
    log(f"{tag} last step: overflow {overflow}, clamped "
        f"{int(d.candidate_overflow)}, contacts ff {int(d.ncontacts_ff)} "
        f"fb {int(d.ncontacts_fb)}, max density ratio {max_rho:.4f}")
    log(f"{tag} kernel launches in this run (30 steps): {launches}")
    if forces:
        log(f"{tag} non-pressure forces: {world._force_set}")
        assert len(world._force_set.forces) == len(FORCES)
    for name in MAIN_PATH_KERNELS:
        assert launches[name] > 0, f"{name} was never launched on {tag}"
    assert overflow < max(1, n // 1000), f"overflow {overflow} at N={n}"
    assert finite, "non-finite fluid positions"
    assert 0.9 < max_rho < 2.0, f"max density ratio {max_rho}"
    return world, dict(n=n, ms=ms, launches=launches, iters=iters)


def drop_last(counts, cells):
    """A planted fluid-side fault: ``counts`` with one particle fewer in
    the fullest of ``cells`` (a 1-D index tensor). Returns (the short
    counts, ``copy_back(wrong, ref)`` restoring the dropped slot, which
    the fault legitimately changes, the cell)."""
    cell = int(cells[torch.argmax(counts[cells])])
    rank = int(counts[cell]) - 1
    short = counts.clone()
    short[cell] -= 1

    def copy_back(wrong, ref):
        wrong[..., rank, cell] = ref[..., rank, cell]

    return short, copy_back, cell


def hold_kernel(name, label, kern, plain, tol, copy_back=None):
    """Hold ``kern(False)`` to ``plain()`` output by output, check a
    bitwise rerun, and check that the planted fault ``kern(True)`` (one
    particle fewer in one cell's loop) and the output x FAULT_SCALE fail
    every float output. ``copy_back(wrong, ref)`` restores the slots the
    fault legitimately changes. Returns (outputs, max abs err)."""
    out, ref = as_tuple(kern(False)), as_tuple(plain())
    again = as_tuple(kern(False))
    for a, b in zip(out, again):
        assert torch.equal(a, b), f"{label}: not bitwise deterministic"
    bad = as_tuple(kern(True))
    names = OUTPUTS[name]
    if len(out) > len(names):  # the hoists' pair counts, exact
        assert torch.equal(out[-1], ref[-1]), f"{label}: pair counts differ"
        cnt_bad = bad[-1].clone()
        if copy_back:
            copy_back(cnt_bad, ref[-1])
        assert not torch.equal(cnt_bad, ref[-1]), \
            f"{label}: a dropped particle left the pair counts unchanged"
        log(f"[kernels] {label}: pair counts exact ({int(out[-1].sum())} "
            f"pairs); dropped particle changes "
            f"{int((cnt_bad != ref[-1]).sum())} pair counts")
    abs_errs = []
    for i, o in enumerate(names):
        err, peak = check_output(f"{label}.{o}", out[i], ref[i], tol)
        wrong = bad[i].clone()
        if copy_back:
            copy_back(wrong, ref[i])
        err_drop = must_fail(f"{label}.{o} (dropped particle)", wrong,
                             ref[i], tol)
        err_scale = must_fail(f"{label}.{o} (x {FAULT_SCALE})",
                              out[i] * FAULT_SCALE, ref[i], tol)
        abs_errs.append(err)
        log(f"[kernels] {label}.{o}: max abs err {err:.4e} = "
            f"{err / peak:.4e} x peak {peak:.4e} (tol {tol}, atol x "
            f"peak = {tol['atol'] * peak:.4e}); planted faults caught: "
            f"dropped particle (max abs err {err_drop:.4e}), "
            f"x {FAULT_SCALE} (max abs err {err_scale:.4e})")
    return out, max(abs_errs)


def hold_without_s2(label, names, out, ref, tol):
    """The DFSPH setting (``need_s2=False``): every float output but s2
    held to the plain version, s2 exactly zero in both, pair counts
    exact. Returns the max abs err."""
    i = names.index("s2")
    assert int(torch.count_nonzero(out[i])) == 0, f"{label}: s2 not zero"
    assert int(torch.count_nonzero(ref[i])) == 0, f"{label}: plain s2"
    assert torch.equal(out[-1], ref[-1]), f"{label}: pair counts differ"
    errs = {o: check_output(f"{label}.{o}", out[k], ref[k], tol)[0]
            for k, o in enumerate(names) if o != "s2"}
    log(f"[kernels] {label}: s2 exactly zero, pair counts exact; max abs "
        f"err " + ", ".join(f"{o} {e:.4e}" for o, e in errs.items())
        + f" (tol {tol})")
    return max(errs.values())


def phase_kernels(pair, world):
    """Phase 5: each kernel vs its plain version at the state of the
    DFSPH main path's world after its 30 steps (the shapes the main path
    gives it)."""
    from salva_tpu_torch.geometry import dense_grid as tdg

    ctx = step_ctx(world)
    spec, h, dim, counts = ctx.spec_f, ctx.h, ctx.dim, ctx.counts
    C = spec.num_cells
    occ = int(counts.max())
    n_live = int(counts.sum())
    log(f"[kernels] state after 30 steps: window dims {spec.dims} "
        f"({C} cells), cap {spec.cap}, max cell occupancy {occ}, live "
        f"slots {n_live} of {spec.cap * C}")
    assert occ > 8, f"no cell above 8 particles (max {occ})"
    # Candidate pairs per fluid-fluid pass: each live slot visits every
    # particle of its 3^dim neighbor cells.
    c64 = counts.long()
    shifts = tdg.flat_shifts(spec)
    n_eval = sum(int((c64 * shift_flat(c64, s)).sum()) for s in shifts)
    log(f"[kernels] fluid-fluid candidate pairs per pass: {n_eval}")
    # The tiled k_pass / t_pass / hoist_ff kernels: blocks of `tile`
    # consecutive cells (hoist_ff without s2, as DFSPH runs it, and with).
    edge = {}
    cidx = torch.arange(C, device="cuda")
    for name, s2 in (("k_pass", False), ("t_pass", False),
                     ("hoist_ff", False), ("hoist_ff", True)):
        t = pair.tiling(name, dim, spec.cap, C, need_s2=s2)
        edge[name] = torch.nonzero((cidx % t["tile"] == 0)
                                   | (cidx % t["tile"] == t["tile"] - 1))[:, 0]
        log(f"[kernels] {name}{' (need_s2=True)' if s2 else ''}: tiles of "
            f"{t['tile']} cells, {t['smem']} B of shared memory a block, "
            f"{t['blocks']} blocks a launch, {t['per_sm']} blocks resident "
            f"per SM")
    # Planted fluid-side faults: the kernel is given one particle fewer in
    # one cell (an off-by-one in the occupancy loop), and that slot itself
    # is then copied from the plain result, so only the neighbors' sums,
    # each short of one pair term, carry the fault. Each tiled kernel's
    # cell is the fullest on one of its tiles' first or last cell, so that
    # the missing term crosses a tile boundary.
    short_ff, copy_ff, cell = drop_last(counts, edge["hoist_ff"])
    short_k, copy_k, cell_k = drop_last(counts, edge["k_pass"])
    short_t, copy_t, cell_t = drop_last(counts, edge["t_pass"])
    log(f"[kernels] planted faults drop the last particle of cell {cell} "
        f"(hoist_ff), {cell_k} (k_pass) and {cell_t} (t_pass), of "
        f"{int(counts[cell])}, {int(counts[cell_k])} and "
        f"{int(counts[cell_t])} particles")

    P, M = ctx.P, ctx.M
    K = (ctx.rho * 1e-6 * ctx.maskf).contiguous()
    Q = ctx.V.contiguous()
    # Each entry: kernel (planted fault or not), plain version, tolerance,
    # the float input planes each live slot of which the pass must read,
    # the planted fault's slot to restore.
    ff = {
        "k_pass": (
            lambda f: pair.k_pass(spec, h, dim, "cubic", P, M, K,
                                  short_k if f else counts),
            lambda: pair.k_pass_plain(spec, h, dim, "cubic", P, M, K,
                                      counts),
            KT_TOL, [P, M, K], copy_k,
        ),
        "t_pass": (
            lambda f: pair.t_pass(spec, h, dim, "cubic", P, M, Q,
                                  short_t if f else counts),
            lambda: pair.t_pass_plain(spec, h, dim, "cubic", P, M, Q,
                                      counts),
            KT_TOL, [P, M, Q], copy_t,
        ),
        "hoist_ff": (
            lambda f: pair.hoist_ff(spec, h, dim, "cubic", "cubic", P, M,
                                    short_ff if f else counts, need_s2=True),
            lambda: pair.hoist_ff_plain(spec, h, dim, "cubic", "cubic", P,
                                        M, counts, need_s2=True),
            HOIST_TOL, [P, M], copy_ff,
        ),
    }
    results = {}
    ff_within = None
    for name, (kern, plain, tol, planes, copy) in ff.items():
        out, err = hold_kernel(name, name, kern, plain, tol, copy)
        if name == "hoist_ff":
            ff_within = int(out[-1].sum())
            # The DFSPH main path runs this hoist without s2.
            err = max(err, hold_without_s2(
                "hoist_ff (need_s2=False)", OUTPUTS[name],
                pair.hoist_ff(spec, h, dim, "cubic", "cubic", P, M, counts,
                              need_s2=False),
                pair.hoist_ff_plain(spec, h, dim, "cubic", "cubic", P, M,
                                    counts, need_s2=False), tol))
        ms = cuda_ms(lambda: kern(False), 50)
        one = call_ms(lambda: kern(False), 20)
        plain_ms = cuda_ms(plain, 10)
        if name == "hoist_ff":
            ms0 = cuda_ms(lambda: pair.hoist_ff(
                spec, h, dim, "cubic", "cubic", P, M, counts,
                need_s2=False), 50)
            n_dev = device_launches(lambda: kern(False))
            log(f"[kernels] hoist_ff: {ms0:.4f} ms device time without s2 "
                f"(the DFSPH setting); {n_dev} device launch(es) a call")
            assert n_dev == 1, f"hoist_ff: {n_dev} launches a call"
        # Reads: the live slots of each input plane and every column's
        # count; writes: every output element once.
        results[name] = dict(max_abs_err=err, ms=ms, call_ms=one,
                             plain_ms=plain_ms,
                             read=live_bytes(planes, n_live) + 4 * C,
                             written=nbytes(out))
        log(f"[kernels] {name}: kernel {ms:.4f} ms device time ({one:.4f} "
            f"ms a call with its launch), plain {plain_ms:.4f} ms; "
            f"{n_eval / ms / 1e6:.4g} G candidate pairs/s in the kernel")
    # k_pass_v2 computes k_pass's function by live 8-slot groups, so its
    # planted fluid-side fault drops the one particle of a group: the
    # fullest cell of 8 g + 1 particles is given 8 g (its last group dies).
    # Its plain version is k_pass's; it shares k_pass's bound.
    ones = torch.nonzero(counts % 8 == 1)[:, 0]
    assert ones.numel() > 0, "no cell of 8 g + 1 particles"
    short_v2, copy_v2, cell_v2 = drop_last(counts, ones)

    def kern_v2(f):
        return pair.k_pass_v2(spec, h, dim, "cubic", P, M, K,
                              short_v2 if f else counts)

    log(f"[kernels] k_pass_v2: planted fault drops the last particle of "
        f"cell {cell_v2} ({int(counts[cell_v2])} particles)")
    # No main path launches k_pass_v2: its launches are this check's.
    reset_counts(pair)
    out, err = hold_kernel("k_pass_v2", "k_pass_v2", kern_v2, ff["k_pass"][1],
                           KT_TOL, copy_v2)
    ms = cuda_ms(lambda: kern_v2(False), 50)
    one = call_ms(lambda: kern_v2(False), 20)
    check_launches = read_counts(pair)["k_pass_v2"]
    plain_ms = cuda_ms(ff["k_pass"][1], 10)
    results["k_pass_v2"] = dict(max_abs_err=err, ms=ms, call_ms=one,
                                plain_ms=plain_ms,
                                check_launches=check_launches,
                                read=live_bytes([P, M, K], n_live) + 4 * C,
                                written=nbytes(out))
    log(f"[kernels] k_pass_v2: kernel {ms:.4f} ms device time ({one:.4f} ms "
        f"a call; k_pass {results['k_pass']['ms']:.4f} ms), plain "
        f"{plain_ms:.4f} ms; {n_eval / ms / 1e6:.4g} G candidate pairs/s; "
        f"{check_launches} launches in this check and its timing")
    for name in results:
        r = results[name]
        read, written = r.pop("read"), r.pop("written")
        r["bound_ms"], r["bound_by"], ops = bound(name, dim, read, written,
                                                  n_eval, ff_within)
        log(f"[kernels] {name}: bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}; {read} B read, {written} B written; "
            f"{ops:.4g} float32 operations over {n_eval} candidate / "
            f"{ff_within} within-h pairs); kernel / bound "
            f"{r['ms'] / r['bound_ms']:.1f}")

    # hoist_fb on both boundary layouts. The dam-break floor is static
    # (boundary velocities 0, so Sb = 0); seeded random boundary
    # velocities on the live boundary slots exercise the Sb channel.
    ctx_full = step_ctx(world, dense_sparse_boundary=False)
    # Boundary particles per fluid-grid cell (the full-grid binning), and
    # per fluid column the boundary particles of its 3^dim neighbor cells.
    cb_cell = ctx_full.counts_b.long()
    around_f = sum(shift_flat(cb_cell, s) for s in shifts)
    gen = torch.Generator(device="cuda").manual_seed(5)
    fb = {}
    for layout, c in (("sparse", ctx), ("full", ctx_full)):
        assert torch.equal(c.counts, counts) and torch.equal(c.P, P)
        Vb = (torch.randn(c.Vbvel.shape, generator=gen, device="cuda")
              * c.maskb[None]).contiguous()
        cell_to_col = c.binb.cell_to_active if c.sparse_b else None
        cols = c._fb_table() if c._fb_cols() else None
        if c.sparse_b:
            cb_map = c.counts_b.long()[cell_to_col.long()][:C]
            assert torch.equal(cb_map, cb_cell), "the layouts disagree"
        # Planted boundary-side fault: one boundary particle fewer in the
        # boundary column with the most fluid particles around it.
        cb_cells = (c._b_active if c.sparse_b
                    else torch.arange(C, device="cuda"))
        valid = cb_cells < C
        around = torch.zeros(cb_cells.shape, dtype=torch.int64,
                             device="cuda")
        for s in shifts:
            nb = torch.clamp(cb_cells + s, 0, C - 1)
            around += torch.where(valid, c64[nb], 0)
        around = torch.where(c.counts_b > 0, around, -1)
        col = int(torch.argmax(around))
        short_b = c.counts_b.clone()
        short_b[col] -= 1
        args = (spec, h, dim, "cubic", "cubic", P, counts, c.Pb, c.Volb, Vb)
        kw = dict(cell_to_col=cell_to_col, cols=cols, need_s2=True)

        def kern(f, args=args, kw=kw, cb=c.counts_b, short_b=short_b):
            return pair.hoist_fb(*args, short_b if f else cb, **kw)

        def plain(args=args, kw=kw, cb=c.counts_b):
            return pair.hoist_fb_plain(*args, cb, **kw)

        visit = torch.zeros(C, dtype=torch.int64, device="cuda")
        if cols is None:
            visit += 1
        else:
            visit[cols[cols < C].long()] = 1
        n_cols = int(visit.sum())
        log(f"[kernels] hoist_fb ({layout}): boundary grid "
            f"{tuple(c.Pb.shape)}, {n_cols} fluid columns visited, planted "
            f"fault in boundary column {col} ({int(around[col])} fluid "
            f"particles around it, {int(c.counts_b[col])} boundary)")
        out, err = hold_kernel("hoist_fb", f"hoist_fb ({layout})", kern,
                               plain, HOIST_TOL)
        # The DFSPH main path runs this hoist without s2.
        kw0 = dict(kw, need_s2=False)
        err = max(err, hold_without_s2(
            f"hoist_fb ({layout}, need_s2=False)", OUTPUTS["hoist_fb"],
            pair.hoist_fb(*args, c.counts_b, **kw0),
            pair.hoist_fb_plain(*args, c.counts_b, **kw0), HOIST_TOL))
        # Candidate pairs: each live slot of a visited column times the
        # boundary particles of its 3^dim neighbor cells.
        cand = int((c64 * around_f * visit).sum())
        within = int(out[-1].sum())
        # What the hoist must read: the positions of the fluid slots with
        # at least one candidate; the entries of the column list and the
        # counts of the visited columns; the map entry and boundary count
        # of each neighbor cell of a visited live column; the positions of
        # the boundary slots in those cells; the volume and velocity of
        # the boundary slots within h of a visited live fluid slot.
        n_pf = int((c64 * visit * (around_f > 0)).sum())
        vl = visit * (c64 > 0)
        need = sum(shift_flat(vl, -s) for s in shifts) > 0
        n_need = int(need.sum())
        n_pb = int((cb_cell * need).sum())
        n_wb = boundary_slots_within(ctx_full, counts, visit, h, shifts)
        idx = 4 * ((0 if cols is None else cols.numel()) + n_cols + n_need)
        if cell_to_col is None:
            idx += 4 * n_need  # boundary counts, indexed by cell
        else:
            idx += 4 * int(torch.unique(cell_to_col[:C][need]).numel())
        read = 4 * (dim * n_pf + dim * n_pb + (1 + dim) * n_wb) + idx
        written = nbytes(out)
        ms = cuda_ms(lambda: kern(False), 50)
        one = call_ms(lambda: kern(False), 20)
        plain_ms = cuda_ms(plain, 10)
        # A call is the zero fill of the packed outputs and the kernel: the
        # time above holds both; the fill alone, and the launches a call.
        fill_ms = cuda_ms(lambda: torch.zeros(
            (dim + 5,) + tuple(P.shape[1:]), device="cuda"), 50)
        n_dev = device_launches(lambda: kern(False))
        log(f"[kernels] hoist_fb ({layout}): {n_dev} device launches a "
            f"call; the zero fill alone {fill_ms:.4f} ms device time")
        assert 1 <= n_dev <= 2, f"hoist_fb: {n_dev} launches a call"
        b_ms, b_by, ops = bound("hoist_fb", dim, read, written, cand, within)
        fb[layout] = dict(max_abs_err=err, ms=ms, call_ms=one,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          fill_ms=fill_ms, launches_per_call=n_dev)
        log(f"[kernels] hoist_fb ({layout}): kernel {ms:.4f} ms device time "
            f"({one:.4f} ms a call), plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}; {read} B read: {n_pf} fluid slots, "
            f"{n_pb} boundary slots, {n_wb} of them within h, {idx} B of "
            f"index entries; {written} B written; {ops:.4g} float32 "
            f"operations over {cand} candidate / {within} within-h "
            f"pairs); kernel / bound {ms / b_ms:.1f}")
    # The main path runs the sparse layout: its numbers go in the record.
    results["hoist_fb"] = dict(
        fb["sparse"],
        max_abs_err=max(fb["sparse"]["max_abs_err"],
                        fb["full"]["max_abs_err"]),
        full_grid=fb["full"],
    )
    results["expand"] = phase_expand(world, ctx)
    return results


def slot_sources(binned):
    """The particle index feeding each slot of a binning, [cap, C] int64
    (N = an empty slot): the JAX package's ``grid_src``, made from the run
    table as the JAX binning makes it."""
    cap, C = binned.mask.shape
    n = binned.order.shape[0]
    dev = binned.order.device
    r = torch.arange(cap, device=dev)[:, None]
    valid = r < torch.clamp(binned.count, max=cap)[None, :]
    order_ext = torch.cat([binned.order.long(),
                           torch.full((1,), n, device=dev)])
    return order_ext[torch.where(valid, binned.start[None, :] + r, n)]


def gather(src, items):
    """The JAX package's ``to_grid_multi``: ONE packed row gather
    ``packed[grid_src]`` of every channel (``src``: :func:`slot_sources`),
    then a fill and a contiguous copy per channel; the library call
    ``expand`` is timed against."""
    chans = []
    for vals, _fill in items:
        chans += [vals] if vals.ndim == 1 else list(vals.unbind(1))
    packed = torch.stack(chans, dim=-1)
    packed = torch.cat([packed, packed.new_zeros((1, len(chans)))])
    g = packed[src]  # [cap, C, ch]
    empty = src >= packed.shape[0] - 1
    out, col = [], 0
    for vals, fill in items:
        d = 1 if vals.ndim == 1 else vals.shape[1]
        comps = [(torch.where(empty, fill, g[..., col + k]) if fill != 0.0
                  else g[..., col + k]).contiguous() for k in range(d)]
        out.append(comps[0] if vals.ndim == 1 else torch.stack(comps))
        col += d
    return out


def phase_expand(world, ctx):
    """Phase 5, the binning's ``expand``: the kernel against
    ``expand_plain`` on the fluid binning (the positions and velocities,
    the main path's first call) and on the compact boundary binning, at
    the world's state. Exact equality (it moves data only), a bitwise
    rerun, and two planted faults that must break it: a column's start
    off by one, and one row dropped from a column's count. The library
    call: the JAX package's packed row gather ``packed[grid_src]``
    (:func:`gather`, ``grid_src`` made once beforehand). Bound: bytes (the live
    slots' channels and sort-order entry read once, the run table read
    once, the output planes written once)."""
    from salva_tpu_torch.geometry import dense_grid as tdg
    from salva_tpu_torch.ops import binning

    fl, bd = world.fluids_state, world.boundaries_state
    calls = {
        "fluid": (ctx.binf, [(fl.positions, tdg.POS_SENTINEL),
                             (fl.velocities, 0.0)]),
        "boundary": (ctx.binb, [(bd.positions, tdg.POS_SENTINEL),
                                (bd.velocities, 0.0)]),
    }
    rec = {}
    for label, (binned, items) in calls.items():
        cap, C = binned.mask.shape
        src = slot_sources(binned)
        out = binning.expand(binned, items)
        ref = binning.expand_plain(binned, items)
        again = binning.expand(binned, items)
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        for o, r, a in zip(out, ref, again):
            assert torch.equal(o, r), f"expand ({label}) differs from plain"
            assert torch.equal(o, a), f"expand ({label}): not deterministic"
        for o, g in zip(out, gather(src, items)):
            assert torch.equal(o, g), f"expand ({label}) differs from gather"
        # Planted faults, in the column with the most rows up to the cap
        # (a row dropped past the cap would change nothing).
        cnt = binned.count
        col = int(torch.argmax(torch.where(cnt <= cap, cnt, 0)))
        assert int(cnt[col]) >= 2
        start_bad = binned.start.clone()
        start_bad[col] += 1
        count_bad = cnt.clone()
        count_bad[col] -= 1
        for fault, bad in (("start off by one", binned._replace(
                start=start_bad)), ("one row dropped", binned._replace(
                count=count_bad))):
            wrong = binning.expand(bad, items)
            assert not all(torch.equal(w, r) for w, r in zip(wrong, ref)), \
                f"planted fault {fault} passed"
            log(f"[kernels] expand ({label}): planted fault '{fault}' in "
                f"column {col} ({int(cnt[col])} rows) caught")
        nch = sum(1 if v.ndim == 1 else v.shape[1] for v, _ in items)
        n_live = int(torch.clamp(cnt, max=cap).sum())
        read = n_live * 4 * (nch + 1) + 8 * C
        written = 4 * nch * cap * C
        b_ms = (read + written) / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: binning.expand(binned, items), 50)
        one = call_ms(lambda: binning.expand(binned, items), 20)
        plain_ms = cuda_ms(lambda: binning.expand_plain(binned, items), 10)
        lib_ms = cuda_ms(lambda: gather(src, items), 20)
        rec[label] = dict(max_abs_err=err, ms=ms, call_ms=one,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by="bytes")
        log(f"[kernels] expand ({label}): [{nch}, {cap}, {C}] planes, "
            f"{n_live} live slots; equal to plain and to the gather "
            f"bitwise (max abs err {err}); kernel {ms:.4f} ms device time ({one:.4f} ms a "
            f"call), plain {plain_ms:.4f} ms, library (packed gather) "
            f"{lib_ms:.4f} ms; "
            f"bound {b_ms:.5f} ms (bytes; {read} B read, {written} B "
            f"written); kernel / bound {ms / b_ms:.1f}")
    return dict(rec["fluid"], boundary=rec["boundary"])


def run_steps(solver, steps=5, sparse_boundary=True, forces=False):
    """A fresh dam break stepped ``steps`` times: (iterations per step,
    live positions, last diagnostics)."""
    world = dam_break_world("cuda", solver, sparse_boundary, forces=forces)
    iters = []
    for _ in range(steps):
        world.step(DT, GRAVITY)
        s = world.last_diagnostics.solver
        iters.append((s.pressure_iters, s.divergence_iters))
    alive = world.fluids_state.alive
    return (iters, world.fluids_state.positions[alive].clone(),
            world.last_diagnostics)


class substituted:
    """Context: the module attributes ``{(module, name): replacement}``
    replaced, and put back on exit."""

    def __init__(self, subs):
        self.subs = subs

    def __enter__(self):
        self.saved = {k: getattr(*k) for k in self.subs}
        for (mod, name), fn in self.subs.items():
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def phase_path_parity(pair, solver, forces=False):
    """Phase 6: 5 steps through the kernels vs 5 through the plain
    versions (substituted for the wrappers here, in the script: the pair
    passes' ``*_plain`` and the binning's ``expand_plain``). Returns the
    kernel run."""
    from salva_tpu_torch.ops import binning

    tag = f"[parity {path_name(solver, forces)}]"
    names = ("k_pass", "t_pass", "hoist_ff", "hoist_fb")
    kernel_run = run_steps(solver, forces=forces)
    it_k, pos_k, _ = kernel_run
    subs = {(pair, n): getattr(pair, n + "_plain") for n in names}
    subs[(binning, "expand")] = binning.expand_plain
    reset_counts(pair)
    with substituted(subs):
        it_p, pos_p, _ = run_steps(solver, forces=forces)
    assert not any(read_counts(pair).values()), "the plain run launched"
    dpos = float((pos_k - pos_p).abs().max())
    log(f"{tag} iterations kernels {it_k} vs plain {it_p}; "
        f"max |dpos| {dpos:.3e} m (atol {PATH_POS_ATOL[solver]})")
    assert it_k == it_p, "iteration counts differ between kernels and plain"
    assert dpos <= PATH_POS_ATOL[solver], f"positions differ by {dpos}"
    return kernel_run


def phase_expand_vs_gather(pair, kernel_run):
    """Phase 6: the DFSPH path with the JAX package's packed row gather
    (:func:`gather` through :func:`slot_sources`) substituted for the
    ``expand`` kernel: bitwise equal positions after 5 steps."""
    from salva_tpu_torch.ops import binning

    def by_gather(binned, items):
        return gather(slot_sources(binned), items)

    reset_counts(pair)
    with substituted({(binning, "expand"): by_gather}):
        iters, pos, _ = run_steps("dfsph")
    assert read_counts(pair)["expand"] == 0
    dpos = float((pos - kernel_run[1]).abs().max())
    log(f"[expand vs gather] DFSPH 5 steps, iterations {iters}; max |dpos| "
        f"between the expand and the gather path {dpos:.3e} m (must be 0)")
    assert iters == kernel_run[0], "iterations differ"
    assert torch.equal(pos, kernel_run[1]), "positions differ"


def phase_full_grid(pair, sparse_run):
    """Phase 7: the DFSPH dam break on the full-grid boundary binning,
    through the kernels, against the sparse binning's kernel run. Returns
    its launch counts."""
    reset_counts(pair)
    iters, pos, d = run_steps("dfsph", sparse_boundary=False)
    launches = read_counts(pair)
    n = pos.shape[0]
    dpos = float((pos - sparse_run[1]).abs().max())
    log(f"[full grid] 5 steps, iterations {iters}, launches {launches}, "
        f"overflow {int(d.neighbor_overflow)}, contacts fb "
        f"{int(d.ncontacts_fb)}, max density ratio "
        f"{float(d.max_density_ratio):.4f}; max |dpos| vs the sparse "
        f"binning {dpos:.3e} m (atol {PATH_POS_ATOL['dfsph']})")
    for name in MAIN_PATH_KERNELS:
        assert launches[name] > 0, f"{name} was never launched on the full grid"
    assert iters == sparse_run[0], "iterations differ from the sparse run"
    assert int(d.neighbor_overflow) < max(1, n // 1000)
    assert bool(torch.isfinite(pos).all())
    assert dpos <= PATH_POS_ATOL["dfsph"], f"positions differ by {dpos}"
    return launches


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
    libs = _build.library_paths()
    _build.load()
    log(f"[setup] kernels built and loaded in {time.perf_counter() - t0:.2f}"
        f" s: {', '.join(map(str, libs))}")

    paths = {}
    t0 = time.perf_counter()
    world, dfsph = phase_main_path(pair, "dfsph")
    paths["dfsph"] = dfsph["launches"]
    log(f"[main dfsph] phase took {time.perf_counter() - t0:.1f} s")
    for solver, forces in (("iisph", False), ("dfsph", True),
                           ("iisph", True)):
        t0 = time.perf_counter()
        other, run = phase_main_path(pair, solver, forces)
        del other
        paths[path_name(solver, forces)] = run["launches"]
        log(f"[main {path_name(solver, forces)}] phase took "
            f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_kernels(pair, world)
    del world
    torch.cuda.empty_cache()
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sparse_run = phase_path_parity(pair, "dfsph")
    phase_expand_vs_gather(pair, sparse_run)
    phase_path_parity(pair, "iisph")
    phase_path_parity(pair, "dfsph", forces=True)
    phase_path_parity(pair, "iisph", forces=True)
    log(f"[parity] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["dfsph_full_grid"] = phase_full_grid(pair, sparse_run)
    log(f"[full grid] phase took {time.perf_counter() - t0:.1f} s")

    records = []
    for name, k in kernels.items():
        if name == "k_pass_v2":
            on, launches = "phase 5 checks (no main path runs it)", \
                k["check_launches"]
        else:
            on, launches = "dfsph_forces", paths["dfsph_forces"][name]
        extra = {key: k[key] for key in ("full_grid", "boundary") if key in k}
        records.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches,
            launches_path=on,
            launches_by_path={p: c[name] for p, c in paths.items()},
            max_abs_err=k["max_abs_err"], ms=k["ms"], call_ms=k["call_ms"],
            plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
            library_ms=k.get("library_ms"), **extra))
    assert sorted(r["name"] for r in records) == sorted(REPLACES)
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
