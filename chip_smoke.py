#!/usr/bin/env python3
"""GPU smoke run of salva_tpu_torch, the PyTorch + CUDA port.

Drives the port's main paths (``PATHS``; the coupled path and the
reference scenes of phases 9-12) — the 3D dam break of
``bench.py`` at 97,336 particles, on the dense layout solved with DFSPH
and with IISPH, without and with the fluid's XSPH and
artificial-viscosity forces, under the poly6 / spiky SPH kernels, with
the Akinci, WCSPH and He 2014 surface tensions, with the DFSPH implicit
viscosity and with the Becker 2009 elasticity, and on the gather layout
(Morton grid, [N, K] neighbour tables) — on one NVIDIA GPU, in these
phases:

1. setup: the card's name and power limit, and the build of the hand
   CUDA kernels from ``salva_tpu_torch/csrc`` (one nvcc per source, all
   at once, at first use);
2. the DFSPH main path: ``LiquidWorld(..., device="cuda")``, 10 warm-up
   and 20 timed steps, with every kernel's launch count from that run;
   on every main path each step's neighbour overflow is recorded and the
   largest printed beside the last step's (the gate reads the last);
3. the IISPH main path: the same scene with ``solver=IISPHConfig()``,
   10 warm-up and 20 timed steps, its launch counts and per-step
   pressure iterations;
4. the other main paths: the same dam break whose fluid carries
   ``ArtificialViscosity(1.0, 0.0)`` and ``XSPHViscosity(0.5, 1.0)``,
   under DFSPH and under IISPH, 10 warm-up and 20 timed steps each;
   DFSPH under ``kernel_density="poly6"`` / ``kernel_gradient="spiky"``
   (10 + 20); faucet3's XSPH + Akinci tension under DFSPH and the WCSPH
   + He 2014 tensions under IISPH and poly6 / spiky (10 + 10 each); and
   ``DFSPHViscosity(0.5)`` under DFSPH (3 + 5, stopping at the first
   step that leaves a non-finite position: the reference's iteration
   diverges at its defaults), whose path is held to one application of
   the force with one viscosity update at the DFSPH path's 97k state
   (``phase_implicit_visc``); elasticity3's softer block
   (``Becker2009Elasticity(1e5, 0.3, True)`` + ``XSPHViscosity(0.5,
   1.0)``, ``dense_elastic``: the elasticity as ``ParticleWiseForce``
   beside the pair kernels, 10 + 10), with the device time of its
   ``apply_particles`` and of the batched SVD inside it;
4b. (run last, after phase 8: see ``main``) the gather layout
   (``phase_gather_path``): DFSPH; IISPH with the
   viscosity forces; DFSPH with faucet3's forces, with custom_forces3's
   two attractors (``CustomForce``, which has no dense form: the dense
   layout must refuse it, ``auto`` resolve to gather, and the masked
   force equal a float64 evaluation) and with the elasticity; each 1 +
   9 warm-up + 10 timed + 2 profiled steps (the device's busy share),
   launching no pair kernel, beside its dense twin (the same world on
   the dense layout), held after one step to identical iterations and
   ff contacts and to the JAX package's dense-vs-gather bounds, the gap
   after the last step logged; the DFSPH path run twice, bitwise equal;
   then the WCSPH + He 2014 tensions under poly6 / spiky and the DFSPH
   viscosity at one iteration, 8 gather steps each (``GATHER_ONE_STEP``),
   through the step gates;
5. each kernel against its plain PyTorch version on identical tensors
   taken from the DFSPH world's state past impact (cells hold more than
   8 particles), both hoists with their IISPH ``s2`` channel and
   without it (the DFSPH setting: ``s2`` exactly zero), the
   fluid-boundary hoist on both boundary layouts (the sparse one the
   world resolves, and the same state binned into the full grid), the
   slot-group ``k_pass_v2`` (which no main path runs, as in the JAX
   package; it launches the tiled ``k_pass`` body) against ``k_pass``'s
   plain version, and the binning's ``expand`` on the fluid binning, on
   the boundary binning and on both in one launch (``expand_many``, the
   call a substep makes) (exact):
   per-output errors and tolerances, a bitwise rerun, CUDA-event times,
   the least time the card could take (bound: the bytes of the live
   slots the pass must read and of its outputs, or its float32
   operations), the library call's time where one computes the same
   function, the device launches one call of each hoist makes (the
   profiler's count), and planted faults that each output's rule must
   catch (for the tiled ``k_pass``, ``t_pass`` and ``hoist_ff``, whose
   tiling is logged, in the fullest cell on a tile's edge); then every
   SPH kernel name (``KERNEL_NAMES``) in each role: ``k_pass``,
   ``t_pass`` and ``k_pass_v2`` under each non-cubic gradient kernel,
   both hoists under the non-cubic ``HOIST_PAIRS``, each held, timed and
   bounded (the planted faults on the poly6 / spiky instantiations);
6. each main path (DFSPH and IISPH, without and with the viscosity
   forces; DFSPH under poly6 / spiky and with faucet3's tension)
   stepped 5 times through the kernels and 5 times through the plain
   versions (substituted here, in the script), with identical iteration
   counts and matching positions required; the DFSPH path again with the
   JAX package's packed gather ``packed[grid_src]`` in place of
   ``expand`` (bitwise equal);
7. the DFSPH dam break on the full-grid boundary binning
   (``dense_sparse_boundary=False``) for 5 steps, through the kernels,
   against the phase-6 kernel run on the sparse binning;
7a. layouts_97k (``phase_layouts_97k``): the remaining dense layouts on the
   DFSPH main path's dam break, each from the state after LAYOUTS_AT
   steps beside the kernel twin (that state stepped on the default grid)
   — the compact active-cell layout, frozen pair coefficients stored in
   float32 and in bfloat16, dense+spill at cap 12 with the table the auto
   tier sizes, dense+spill at cap 8 with 8 spill rows (the twin's 16
   slots a cell, so that cells spill in the held step and its pairs are
   the twin's), and the auto tier itself (``dense_spill_auto``, which
   must resolve to 12 + the same table and step bitwise the same): one
   step held to the twin (LAYOUT_POS_ATOL, iterations where
   LAYOUT_SAME_ITERS says, exact contact counts), then LAYOUT_STEPS steps
   (cap 8: SPILL8_STEPS) with the neighbour and spill overflow 0 and
   finite positions at every step (the cap-12 spill layout on to step
   30, where the cap-16 main path drops entries, its overflow there
   logged), a bitwise rerun of the first two, ms/step, device ms/step
   and busy share, the launches of the hand kernels (LAYOUT_KERNELS: the
   hoists and ``expand`` under frozen pairs, ``expand`` alone on the
   compact layout, whose passes are its own plain folds as in the JAX
   package, and on the spill layouts ``k_pass``, ``t_pass`` and
   ``hoist_ff`` on the main columns beside the plain folds of the pairs
   that touch a spill slot), the frozen store's bytes and the spill tables,
   ``expand`` on each layout's binnings bitwise its plain expansion
   (the compact tables; the spill columns' extended run table); every
   kernel wrapper's plain version raises meanwhile. Then
   ``phase_small_overflow``: bench_torch.py's dfsph_4k_dense world
   (4,096 particles) SMALL_STEPS steps plain and on the 12 + spill auto
   tier, each step's neighbour and spill overflow logged (no gate: ROADMAP
   Queue 3, item 14);
7b. slab_97k (``phase_slab_path``, ``slab_kernel_checks``): the slab path
   of ``salva_tpu_torch.parallel`` (replicated binning) on the DFSPH dam
   break with the full-grid boundary binning and caps 16 / 16, SLAB_N = 4
   slabs under ``LocalHalos`` on the one card (NCCL refuses two ranks on
   one GPU), 10 steps beside its single-device twin (the same full-domain
   grid without the half stencil, the kernels in the forms the slabs run
   them): identical iterations and ff contacts at every step, each step's
   overflow under its gate, positions within PATH_POS_ATOL after step 5
   (the gap after step 10 logged), every main-path kernel launched, ms/step
   of both; then each main-path kernel on the local grid of the slab
   owning the most particles, against its plain version on the interior
   columns (pair counts exact, ``expand`` bitwise), timed beside the
   twin's, with bounds (pair counts exact: the kernels round r^2 as the
   plain versions do; a differing slot is logged with its near ties
   before the assertion); then IISPH with the viscosity forces, 5 steps,
   held to its twin the same way;
7c. slab_97k_migrate (``phase_slab_migrate``): the same DFSPH world on
   SLAB_N slabs with sharded binning (``sharded_binning=True``: the rows
   migrate to their slabs each substep), from the state reordered by
   ``shard_interleave``, 10 steps beside the replicated slab path and the
   single-device twin from that state: identical iterations, ff contacts,
   overflow and candidate overflow (send overflow 0) at every step,
   positions bitwise (or within 1e-6 m) the replicated run's after step
   5, every main-path kernel launched by the migrated run, each slab's
   received rows, ms/step of the three; then phase 7b's kernel checks on
   one slab's grid binned from its migrated rows (equal to the replicated
   slab's grid); the elasticity case (dense_elastic's forces on that
   world, the elasticity evaluated on the home rows before the migration)
   3 steps against its single-device twin (identical iterations, positions
   within 1e-5 m, velocities within 1e-4 m/s); and
   ``salva_tpu_torch.parallel.dryrun(4)`` on the card;
8. the brute all-pairs tier: two small worlds on the card,
   ``tests/test_brute.py``'s dam world (125 particles) and the bench
   scene at 16^3 = 4,096 particles (capacity at the brute ceiling), each
   resolving ``layout="auto"`` to brute and stepped 10 times, twice
   (bitwise equal, no kernel launched: the tier runs the full-stencil
   plain folds, as the JAX package runs no Pallas kernel there), against
   the same world at ``layout="dense"`` through the kernels: exact step-1
   contact counts, identical iterations, matching positions;
9. 2D on the card (``phase_twin_2d``): ``scenes.basic2`` (1,110
   particles, three coupled dynamic bodies) pinned to the dense layout,
   10 steps through the kernels (its launch counts: every main-path
   kernel and the rigid solve) and 10 through the plain versions,
   identical iterations, positions within PATH_POS_ATOL; then phase 5's
   cubic checks at dim = 2 at its state (k_pass, t_pass, both hoists on
   both boundary layouts, expand: each output within its peak's
   tolerance, pair counts exact, planted faults caught, times, bounds);
10. the rigid bodies' contact solve (``csrc/rigid_solve.cu``) against its
   plain version on basic2's contact table (its bodies set into the
   ground), with planted faults, times and the bound;
11. the coupled main path (``phase_coupled_harness``):
   ``scenes.harness_basic3(nparticles=40)``, 64,000 particles in
   basic3's static-sampled walls on the device coupling path, 10 + 20
   steps: ms/step, device ms/step and busy share, iterations, the
   overflow gate, layout, caps and window, the two coupling counters per
   step, the fluid inside the walls; a device twin, a host-coupling twin
   and a plain twin (the device path through the plain versions) 3
   steps each, identical iterations and overflow, positions within
   PATH_POS_ATOL; then phase 5's cubic checks at its state, every kernel
   against its plain version on one input at the harness's shapes;
12. every ``scenes.SCENES`` entry at its published size, 20 steps through
   ``scenes.run`` (``phase_scenes``: layout, coupling path, ms/step,
   device ms/step and busy, counts, iterations, body poses, each step's
   neighbor overflow under the coupled harness's gate; finite
   state; faucet3's emission schedule and its deletion below y = -2
   counted exactly; basic2 / layers2's body boundaries at their poses;
   the custom forces' attractors), and basic2 one step on each coupling
   path;
13. (after the gather phases) adaptive_ckpt_97k (``phase_adaptive_ckpt``):
   the DFSPH dam break with dfsph_97k_visc's forces,
   ``adaptive_timestep=True`` and ``debug_checks=True``, 9 steps of 1/60
   s: substeps, iterations, overflow gate and ms per step, the device
   busy share per step from a second, profiled run (bitwise equal to the
   first); at least one step must split; saved with ``io.save_world``
   after step 4 (the file's size), loaded on the card with
   ``io.load_world`` and resumed beside the uninterrupted world, bitwise
   equal at every step; a plain twin to the first split step (same
   substeps and iterations, its gap per step logged; the split step
   alone, from the kernel run's state and from the plain twin's, within
   PATH_POS_ATOL of the plain versions' step) and two witnesses of the
   gap's cause (the kernels' split step from the plain twin's state and
   from a 1-ulp nudge of the kernel run's); phase 5's cubic checks at
   its last state;
14. trimesh_and_queries (``phase_trimesh_queries``): a 320-triangle
   icosphere voxelized on the card (bitwise equal to the CPU's field at a
   small resolution) and sampled by the native sampler (g++, built at
   first use), resting on the floor twice under the 97k block on the
   device coupling path (static sampling; DynamicContactSampling through
   its VoxelSdf), 10 steps through phase 11's gates with the coupling
   share, the emitted contact samples and the boundary cell occupancy
   per step; the shape and box queries against the same field and box
   evaluated on the CPU; phase 5's cubic checks at the mesh world's
   state; the device busy share over two profiled steps and two steps
   split by stage (``stage_split``); ``z_sort`` of the gather_dfsph world
   beside an unsorted twin for 5 steps, matched by particle.

Usage, from the repository root:  python3 chip_smoke.py
Exits non-zero without a result line when no CUDA device is present or
any phase fails. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the line
before that the kernels' JSON record (``launches``: the count of the
run named by ``launches_path`` — the DFSPH forces path; for
``k_pass_v2``, which no main path launches, its phase-5 checks and
timing; for ``rigid_solve``, basic2's 20 scene steps
(``scenes_basic2``); ``launches_by_path``: every main path's, the brute
paths' and the gather paths' zeros included — a gather path's ``expand``
count is its world's one-time full-extent boundary-volume pass in its
first step; ``kernel_names``: the SPH kernel names held in phase 5, with
their numbers under ``by_kernel``; ``dim2``: the kernel's phase-9
numbers at dim = 2, with the 2D twin's launches; ``harness``: its
phase-11 numbers at the 64,000-particle harness's state, with the
harness's launches; ``slab``: its phase-7b numbers on one slab's
local grid, with the slab run's launches and the twin's device time;
``slab_migrate``: its phase-7c numbers on one migrated slab's grid, with
the migrated run's launches; ``launches_by_path`` also holds phase 7a's
layout paths (``compact_97k``, ``frozen_97k_f32``, ``frozen_97k_bf16``,
``spill_97k``, ``spill8_97k``, ``spill_auto_97k``) and its two
``small_4k_*`` runs,
whose numbers are logged on one ``[layouts_97k] summary`` JSON line;
``contacts`` / ``impulses`` for ``rigid_solve``:
its table's live rows and the impulses its bound counts). The coupled
phases' numbers are logged on one ``[coupled] summary`` JSON line, and
phases 13-14's on one ``[host world] summary`` line; ``adaptive`` /
``mesh``: a kernel's phase-13 / phase-14 numbers at the adaptive path's
and the mesh world's state.
"""

import copy
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

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
# Brute tier vs the grid through the kernels after 10 steps (positions,
# metres): tests/test_brute.py's bound for the 125-particle dam world,
# and the kernel-vs-plain DFSPH bound above for the 16^3 bench scene
# (the same lattice start). Measured on an H100 (700 W): 6.0e-8 and
# 2.4e-7, with identical iterations.
BRUTE_POS_ATOL = {"dam_n5": 2e-6, "bench_16": PATH_POS_ATOL["dfsph"]}
# The fluid's non-pressure forces on the forces main paths: the basic3
# scene's artificial viscosity and the elasticity scenes' XSPH (whose
# nonzero boundary coefficient drives the fluid-boundary passes), as
# (class name in salva_tpu_torch/forces.py, arguments).
FORCES = (("ArtificialViscosity", (1.0, 0.0)), ("XSPHViscosity", (0.5, 1.0)))
# faucet3's forces (salva_tpu/scenes.py:428-429): the Akinci adhesion runs
# the fluid-boundary and boundary-fluid passes.
FAUCET3 = (("XSPHViscosity", (0.5, 0.0)),
           ("Akinci2013SurfaceTension", (1.0, 10.0)))
# The WCSPH and He 2014 tensions of tests/test_dense.py:278-279.
WCSPH_HE = (("WCSPHSurfaceTension", (1.0, 0.5)),
            ("He2014SurfaceTension", (1.0, 0.5)))
# The SPH kernel names every pair kernel takes, in each role.
KERNEL_NAMES = ("cubic", "poly6", "spiky", "viscosity")
# elasticity3's softer block (salva_tpu/scenes.py:339-356): the Becker
# 2009 elasticity, Green strain, and the elasticity scenes' XSPH.
ELASTIC = (("Becker2009Elasticity", (100_000.0, 0.3, True)),
           ("XSPHViscosity", (0.5, 1.0)))
# custom_forces3's two attractors (salva_tpu/scenes.py:367-384), as
# (class name in salva_tpu_torch/scenes.py, arguments).
ATTRACTORS = (("AttractorForce", ((1.0, 0.0, 0.0),)),
              ("AttractorForce", ((-1.0, 0.0, 0.0),)))
# The main paths, all on the 97k dam break: solver, (kernel_density,
# kernel_gradient), the fluid's forces, the layout (the dense grid unless
# named), and (warm-up, timed) steps. The implicit viscosity iterates up
# to 50 times a step, so its path is short. The gather paths run the
# Morton grid and [N, K] neighbour tables (plain PyTorch: the JAX
# package's gather layout reaches no Pallas kernel) and launch no pair
# kernel; dense_elastic runs the elasticity beside the pair kernels.
PATHS = {
    "dfsph": dict(solver="dfsph"),
    "iisph": dict(solver="iisph"),
    "dfsph_forces": dict(solver="dfsph", forces=FORCES),
    "iisph_forces": dict(solver="iisph", forces=FORCES),
    "dfsph_poly6_spiky": dict(solver="dfsph", kernels=("poly6", "spiky")),
    "dfsph_tension": dict(solver="dfsph", forces=FAUCET3, steps=(10, 10)),
    "iisph_tension_poly6_spiky": dict(
        solver="iisph", kernels=("poly6", "spiky"), forces=WCSPH_HE,
        steps=(10, 10)),
    "dfsph_implicit_visc": dict(
        solver="dfsph", forces=(("DFSPHViscosity", (0.5,)),),
        steps=(3, 5)),
    "gather_dfsph": dict(solver="dfsph", layout="gather", steps=(9, 10)),
    "gather_iisph_visc": dict(solver="iisph", layout="gather", forces=FORCES,
                              steps=(9, 10)),
    "gather_tension": dict(solver="dfsph", layout="gather", forces=FAUCET3,
                           steps=(9, 10)),
    "gather_custom": dict(solver="dfsph", layout="gather", forces=ATTRACTORS,
                          steps=(9, 10)),
    "dense_elastic": dict(solver="dfsph", forces=ELASTIC, steps=(10, 10)),
    "gather_elastic": dict(solver="dfsph", layout="gather", forces=ELASTIC,
                           steps=(9, 10)),
}
# Dense vs gather after one step from the same world: the JAX package's
# own bounds (tests/test_dense.py:94-97), positions (m) and velocities
# (m/s). They hold on bench.py's 97k lattice. They need no particle on a
# dense cell edge: there a pair at exactly r = h spans two cells, outside
# the dense 3^dim stencil, while the gather layout counts it. W and its
# gradient vanish there, but the DFSPH neighbour-count gate flips: the
# same dam break at 12^3 counts 44,488 ff contacts on the gather layout
# and 43,912 on the dense one, and its two steps end 2.0e-3 m and 0.40
# m/s apart, in both packages (tests/test_torch_gather_dam_break.py).
TWIN_POS_ATOL, TWIN_VEL_ATOL = 5e-4, 5e-3
# The remaining forces on the gather layout, 8 steps each (the block
# meets the floor at step ~5; the first steps' lattice holds the cubic
# spline's density at 0.894 of rest, under the density gate): the WCSPH
# and He 2014 tensions under poly6 / spiky, and the DFSPH viscosity at
# one iteration.
GATHER_SHORT_STEPS = 8
GATHER_ONE_STEP = {
    "gather_wcsph_he": dict(solver="dfsph", layout="gather", forces=WCSPH_HE,
                            kernels=("poly6", "spiky")),
    "gather_dfsph_visc_1": dict(
        solver="dfsph", layout="gather",
        forces=(("DFSPHViscosity", (0.5, 1, 1)),)),
}
# The (kernel_density, kernel_gradient) pairs phase 5 holds the hoists
# under: every pair a main path uses, and the viscosity kernel in both
# roles (the gradient-only passes take every name of KERNEL_NAMES).
HOIST_PAIRS = (("cubic", "cubic"), ("poly6", "spiky"),
               ("viscosity", "viscosity"))
REPLACES = {
    # The device coupling's sequential-impulse solve, a lax.scan the JAX
    # package leaves to XLA (no Pallas kernel).
    "rigid_solve": "salva_tpu/coupling/device_pipeline.py:347",
    "k_pass": "salva_tpu/ops/pallas_pair.py:707",
    "t_pass": "salva_tpu/ops/pallas_pair.py:225",
    "hoist_ff": "salva_tpu/ops/pallas_pair.py:382",
    "hoist_fb": "salva_tpu/ops/pallas_pair.py:562",
    "k_pass_v2": "salva_tpu/ops/pallas_pair2.py:191",
    "expand": "tools/exp_pallas_expand.py:37",
}
SOURCES = {name: "salva_tpu_torch/csrc/pair_passes.cu" for name in REPLACES}
SOURCES["expand"] = "salva_tpu_torch/csrc/expand.cu"
SOURCES["rigid_solve"] = "salva_tpu_torch/csrc/rigid_solve.cu"
# The kernels every main path launches; k_pass_v2 runs on none (as in
# the JAX package, no solver calls it): phase 5 holds and times it.
MAIN_PATH_KERNELS = ("k_pass", "t_pass", "hoist_ff", "hoist_fb", "expand")
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): HBM3
# bandwidth and float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# The shared state of phase 7a (layouts_97k): the DFSPH main path's world
# after LAYOUTS_AT steps (past impact); each layout then steps
# LAYOUT_STEPS steps from it. LAYOUTS: each layout's configuration
# ("spill_at_cap": dense_cap 12 with the spill table the auto tier sizes
# on that state; "spill_full": dense_cap 8 with a table of 8 spill rows a
# cell, so that the main columns and their spill columns hold the 16
# slots of the twin's cap and every cell past 8 spills, sized as the auto
# tier would at cap 8, with K = 3^dim; dense_spill_auto: the auto tier
# itself).
LAYOUTS_AT = 10
LAYOUT_STEPS = 10
# spill_97k runs on, past its LAYOUT_STEPS gated steps, to step 30,
# where the main path's cap 16 drops entries: its overflow there is
# logged, not gated (cells past cap + 8 spill rows are dropped, and the
# window's border ring collects clamped escapees by then: ROADMAP Queue
# 3, item 24). The auto tier runs the 2 steps it is held bitwise to
# spill_97k over. spill8_97k runs the held step and one more (its table
# is sized for the shared state; an explicit cap does not self-heal).
LAYOUT_STEPS_SPILL, SPILL_AUTO_STEPS, SPILL8_STEPS = 20, 2, 2
LAYOUTS = {
    "compact_97k": dict(dense_compact=True),
    "frozen_97k_f32": dict(dense_frozen_pairs=True,
                           dense_pair_dtype="float32"),
    "frozen_97k_bf16": dict(dense_frozen_pairs=True,
                            dense_pair_dtype="bfloat16"),
    "spill_97k": dict(spill_at_cap=True),
    "spill8_97k": dict(spill_full=True),
    "spill_auto_97k": dict(dense_spill_auto=True),
}
# One step of each layout against the kernel twin from the shared state
# (positions, metres): the main path's kernel-vs-plain bound (item 5) for
# the layouts whose pairs and arithmetic are the twin's up to float32
# summation order; bfloat16 storage rounds each coefficient to 8 bits of
# mantissa: measured 3.79e-5 on an H100 (700 W), held to 5e-4, ten times
# under the JAX package's own bound against the recomputed passes
# (5e-3, tests/test_dense.py:358).
LAYOUT_POS_ATOL = {"compact_97k": PATH_POS_ATOL["dfsph"],
                   "frozen_97k_f32": PATH_POS_ATOL["dfsph"],
                   "frozen_97k_bf16": 5e-4,
                   "spill_97k": PATH_POS_ATOL["dfsph"],
                   "spill8_97k": PATH_POS_ATOL["dfsph"],
                   "spill_auto_97k": PATH_POS_ATOL["dfsph"]}
# Identical iterations to the twin's where the JAX tests require them
# (tests/test_dense.py:360: frozen float32); the others are logged.
LAYOUT_SAME_ITERS = ("frozen_97k_f32",)
# The hand kernels each layout's step launches (as in the JAX package:
# the compact layout runs its own plain folds, the spill layout the ff
# passes on its main columns and its own plain folds for the pairs that
# touch a spill slot and for the fb hoist, frozen pairs keep the hoists;
# every sorted binning expands through its run table); every other
# main-path kernel must launch no time.
_SPILL_KERNELS = ("k_pass", "t_pass", "hoist_ff", "expand")
LAYOUT_KERNELS = {"compact_97k": ("expand",),
                  "frozen_97k_f32": ("hoist_ff", "hoist_fb", "expand"),
                  "frozen_97k_bf16": ("hoist_ff", "hoist_fb", "expand"),
                  "spill_97k": _SPILL_KERNELS,
                  "spill8_97k": _SPILL_KERNELS,
                  "spill_auto_97k": _SPILL_KERNELS}
# bench_torch.py's dfsph_4k_dense world (ROADMAP Queue 3, item 14):
# SMALL_N particles, SMALL_STEPS steps per variant.
SMALL_N = 4096
SMALL_STEPS = 30
# The slab path (phase 7b, slab_97k): SLAB_N slabs of the 97k dam break
# on the one card (LocalHalos: NCCL refuses two ranks on one GPU), its
# DFSPH run SLAB_STEPS steps beside its single-device twin, positions held
# after SLAB_HOLD_AT; then IISPH with FORCES, SLAB_IISPH_STEPS steps.
SLAB_N = 4
SLAB_STEPS = 10
SLAB_HOLD_AT = 5
SLAB_IISPH_STEPS = 5
# Phase 7c (slab_97k_migrate): the sharded-binning run against the
# replicated one, positions after SLAB_HOLD_AT (metres; the received
# blocks keep their senders' row order, so the grids, and the runs, are
# expected bitwise); the elasticity case MIGRATE_ELASTIC_STEPS steps
# against the single-device twin at tests/test_domain.py:179-235's bounds.
MIGRATE_POS_ATOL = 1e-6
MIGRATE_ELASTIC_STEPS = 3
ELASTIC_POS_ATOL, ELASTIC_VEL_ATOL = 1e-5, 1e-4
# Float32 operations per pair, counted from the kernel source (a sqrt,
# rsqrt or division counts as one): the distance test every candidate pair
# needs (dim subtractions, dim products, dim - 1 sums), and the rest of
# the pair's arithmetic, needed only for pairs within h: dW/dr / r of the
# gradient kernel, W of the density kernel (the hoists), then each
# pass's accumulations. Cubic: dW/dr / r 14 (one sqrt, one rsqrt), W 10
# more from the same q; each other kernel takes its own sqrt of r^2,
# shared by W and dW/dr / r when both roles name it.
OPS_CANDIDATE = {2: 5, 3: 8}
OPS_DWR = {"cubic": 14, "poly6": 8, "spiky": 6, "viscosity": 12}
OPS_W = {"cubic": 11, "poly6": 6, "spiky": 5, "viscosity": 11}
OPS_ACC = {"k_pass": 8, "t_pass": 8, "hoist_ff": 24, "hoist_fb": 33,
           "k_pass_v2": 8}
# Float32 operations of one impulse of the rigid solve, counted from
# csrc/rigid_solve.cu: {dim: {(part, bodies): ops}}, the normal impulse
# (relative velocity, effective mass, the clamped accumulation, the
# application) and the friction impulse (the tangent, its effective mass,
# the Coulomb clamp, the application), for a contact against a fixed
# collider (1 body) or between two bodies (2).
OPS_RIGID_IMPULSE = {
    2: {("normal", 1): 36, ("normal", 2): 66,
        ("friction", 1): 44, ("friction", 2): 74},
    3: {("normal", 1): 143, ("normal", 2): 279,
        ("friction", 1): 156, ("friction", 2): 292},
}
# The coupled paths. harness_basic3 (salva_tpu/scenes.py:157-199,
# examples3d/harness_basic3.rs) at nparticles=40: 40^3 = 64,000 particles
# in basic3's box of static-sampled fixed cuboids (ground and four
# walls, inner faces at +-2.3 m) with ArtificialViscosity(1.0, 0.0), on
# the device coupling path; (warm-up, timed) steps; its host-coupling
# twin's steps. Every SCENES entry at its published size runs
# SCENE_STEPS steps; basic2 pinned to the dense layout (the 2D twin)
# TWIN_2D_STEPS through the kernels and as many through the plain
# versions.
HARNESS_N = 40
HARNESS_STEPS = (10, 20)
HARNESS_TWIN_STEPS = 3
WALL_INNER = 2.3
SCENE_STEPS = 20
TWIN_2D_STEPS = 10
# Phase 13 (adaptive_ckpt_97k): the dfsph_forces dam break with CFL
# substepping and the debug checks, ADAPTIVE_STEPS steps of ADAPTIVE_DT
# (0.15 s, the span bench.py's domain box is sized for; at h = 0.2 the CFL
# bound 2r / |v + a t| * 0.4 splits a 1/60 step once the predicted speed
# passes 2.4 m/s), saved after step CKPT_AFTER and resumed.
ADAPTIVE_DT = 1.0 / 60.0
ADAPTIVE_STEPS = 9
CKPT_AFTER = 4
# Phase 14 (trimesh_and_queries): an icosphere of 320 triangles, radius
# MESH_RADIUS, resting on the floor twice (static sampling through the
# native sampler at x = -MESH_X, dynamic contact sampling through its
# VoxelSdf at x = +MESH_X), under the dam break's block lifted by
# MESH_LIFT so that its bottom starts just above the spheres; MESH_STEPS
# steps of DT on the device coupling path. Then z_sort on the gather_dfsph
# world beside an unsorted twin, ZSORT_STEPS steps.
MESH_RADIUS = 0.4
MESH_X = 1.2
MESH_LIFT = 0.8
MESH_STEPS = 10
# The boundary cap of the mesh world. The auto tier sizes it from the
# boundary particles present before the first step (the floor and the
# static samples: 16), and its overflow self-heal grows the fluid cap
# only, as in the JAX package; the contact samples projected onto the
# dynamic sphere pile up past 16 in a cell within two steps (at 12^3 on
# the CPU: 8, then 12 entries dropped). Over the phase's steps on an H100
# the boundary cell occupancy peaks at 26; the cap is the auto rule's
# tier for that peak (the next multiple of 8 above occupancy + 2), and
# each step checks that the occupancy stays within it. The step's time
# grows with this cap: the plain boundary-volume fold goes as its
# square, the boundary-force fold as the cap.
MESH_CAP_B = 32
ZSORT_STEPS = 5
# A query hit whose host distance lies this close to the particle radius
# may round to the other side on the card (float32 SDF on either device).
QUERY_TIE = 1e-5
# Rigid bodies: the solve kernel vs its plain version (velocities, m/s
# and rad/s), and the two coupling paths after one step of basic2 (body
# state): float32 summation order and FMA contraction only.
RIGID_TOL = 1e-5


def ops_within(name, kd, kg):
    """Float32 operations of one pair within h of pass ``name`` under the
    density / gradient kernels ``kd`` / ``kg`` (the gradient-only passes
    ignore ``kd``): 22, 48 and 57 for the cubic k_pass, hoist_ff and
    hoist_fb."""
    ops = OPS_ACC[name] + OPS_DWR[kg]
    if name.startswith("hoist"):
        ops += OPS_W[kd] - (1 if kd == kg else 0)
    return ops


def log(msg):
    print(msg, flush=True)


def reset_counts(pair):
    """Set every kernel's launch count to 0 (pair passes, binning, rigid
    solve), and the iterative forces' iteration counts."""
    from salva_tpu_torch import counters
    from salva_tpu_torch.ops import binning, rigid

    pair.reset_launches()
    binning.reset_launches()
    rigid.reset_launches()
    counters.reset_force_iterations()


def read_counts(pair):
    """Every kernel's launch count since the last ``reset_counts``."""
    from salva_tpu_torch.ops import binning, rigid

    return dict(pair.LAUNCHES, **binning.LAUNCHES, **rigid.LAUNCHES)


def force_iterations():
    """The iterative forces' iterations since the last ``reset_counts``."""
    from salva_tpu_torch import counters

    return dict(counters.FORCE_ITERATIONS)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def dam_break_world(device, solver="dfsph", sparse_boundary=True,
                    forces=(), n_target=N_TARGET, layout="auto",
                    dense_caps=(None, None), kernels=("cubic", "cubic"),
                    adaptive=False):
    """The bench.py dam break (``run_config``): a cube of
    round(n_target^(1/3))^3 particles (46^3 by default) one radius above
    a sampled Cuboid floor, moving down at 2 m/s, in a static domain;
    caps (unless ``dense_caps`` names them), window and fb table
    auto-resolve. ``forces``: the fluid's forces, as (class name in
    salva_tpu_torch/forces.py or scenes.py, arguments) pairs; ``kernels``:
    the SPH kernels (kernel_density, kernel_gradient); ``adaptive``: CFL
    substepping (``adaptive_timestep``)."""
    from salva_tpu_torch import forces as force_specs
    from salva_tpu_torch import scenes, shapes
    from salva_tpu_torch.config import DFSPHConfig, IISPHConfig
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    n_side = max(2, round(n_target ** (1.0 / 3.0)))
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
                        layout=layout, dense_cap=dense_caps[0],
                        dense_cap_boundary=dense_caps[1],
                        adaptive_timestep=adaptive, device=device)
    world.sim = world.sim.replace(dense_sparse_boundary=sparse_boundary,
                                  kernel_density=kernels[0],
                                  kernel_gradient=kernels[1])
    pos = scenes.cube_fluid((n_side, n_side, n_side), radius)
    pos[:, 1] += half + radius
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    nonpressure = [getattr(force_specs, name, None)
                   or getattr(scenes, name) for name, _ in forces]
    nonpressure = [cls(*args) for cls, (_, args) in zip(nonpressure, forces)]
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


def bound(name, dim, read_bytes, written_bytes, candidates, within,
          kernels=("cubic", "cubic")):
    """(bound_ms, bound_by, ops): the larger of the bytes the call must
    move over the HBM rate and the float32 operations this state's pairs
    need over the float32 rate, under the SPH ``kernels`` (density,
    gradient). ``read_bytes`` counts each input element the function
    needs read once (live slots only, from this run's counts);
    ``written_bytes`` the output tensors it returns, each element written
    once."""
    ops = (OPS_CANDIDATE[dim] * candidates
           + ops_within(name, *kernels) * within)
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


def path_world(name, device="cuda", **kw):
    """A fresh dam break of main path ``name`` (PATHS, or GATHER_ONE_STEP);
    ``kw`` may override its layout."""
    spec = dict(PATHS.get(name) or GATHER_ONE_STEP[name])
    kw.setdefault("layout", spec.get("layout", "auto"))
    return dam_break_world(device, spec["solver"],
                           forces=spec.get("forces", ()),
                           kernels=spec.get("kernels", ("cubic", "cubic")),
                           **kw)


def phase_main_path(pair, name):
    """Phases 2-4: main path ``name`` (PATHS) through LiquidWorld on the
    card, with the launch counts of this run alone; the step gates
    (overflow, finite positions, peak density ratio) are asserted except
    on the implicit-viscosity path, whose gates the caller reads (see
    :func:`phase_implicit_visc`). Its steps stop at the first step that
    leaves a non-finite position (the next binning would index with it).
    Returns the world and the run's record."""
    tag = f"[main {name}]"
    spec = PATHS[name]
    warm, steps = spec.get("steps", (10, 20))
    world = path_world(name)
    assert world.device.type == "cuda"
    assert world.fluids_state.positions.device.type == "cuda"
    n = int(world.fluids_state.alive.sum())
    visc = name == "dfsph_implicit_visc"
    reset_counts(pair)
    iters, visc_iters, finite, taken = [], [], True, 0
    overflows = []
    t0 = time.perf_counter()
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            refits0 = world.grid_refit_count
            t0 = time.perf_counter()
        before = force_iterations()["dfsph_viscosity"]
        world.step(DT, GRAVITY)
        taken += 1
        # Every step's overflow (one int; the solver syncs every
        # iteration anyway): recorded, its largest printed, not gated.
        overflows.append(int(world.last_diagnostics.neighbor_overflow))
        s_ = world.last_diagnostics.solver
        if i >= warm:
            iters.append((s_.pressure_iters, s_.divergence_iters))
        visc_iters.append(force_iterations()["dfsph_viscosity"] - before)
        if visc and not bool(torch.isfinite(world.fluids_state.positions[
                world.fluids_state.alive]).all()):
            finite = False
            break
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(pair)
    if taken <= warm:
        warm_s, refits0, elapsed = elapsed, world.grid_refit_count, 0.0

    d = world.last_diagnostics
    overflow = int(d.neighbor_overflow)
    max_rho = float(d.max_density_ratio)
    pos = world.fluids_state.positions[world.fluids_state.alive]
    finite = finite and bool(torch.isfinite(pos).all())
    timed = max(taken - warm, 0)
    ms = elapsed / timed * 1e3 if timed else float("nan")
    window = world._fitted_dims
    log(f"{tag} N={n}: {ms:.3f} ms/step, "
        f"{n * timed / elapsed if timed else 0.0:.6g} particle-steps/s over "
        f"{timed} timed steps ({warm} warm-up steps took {warm_s:.2f} s); "
        f"kernels (density, gradient) {world.sim.kernel_density}, "
        f"{world.sim.kernel_gradient}")
    log(f"{tag} iterations per timed step (pressure, divergence): {iters}")
    if any(visc_iters):
        log(f"{tag} DFSPH viscosity iterations per step (all steps): "
            f"{visc_iters}")
    log(f"{tag} caps {world._auto_caps}, window dims {window} "
        f"({int(np.prod(window)) if window else 'full domain'} cells), "
        f"fb table {world._fb_cols_cache}, grid refits "
        f"{world.grid_refit_count} ({world.grid_refit_count - refits0} "
        f"in the timed window)")
    worst = max(range(taken), key=overflows.__getitem__)
    log(f"{tag} last step ({taken} of {warm + steps}): overflow {overflow} "
        f"(the largest of every step's: {overflows[worst]}, at step "
        f"{worst + 1}), clamped {int(d.candidate_overflow)}, contacts ff "
        f"{int(d.ncontacts_ff)} fb {int(d.ncontacts_fb)}, max density ratio "
        f"{max_rho:.4f}, positions finite {finite}")
    log(f"{tag} overflow per step: {overflows}")
    log(f"{tag} kernel launches in this run ({taken} steps): {launches}")
    if spec.get("forces"):
        log(f"{tag} non-pressure forces: {world._force_set}")
        assert len(world._force_set.forces) == len(spec["forces"])
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    gates = {
        f"overflow {overflow} < {max(1, n // 1000)}":
            overflow < max(1, n // 1000),
        "finite positions": finite,
        f"max density ratio {max_rho} in (0.9, 2.0)": 0.9 < max_rho < 2.0,
    }
    if not visc:
        for what, ok in gates.items():
            assert ok, f"{tag} gate failed: {what}"
    return world, dict(n=n, ms=ms, launches=launches, iters=iters,
                       visc_iters=visc_iters, gates=gates, steps=taken,
                       overflows=overflows)


def phase_implicit_visc(pair, world):
    """The implicit-viscosity path's rule. ``salva_tpu`` documents the
    reference's DFSPH viscosity iteration as unstable on free blobs
    (tests/test_dense.py:110-114), and at its defaults (up to 50
    iterations) both packages diverge to non-finite values on the 7^3
    dam break on the CPU (tests/test_torch_kernel_choice_dam_break.py)
    and on the 2D field fixture (tests/test_torch_tension_forces.py). The
    path's step gates are logged; the path is held to one application of
    the force at the 97k state of ``world`` (the DFSPH main path's, past
    impact) with one viscosity update (``max_viscosity_iter=1``, the
    single application the CPU tests hold): a finite acceleration, its
    iterations and time logged."""
    from salva_tpu_torch.solver.forces_dense import DFSPHViscosityDense

    vworld, run = phase_main_path(pair, "dfsph_implicit_visc")
    del vworld
    failed = [what for what, ok in run["gates"].items() if not ok]
    ctx = step_ctx(world)
    V = ctx.V
    dt = torch.tensor(DT, dtype=torch.float32, device="cuda")
    force = DFSPHViscosityDense((0.5,), (1,), max_viscosity_iter=1)
    reset_counts(pair)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accel, fb = ctx.apply_forces((force,), world.fluids_state, V, dt,
                                 1.0 / dt, torch.zeros_like(ctx.P))
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    iters = force_iterations()["dfsph_viscosity"]
    live = ctx.maskf > 0
    a_live = accel[:, live]
    finite = bool(torch.isfinite(a_live).all())
    peak = float(a_live.abs().max()) if finite else float("nan")
    log(f"[main dfsph_implicit_visc] step gates: "
        + ", ".join(f"{w}: {'ok' if ok else 'FAILED'}"
                    for w, ok in run["gates"].items()))
    log(f"[main dfsph_implicit_visc] one application at the DFSPH path's "
        f"97k state ({int(live.sum())} live slots, max_viscosity_iter=1):"
        f" {iters} iterations, "
        f"{apply_s:.3f} s, acceleration finite {finite}, peak |a| "
        f"{peak:.6g} m/s^2")
    assert fb is None
    assert finite, "the DFSPH viscosity gave a non-finite acceleration"
    if failed:
        log(f"[main dfsph_implicit_visc] step gates failed ({failed}): "
            f"held to the single application above (the reference's "
            f"implicit viscosity is unstable on free blobs)")
    return dict(run, failed_gates=failed, apply_iters=iters,
                apply_s=apply_s, apply_peak=peak)


def busy_share(world, steps=2, step=None):
    """``torch.profiler`` over ``steps`` steps of ``world`` (``step()``,
    by default ``world.step``): (device time summed over kernels and
    fills / profiled wall clock, device ms per step); (None, None) when
    the profile came back without device events."""
    step = step or (lambda: world.step(DT, GRAVITY))
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if device_us <= 0:
        return None, None
    return device_us / 1e3 / wall_ms, device_us / 1e3 / steps


def stage_split(step, steps=2):
    """Each leaf stage of ``steps`` calls of ``step()`` on a dense world
    (binning, the fb table, boundary volumes and forces, the pair kernels,
    the unbinning, the convergence syncs, the coupling's boundary update
    and force transmission) between two ``torch.cuda.synchronize()``
    calls on the host clock, as ``tools/torch_step_profile.py`` splits a
    step. Returns ({stage: ms a step}, synchronized ms a step); the rest
    of the step is the difference."""
    import functools

    from salva_tpu_torch.coupling import device_pipeline
    from salva_tpu_torch.geometry import dense_grid as tdg
    from salva_tpu_torch.ops import binning, pair
    from salva_tpu_torch.solver import dense_common, dfsph_dense

    times, depth = {}, [0]

    def timed(label, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                torch.cuda.synchronize()
                times[label] = (times.get(label, 0.0)
                                + (time.perf_counter() - t0) * 1e3 / steps)
        return wrapper

    ctx, dev = dense_common.DenseCtx, device_pipeline.DeviceColliderCoupling
    stages = (
        (tdg, "bin_particles", "binning, full grid"),
        (tdg, "bin_particles_active", "binning, compact (boundary)"),
        (binning, "expand_many", "expand kernel"),
        (tdg, "from_grid_multi", "unbinning"),
        (pair, "hoist_ff", "hoist_ff kernel"),
        (pair, "hoist_fb", "hoist_fb kernel"),
        (dfsph_dense, "per_fluid_mean_max_grid", "convergence reductions"),
        (dfsph_dense, "_converged", "convergence host syncs"),
        (ctx, "k_pass", "k_pass kernel"),
        (ctx, "t_pass", "t_pass kernel"),
        (ctx, "boundary_forces", "boundary forces (plain fold)"),
        (ctx, "_compute_boundary_volumes", "boundary volumes (plain fold)"),
        (ctx, "_fb_table", "fb table"),
        (dev, "update_boundaries", "coupling: boundary update"),
        (dev, "transmit_forces", "coupling: force transmission"),
    )
    subs = {(mod, name): timed(label, getattr(mod, name))
            for mod, name, label in stages}
    with substituted(subs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3 / steps
    return dict(sorted(times.items(), key=lambda kv: -kv[1])), total


def step_gates(world, n):
    """The main paths' step gates on ``world``'s last step: neighbour
    overflow under N // 1000, finite positions, peak density ratio in
    (0.9, 2.0)."""
    d = world.last_diagnostics
    overflow, max_rho = int(d.neighbor_overflow), float(d.max_density_ratio)
    pos = world.fluids_state.positions[world.fluids_state.alive]
    return {
        f"overflow {overflow} < {max(1, n // 1000)}":
            overflow < max(1, n // 1000),
        "finite positions": bool(torch.isfinite(pos).all()),
        f"max density ratio {max_rho} in (0.9, 2.0)": 0.9 < max_rho < 2.0,
    }


def live_state(world):
    fl = world.fluids_state
    return fl.positions[fl.alive], fl.velocities[fl.alive]


def twin_gap(gather, dense):
    """(max |dpos|, max |dvel|) between two worlds of one scene."""
    (pg, vg), (pd, vd) = live_state(gather), live_state(dense)
    return (float((pg - pd).abs().max()), float((vg - vd).abs().max()))


def hold_custom_force(world):
    """The gather_custom path's hold: a CustomForce has no dense form, so
    ``layout="dense"`` must raise and ``"auto"`` resolve to the gather
    layout; and the force set's masked attractors, on the card at the
    path's state, must equal custom_forces3's attraction evaluated in
    float64 on the host."""
    from types import SimpleNamespace

    from salva_tpu_torch.step import _dense_config

    auto = path_world("gather_custom", layout="auto")
    auto._prepare()
    assert _dense_config(auto._effective_sim(), auto.solver_config,
                         auto._force_set) is None, "auto kept the grid"
    del auto
    dense = path_world("gather_custom", layout="dense")
    try:
        dense.step(DT, GRAVITY)
    except ValueError as e:
        log(f"[main gather_custom] layout='dense' raises: {e}")
    else:
        raise AssertionError("a CustomForce ran on the dense layout")
    del dense
    ctx = SimpleNamespace(fluids=world.fluids_state,
                          boundaries=world.boundaries_state)
    got = sum(f.apply(ctx)[0] for f in world._force_set.forces)
    pos = world.fluids_state.positions.double().cpu()
    want = torch.zeros_like(pos)
    for _, (origin,) in ATTRACTORS:
        d = torch.tensor(origin, dtype=torch.float64) - pos
        dist = d.norm(dim=-1, keepdim=True)
        want += torch.where(dist > 0.1, d / dist ** 2, 0.0)
    want = want * world.fluids_state.alive.cpu()[:, None]
    err = float((got.double().cpu() - want).abs().max())
    log(f"[main gather_custom] masked attractors vs float64: max |da| "
        f"{err:.3e} m/s^2 (peak {float(want.abs().max()):.4f})")
    assert err <= 1e-5 * max(1.0, float(want.abs().max()))


def elastic_share(world, ms_step, tag):
    """Device time of the elasticity's ``apply_particles`` and of its
    batched SVD (``torch.linalg.svd`` of the [N, 3, 3] APQ matrices) at
    the state of ``world``, beside the path's ms/step."""
    from salva_tpu_torch.solver import elasticity

    force = next(f for f in world._force_set.forces
                 if isinstance(f, elasticity.Becker2009ElasticityForce))
    fl, es = world.fluids_state, world._elasticity_state
    apply_ms = cuda_ms(lambda: force.apply_particles(fl, es, 3), 5)
    j, mask = es.rest_j, es.rest_mask
    p_ji = fl.positions[j] - fl.positions[:, None, :]
    p0_ji = es.positions0[j] - es.positions0[:, None, :]
    a_pq = torch.einsum("nk,nkd,nke->nde", es.rest_w * fl.masses[j] * mask,
                        p_ji, p0_ji)
    svd_ms = cuda_ms(lambda: torch.linalg.svd(a_pq, full_matrices=False), 5)
    polar_ms = cuda_ms(lambda: elasticity._polar_rotation(a_pq, 3), 5)
    log(f"{tag} elasticity at this state ({int(es.rest_valid.any(1).sum())}"
        f" elastic particles): apply_particles {apply_ms:.3f} ms, of which "
        f"the polar decomposition {polar_ms:.3f} ms (its SVD {svd_ms:.3f} "
        f"ms); the path's step {ms_step:.3f} ms")
    return dict(apply_ms=apply_ms, polar_ms=polar_ms, svd_ms=svd_ms)


def gather_stages(world, tag):
    """Device time of the gather layout's plain-torch passes at the state
    of ``world`` (the next step's inputs): the Morton grid and the ff and
    fb neighbour tables, the boundary volumes' W sums, the contacts'
    kernel evaluation, the boundary-force scatter (its table and one
    scatter), and one DFSPH pressure iteration (the predicted densities
    and the stiffness's velocity update)."""
    from salva_tpu_torch import geometry as g
    from salva_tpu_torch.kernels import get_kernel
    from salva_tpu_torch.solver import common, dfsph

    fl, bd = world.fluids_state, world.boundaries_state
    h, nb = world.h, world.sim.neighbors
    w_fn, dw_fn = get_kernel("cubic")
    fgr, bgr = fl.groups(), bd.groups()

    def grid_ff():
        grid = g.build_grid(fl.positions, fl.alive, h, 3)
        return g.find_neighbors(fl.positions, fl.alive, fgr, grid,
                                fl.positions, fl.alive, fgr, h, 3,
                                nb.max_neighbors, nb.max_candidates, True,
                                nb.query_chunk)

    def grid_fb():
        grid = g.build_grid(bd.positions, bd.alive, h, 3)
        return g.find_neighbors(fl.positions, fl.alive, fgr, grid,
                                bd.positions, bd.alive, bgr, h, 3,
                                nb.max_neighbors, nb.max_candidates, False,
                                nb.query_chunk)

    def volumes():
        grid = g.build_grid(bd.positions, bd.alive, h, 3)
        return g.weighted_sum_over_neighbors(
            bd.positions, bd.alive, bgr, grid, bd.positions, bd.alive, bgr,
            h, 3, nb.max_candidates, True, w_fn, nb.query_chunk)

    ff_nl, fb_nl = grid_ff(), grid_fb()

    def contacts():
        return (g.evaluate_contacts(fl.positions, fl.positions, ff_nl, h, 3,
                                    w_fn, dw_fn),
                g.evaluate_contacts(fl.positions, bd.positions, fb_nl, h, 3,
                                    w_fn, dw_fn))

    ff, fb = contacts()
    dt = torch.tensor(DT, dtype=torch.float32, device="cuda")
    ctx = common.StepContext(fluids=fl, boundaries=bd, ff=ff, fb=fb,
                             densities=torch.zeros_like(fl.volumes), dt=dt,
                             inv_dt=1.0 / dt, dim=3, h=h, num_fluids=1)
    ctx = ctx.replace(densities=common.compute_densities(ctx))
    alphas = dfsph.compute_alphas(ctx)
    dv = torch.zeros_like(fl.positions)
    contrib = fb.grad * fb.mask[..., None]

    def scatter():
        fb._table = None
        return common.scatter_boundary_forces(bd.forces, fb, contrib)

    def pressure_iteration():
        predicted, _ = dfsph.compute_predicted_densities(ctx, dv)
        ki = torch.clamp((predicted - fl.density0) * alphas, min=0.0)
        return dfsph._apply_pressure_kappa(ctx, dv, ki)

    times = {name: cuda_ms(fn, 3) for name, fn in (
        ("grid + ff table", grid_ff), ("grid + fb table", grid_fb),
        ("boundary volumes", volumes), ("contacts (ff, fb)", contacts),
        ("fb scatter (table + one)", scatter),
        ("one pressure iteration", pressure_iteration))}
    log(f"{tag} gather stages at this state, device ms (3 runs each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; fb scatter table kmax {fb.scatter_table(bd.capacity).shape[1]}")
    return times


def phase_gather_path(pair, name, rerun=False):
    """A gather-layout main path (PATHS, ``layout="gather"``) on bench.py's
    dam break. Its dense twin (the same world on the dense layout, whose
    hand kernels run; gather_custom has none, see hold_custom_force) takes
    the first step beside it, held to identical iterations and ff
    contacts and to TWIN_POS_ATOL / TWIN_VEL_ATOL, and follows it step
    for step, the gap after the last step logged. The gather world runs
    its warm-up and timed steps, two profiled steps (the device's busy
    share) and its step gates; it launches no pair kernel, and ``expand``
    only in its first step (the world's one-time full-extent boundary
    volume pass over a domain, as the JAX world runs it). With ``rerun``,
    a second fresh world takes the same steps and must end bitwise
    equal. Returns the run's record."""
    tag = f"[main {name}]"
    spec = PATHS[name]
    warm, steps = spec["steps"]
    total = 1 + warm + steps + 2
    world = path_world(name)
    twin = None if name == "gather_custom" else path_world(name,
                                                           layout="dense")
    n = int(world.fluids_state.alive.sum())
    if twin is not None:
        twin.step(DT, GRAVITY)
    reset_counts(pair)
    world.step(DT, GRAVITY)
    torch.cuda.synchronize()
    first_launches = read_counts(pair)
    gap1 = None
    if twin is not None:
        seen = [((w.last_diagnostics.solver.pressure_iters,
                  w.last_diagnostics.solver.divergence_iters),
                 int(w.last_diagnostics.ncontacts_ff)) for w in (world, twin)]
        gap1 = twin_gap(world, twin)
        log(f"{tag} step 1, gather vs dense twin: iterations {seen[0][0]} / "
            f"{seen[1][0]}, ff contacts {seen[0][1]} / {seen[1][1]}, max "
            f"|dpos| {gap1[0]:.3e} m (atol {TWIN_POS_ATOL}), max |dvel| "
            f"{gap1[1]:.3e} m/s (atol {TWIN_VEL_ATOL})")
        assert seen[0] == seen[1], f"{tag} twin iterations / ff contacts"
        assert gap1[0] <= TWIN_POS_ATOL and gap1[1] <= TWIN_VEL_ATOL, \
            f"{tag} dense twin gap {gap1}"
    iters = []
    t0 = time.perf_counter()
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        world.step(DT, GRAVITY)
        s_ = world.last_diagnostics.solver
        if i >= warm:
            iters.append((s_.pressure_iters, s_.divergence_iters))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    busy, device_ms = busy_share(world)
    launches = read_counts(pair)
    gates = step_gates(world, n)
    d = world.last_diagnostics
    log(f"{tag} N={n}: {ms:.3f} ms/step over {steps} timed steps ({warm} "
        f"warm-up steps took {warm_s:.2f} s); device busy share "
        f"{busy if busy is None else round(busy, 4)} over 2 profiled steps "
        f"({device_ms if device_ms is None else round(device_ms, 3)} ms of "
        f"device time a step); kernels (density, gradient) "
        f"{world.sim.kernel_density}, {world.sim.kernel_gradient}")
    log(f"{tag} iterations per timed step (pressure, divergence): {iters}")
    log(f"{tag} last step ({total}): overflow {int(d.neighbor_overflow)}, "
        f"candidate overflow {int(d.candidate_overflow)}, contacts ff "
        f"{int(d.ncontacts_ff)} fb {int(d.ncontacts_fb)}, max density ratio "
        f"{float(d.max_density_ratio):.4f}; forces {world._force_set}")
    log(f"{tag} kernel launches ({total} steps; step 1: {first_launches}): "
        f"{launches}")
    assert launches == first_launches, f"{tag} a step after the first " \
        "launched a kernel"
    assert not any(v for k, v in launches.items() if k != "expand"), \
        f"{tag} launched a pair kernel"
    for what, ok in gates.items():
        assert ok, f"{tag} gate failed: {what}"
    gap = None
    if twin is not None:
        for _ in range(total - 1):
            twin.step(DT, GRAVITY)
        gap = twin_gap(world, twin)
        log(f"{tag} after step {total}, gather vs dense twin: max |dpos| "
            f"{gap[0]:.3e} m, max |dvel| {gap[1]:.3e} m/s (logged only)")
        del twin
    if name == "gather_custom":
        hold_custom_force(world)
    extra = {}
    if spec.get("forces") == ELASTIC:
        extra = elastic_share(world, ms, tag)
    if name == "gather_dfsph":
        extra = dict(stages=gather_stages(world, tag))
    if rerun:
        again = path_world(name)
        for _ in range(total):
            again.step(DT, GRAVITY)
        same = torch.equal(world.fluids_state.positions,
                           again.fluids_state.positions)
        log(f"{tag} a second run of the {total} steps: positions bitwise "
            f"equal {same}")
        assert same, f"{tag} two runs differ"
        del again
    torch.cuda.empty_cache()
    return dict(n=n, ms=ms, launches=launches, iters=iters,
                twin_gap_step1=gap1, twin_gap_last=gap, busy=busy,
                device_ms=device_ms, **extra)


def phase_gather_short(pair, name):
    """A remaining force on the gather layout (GATHER_ONE_STEP):
    GATHER_SHORT_STEPS steps, finite after each, through the step gates,
    no pair kernel launched."""
    tag = f"[short {name}]"
    world = path_world(name)
    n = int(world.fluids_state.alive.sum())
    reset_counts(pair)
    iters = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GATHER_SHORT_STEPS):
        world.step(DT, GRAVITY)
        s_ = world.last_diagnostics.solver
        iters.append((s_.pressure_iters, s_.divergence_iters))
        assert bool(torch.isfinite(world.fluids_state.positions).all()), \
            f"{tag} non-finite positions at step {len(iters)}"
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / GATHER_SHORT_STEPS * 1e3
    gates = step_gates(world, n)
    launches = read_counts(pair)
    log(f"{tag} N={n}: {ms:.3f} ms/step over {GATHER_SHORT_STEPS} steps "
        f"(the first included), iterations {iters}, DFSPH viscosity "
        f"iterations {force_iterations()['dfsph_viscosity']}, kernels "
        f"(density, gradient) {world.sim.kernel_density}, "
        f"{world.sim.kernel_gradient}; launches {launches}; gates "
        + ", ".join(f"{w}: {'ok' if ok else 'FAILED'}"
                    for w, ok in gates.items()))
    assert not any(v for k, v in launches.items() if k != "expand"), \
        f"{tag} launched a pair kernel"
    for what, ok in gates.items():
        assert ok, f"{tag} gate failed: {what}"
    del world
    torch.cuda.empty_cache()
    return dict(n=n, ms=ms, iters=iters, launches=launches)


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


def hold_outputs(name, label, kern, plain, tol, counts_ref=None):
    """Hold ``kern()`` to ``plain()`` output by output (pair counts
    exact, and equal to ``counts_ref``, the cubic run's, where given: the
    count's rule does not depend on the kernel), with a bitwise rerun.
    Returns (outputs, max abs err)."""
    out, ref = as_tuple(kern()), as_tuple(plain())
    for a, b in zip(out, as_tuple(kern())):
        assert torch.equal(a, b), f"{label}: not bitwise deterministic"
    names = OUTPUTS[name]
    if len(out) > len(names):
        assert torch.equal(out[-1], ref[-1]), f"{label}: pair counts differ"
        if counts_ref is not None:
            assert torch.equal(out[-1], counts_ref), \
                f"{label}: pair counts differ from the cubic kernel's"
    errs = {}
    for i, o in enumerate(names):
        if o == "s2" and not bool((ref[i] != 0).any()):
            assert not bool((out[i] != 0).any()), f"{label}: s2 not zero"
            continue
        errs[o] = check_output(f"{label}.{o}", out[i], ref[i], tol)[0]
    log(f"[kernels] {label}: max abs err " + ", ".join(
        f"{o} {e:.4e}" for o, e in errs.items()) + f" (tol {tol})"
        + ("; pair counts exact" if len(out) > len(names) else ""))
    return out, max(errs.values())


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


def k_pass_v2_check(pair, results, spec, h, dim, P, M, K, counts, n_live,
                    C, n_eval, plain_k):
    """Phase 5's k_pass_v2 check (no main path runs it): held to k_pass's
    plain version with its planted group fault, timed; its record goes in
    ``results``. Returns its planted fault (short counts, copy_back)."""
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
    out, err = hold_kernel("k_pass_v2", "k_pass_v2", kern_v2, plain_k,
                           KT_TOL, copy_v2)
    ms = cuda_ms(lambda: kern_v2(False), 50)
    one = call_ms(lambda: kern_v2(False), 20)
    check_launches = read_counts(pair)["k_pass_v2"]
    plain_ms = cuda_ms(plain_k, 10)
    results["k_pass_v2"] = dict(max_abs_err=err, ms=ms, call_ms=one,
                                plain_ms=plain_ms,
                                check_launches=check_launches,
                                read=live_bytes([P, M, K], n_live) + 4 * C,
                                written=nbytes(out))
    log(f"[kernels] k_pass_v2: kernel {ms:.4f} ms device time ({one:.4f} ms "
        f"a call; k_pass {results['k_pass']['ms']:.4f} ms), plain "
        f"{plain_ms:.4f} ms; {n_eval / ms / 1e6:.4g} G candidate pairs/s; "
        f"{check_launches} launches in this check and its timing")
    return short_v2, copy_v2


def phase_kernels(pair, world, full=True):
    """Phase 5: each kernel vs its plain version at the state of the
    DFSPH main path's world after its 30 steps (the shapes the main path
    gives it). ``full=False`` (the 2D twin's state): the cubic checks of
    k_pass, t_pass, both hoists and expand only (no k_pass_v2, no other
    SPH kernel names)."""
    from salva_tpu_torch.geometry import dense_grid as tdg

    ctx = step_ctx(world)
    spec, h, dim, counts = ctx.spec_f, ctx.h, ctx.dim, ctx.counts
    C = spec.num_cells
    occ = int(counts.max())
    n_live = int(counts.sum())
    log(f"[kernels] state of {dim}D world: window dims {spec.dims} "
        f"({C} cells), cap {spec.cap}, max cell occupancy {occ}, live "
        f"slots {n_live} of {spec.cap * C}")
    if full:
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
    # K of the size the solver feeds k_pass (a stiffness over the rest
    # density): 1e-6 rho at the dam break's rest density of 1,000; scaled
    # to 1 at its peak in basic2 (rest density 1), where 1e-6 rho would
    # put k_pass's output under the tolerance's floor.
    K = (ctx.rho * (1e-6 if full else 1.0 / float(ctx.rho.max()))
         * ctx.maskf).contiguous()
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
            log(f"[kernels] hoist_ff: {ms0:.4f} ms device time without s2 "
                f"(the DFSPH setting)")
            if full:
                # A call's launches do not depend on dim; after earlier
                # profiler sessions a profile of one call may come back
                # without device events (ROADMAP Queue 3, item 12).
                n_dev = device_launches(lambda: kern(False))
                log(f"[kernels] hoist_ff: {n_dev} device launch(es) a call")
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
    if full:
        short_v2, copy_v2 = k_pass_v2_check(pair, results, spec, h, dim, P,
                                            M, K, counts, n_live, C, n_eval,
                                            ff["k_pass"][1])
    for name in results:
        r = results[name]
        read, written = r.pop("read"), r.pop("written")
        r["read_bytes"], r["written"] = read, written
        r["bound_ms"], r["bound_by"], ops = bound(name, dim, read, written,
                                                  n_eval, ff_within)
        log(f"[kernels] {name}: bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}; {read} B read, {written} B written; "
            f"{ops:.4g} float32 operations over {n_eval} candidate / "
            f"{ff_within} within-h pairs); kernel / bound "
            f"{r['ms'] / r['bound_ms']:.1f}")

    # Every SPH kernel name (KERNEL_NAMES): k_pass, t_pass and k_pass_v2
    # under each non-cubic gradient kernel, hoist_ff (with and without s2)
    # under the non-cubic HOIST_PAIRS. The planted faults run on the
    # poly6 / spiky instantiations (the non-cubic main paths'). Bounds
    # count each kernel's own float32 operations (ops_within).
    passes = {"k_pass": (K, pair.k_pass_plain, short_k, copy_k),
              "t_pass": (Q, pair.t_pass_plain, short_t, copy_t)}
    if full:
        passes["k_pass_v2"] = (K, pair.k_pass_plain, short_v2, copy_v2)
    by_kernel = {name: {} for name in
                 ("k_pass", "t_pass", "k_pass_v2", "hoist_ff", "hoist_fb")
                 if name in results or name == "hoist_fb"}
    rw = {name: (results[name]["read_bytes"], results[name]["written"])
          for name in ("k_pass", "t_pass", "k_pass_v2", "hoist_ff")
          if name in results}
    for name in passes:
        r = results[name]
        by_kernel[name]["cubic"] = {k: r[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    for kg in (KERNEL_NAMES[1:] if full else ()):
        for name, (X, plain_fn, short, copy) in passes.items():
            def kern(f=False, name=name, X=X, short=short, kg=kg):
                return getattr(pair, name)(spec, h, dim, kg, P, M, X,
                                           short if f else counts)

            def plain(plain_fn=plain_fn, X=X, kg=kg):
                return plain_fn(spec, h, dim, kg, P, M, X, counts)

            label = f"{name} ({kg})"
            if kg == "spiky":
                out, err = hold_kernel(name, label, kern, plain, KT_TOL,
                                       copy)
            else:
                out, err = hold_outputs(name, label, kern, plain, KT_TOL)
            ms = cuda_ms(kern, 50)
            plain_ms = cuda_ms(plain, 5)
            b_ms, b_by, ops = bound(name, dim, *rw[name], n_eval, ff_within,
                                    (kg, kg))
            by_kernel[name][kg] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by)
            log(f"[kernels] {label}: kernel {ms:.4f} ms device time (cubic "
                f"{results[name]['ms']:.4f}), plain {plain_ms:.4f} ms; bound "
                f"{b_ms:.5f} ms ({b_by}, {ops:.4g} float32 operations); "
                f"kernel / bound {ms / b_ms:.1f}")
    by_kernel["hoist_ff"]["cubic/cubic"] = {k: results["hoist_ff"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    cnt_cubic = pair.hoist_ff(spec, h, dim, "cubic", "cubic", P, M,
                              counts)[-1]
    for kd, kg in (HOIST_PAIRS[1:] if full else ()):
        def kern(f=False, s2=True, kd=kd, kg=kg):
            return pair.hoist_ff(spec, h, dim, kd, kg, P, M,
                                 short_ff if f else counts, need_s2=s2)

        def plain(s2=True, kd=kd, kg=kg):
            return pair.hoist_ff_plain(spec, h, dim, kd, kg, P, M, counts,
                                       need_s2=s2)

        label = f"hoist_ff ({kd}/{kg})"
        if (kd, kg) == ("poly6", "spiky"):
            out, err = hold_kernel("hoist_ff", label, kern, plain,
                                   HOIST_TOL, copy_ff)
            assert torch.equal(out[-1], cnt_cubic)
        else:
            out, err = hold_outputs("hoist_ff", label, kern, plain,
                                    HOIST_TOL, cnt_cubic)
        err = max(err, hold_outputs(
            "hoist_ff", f"{label} (need_s2=False)", lambda: kern(s2=False),
            lambda: plain(s2=False), HOIST_TOL, cnt_cubic)[1])
        ms = cuda_ms(kern, 50)
        ms0 = cuda_ms(lambda: kern(s2=False), 50)
        plain_ms = cuda_ms(plain, 5)
        b_ms, b_by, ops = bound("hoist_ff", dim, *rw["hoist_ff"], n_eval,
                                ff_within, (kd, kg))
        by_kernel["hoist_ff"][f"{kd}/{kg}"] = dict(
            max_abs_err=err, ms=ms, ms_without_s2=ms0, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by)
        log(f"[kernels] {label}: kernel {ms:.4f} ms device time with s2, "
            f"{ms0:.4f} without (cubic {results['hoist_ff']['ms']:.4f}), "
            f"plain {plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}, "
            f"{ops:.4g} float32 operations); kernel / bound "
            f"{ms / b_ms:.1f}")

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
        n_dev = device_launches(lambda: kern(False)) if full else None
        log(f"[kernels] hoist_fb ({layout}): {n_dev} device launches a "
            f"call (None: counted at dim 3 only); the zero fill alone "
            f"{fill_ms:.4f} ms device time")
        assert not full or 1 <= n_dev <= 2, \
            f"hoist_fb: {n_dev} launches a call"
        b_ms, b_by, ops = bound("hoist_fb", dim, read, written, cand, within)
        fb[layout] = dict(max_abs_err=err, ms=ms, call_ms=one,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          fill_ms=fill_ms, launches_per_call=n_dev)
        cnt_cubic = out[-1]
        for kd, kg in (HOIST_PAIRS[1:] if full else ()):
            nc = (spec, h, dim, kd, kg) + args[5:]

            def kern_nc(f=False, s2=True, nc=nc, kw=kw, cb=c.counts_b,
                        short_b=short_b):
                return pair.hoist_fb(*nc, short_b if f else cb,
                                     **dict(kw, need_s2=s2))

            def plain_nc(s2=True, nc=nc, kw=kw, cb=c.counts_b):
                return pair.hoist_fb_plain(*nc, cb, **dict(kw, need_s2=s2))

            label = f"hoist_fb ({layout}, {kd}/{kg})"
            if (kd, kg) == ("poly6", "spiky") and layout == "sparse":
                o_nc, e_nc = hold_kernel("hoist_fb", label, kern_nc,
                                         plain_nc, HOIST_TOL)
                assert torch.equal(o_nc[-1], cnt_cubic)
            else:
                o_nc, e_nc = hold_outputs("hoist_fb", label, kern_nc,
                                          plain_nc, HOIST_TOL, cnt_cubic)
            e_nc = max(e_nc, hold_outputs(
                "hoist_fb", f"{label} (need_s2=False)",
                lambda: kern_nc(s2=False), lambda: plain_nc(s2=False),
                HOIST_TOL, cnt_cubic)[1])
            ms_nc = cuda_ms(kern_nc, 50)
            plain_nc_ms = cuda_ms(plain_nc, 5)
            b_nc, by_nc, ops_nc = bound("hoist_fb", dim, read, written,
                                        cand, within, (kd, kg))
            by_kernel["hoist_fb"].setdefault(f"{kd}/{kg}", {})[layout] = dict(
                max_abs_err=e_nc, ms=ms_nc, plain_ms=plain_nc_ms,
                bound_ms=b_nc, bound_by=by_nc)
            log(f"[kernels] {label}: kernel {ms_nc:.4f} ms device time "
                f"(cubic {ms:.4f}), plain {plain_nc_ms:.4f} ms; bound "
                f"{b_nc:.5f} ms ({by_nc}, {ops_nc:.4g} float32 operations);"
                f" kernel / bound {ms_nc / b_nc:.1f}")
        log(f"[kernels] hoist_fb ({layout}): kernel {ms:.4f} ms device time "
            f"({one:.4f} ms a call), plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms ({b_by}; {read} B read: {n_pf} fluid slots, "
            f"{n_pb} boundary slots, {n_wb} of them within h, {idx} B of "
            f"index entries; {written} B written; {ops:.4g} float32 "
            f"operations over {cand} candidate / {within} within-h "
            f"pairs); kernel / bound {ms / b_ms:.1f}")
    # The main path runs the sparse layout: its numbers go in the record.
    by_kernel["hoist_fb"]["cubic/cubic"] = {
        layout: {k: fb[layout][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
        for layout in fb}
    results["hoist_fb"] = dict(
        fb["sparse"],
        max_abs_err=max([fb["sparse"]["max_abs_err"],
                         fb["full"]["max_abs_err"]]
                        + [r["max_abs_err"]
                           for pk in by_kernel["hoist_fb"].values()
                           for r in pk.values()]),
        full_grid=fb["full"],
    )
    for name, rec in by_kernel.items():
        results[name]["by_kernel"] = rec
        results[name]["kernel_names"] = sorted(
            {k for pk in rec for k in pk.split("/")},
            key=KERNEL_NAMES.index)
        if name != "hoist_fb":
            results[name]["max_abs_err"] = max(
                r["max_abs_err"] for r in rec.values())
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
    ``expand_plain`` on the fluid binning (the positions and velocities),
    on the compact boundary binning (positions, velocities, volumes), and
    on both in one launch (``expand_many``, the call a substep makes), at
    the world's state. Exact equality (it moves data only), a bitwise
    rerun, and two planted faults that must break it: a column's start
    off by one, and one row dropped from a column's count. The library
    call: the JAX package's packed row gather ``packed[grid_src]``
    (:func:`gather`, ``grid_src`` made once beforehand), one per binning.
    Bound: bytes (the live slots' channels and sort-order entry read once,
    the run table read once, the output planes written once). Returns the
    two-binning call's record, with the single binnings' under ``fluid``
    and ``boundary``."""
    from salva_tpu_torch.geometry import dense_grid as tdg
    from salva_tpu_torch.ops import binning

    fl, bd = world.fluids_state, world.boundaries_state
    calls = {
        "fluid": [(ctx.binf, [(fl.positions, tdg.POS_SENTINEL),
                              (fl.velocities, 0.0)])],
        "boundary": [(ctx.binb, [(bd.positions, tdg.POS_SENTINEL),
                                 (bd.velocities, 0.0), (bd.volumes, 0.0)])],
    }
    calls["fused"] = calls["fluid"] + calls["boundary"]
    rec = {}
    for label, call in calls.items():
        srcs = [slot_sources(binned) for binned, _ in call]
        out = binning.expand_many(call)
        ref = binning.expand_many_plain(call)
        again = binning.expand_many(call)
        err = 0.0
        read = written = 0
        for (binned, items), src, o_t, r_t, a_t in zip(call, srcs, out, ref,
                                                       again):
            err = max([err] + [float((o - r).abs().max())
                               for o, r in zip(o_t, r_t)])
            for o, r, a in zip(o_t, r_t, a_t):
                assert torch.equal(o, r), f"expand ({label}) differs from plain"
                assert torch.equal(o, a), f"expand ({label}): not deterministic"
            for o, g in zip(o_t, gather(src, items)):
                assert torch.equal(o, g), \
                    f"expand ({label}) differs from gather"
            cap, C = binned.mask.shape
            nch = sum(1 if v.ndim == 1 else v.shape[1] for v, _ in items)
            n_live = int(torch.clamp(binned.count, max=cap).sum())
            read += n_live * 4 * (nch + 1) + 8 * C
            written += 4 * nch * cap * C
        # Planted faults, in the last binning's column with the most rows
        # up to the cap (a row dropped past the cap would change nothing).
        binned, items = call[-1]
        cap = binned.mask.shape[0]
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
            wrong = binning.expand_many(call[:-1] + [(bad, items)])[-1]
            assert not all(torch.equal(w, r) for w, r in zip(wrong, ref[-1])), \
                f"planted fault {fault} passed"
            log(f"[kernels] expand ({label}): planted fault '{fault}' in "
                f"column {col} ({int(cnt[col])} rows) caught")
        b_ms = (read + written) / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: binning.expand_many(call), 50)
        one = call_ms(lambda: binning.expand_many(call), 20)
        plain_ms = cuda_ms(lambda: binning.expand_many_plain(call), 10)
        lib_ms = cuda_ms(lambda: [gather(src, items) for src, (_, items)
                                  in zip(srcs, call)], 20)
        rec[label] = dict(max_abs_err=err, ms=ms, call_ms=one,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by="bytes")
        shapes = ", ".join(f"{tuple(b.mask.shape)}" for b, _ in call)
        log(f"[kernels] expand ({label}): {len(call)} binning(s) {shapes} in "
            f"one launch; equal to plain and to the gather bitwise (max abs "
            f"err {err}); kernel {ms:.4f} ms device time ({one:.4f} ms a "
            f"call), plain {plain_ms:.4f} ms, library (packed gather) "
            f"{lib_ms:.4f} ms; bound {b_ms:.5f} ms (bytes; {read} B read, "
            f"{written} B written); kernel / bound {ms / b_ms:.1f}")
    return dict(rec["fused"], fluid=rec["fluid"], boundary=rec["boundary"])


def run_steps(name, steps=5, sparse_boundary=True):
    """A fresh dam break of main path ``name`` stepped ``steps`` times:
    (iterations per step, live positions, last diagnostics)."""
    world = path_world(name, sparse_boundary=sparse_boundary)
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


def phase_path_parity(pair, name):
    """Phase 6: main path ``name`` stepped 5 times through the kernels vs
    5 times through the plain versions (substituted for the wrappers
    here, in the script: the pair passes' ``*_plain`` and the binning's
    ``expand_plain``). Returns the kernel run."""
    from salva_tpu_torch.ops import binning

    tag = f"[parity {name}]"
    solver = PATHS[name]["solver"]
    names = ("k_pass", "t_pass", "hoist_ff", "hoist_fb")
    t0 = time.perf_counter()
    kernel_run = run_steps(name)
    it_k, pos_k, _ = kernel_run
    subs = {(pair, n): getattr(pair, n + "_plain") for n in names}
    subs[(binning, "expand_many")] = binning.expand_many_plain
    reset_counts(pair)
    with substituted(subs):
        it_p, pos_p, _ = run_steps(name)
    assert not any(read_counts(pair).values()), "the plain run launched"
    dpos = float((pos_k - pos_p).abs().max())
    log(f"{tag} iterations kernels {it_k} vs plain {it_p}; "
        f"max |dpos| {dpos:.3e} m (atol {PATH_POS_ATOL[solver]}); "
        f"{time.perf_counter() - t0:.1f} s")
    assert it_k == it_p, "iteration counts differ between kernels and plain"
    assert dpos <= PATH_POS_ATOL[solver], f"positions differ by {dpos}"
    return kernel_run


def phase_expand_vs_gather(pair, kernel_run):
    """Phase 6: the DFSPH path with the JAX package's packed row gather
    (:func:`gather` through :func:`slot_sources`) substituted for the
    ``expand`` kernel: bitwise equal positions after 5 steps."""
    from salva_tpu_torch.ops import binning

    def by_gather(calls):
        return [gather(slot_sources(binned), items) for binned, items in calls]

    reset_counts(pair)
    with substituted({(binning, "expand_many"): by_gather}):
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


def layout_clone(base, name):
    """A copy of the world ``base`` (its state and host-side layout state)
    switched to layout ``name`` of LAYOUTS."""
    w = copy.deepcopy(base)
    flags = dict(LAYOUTS[name])
    if flags.pop("spill_at_cap", None):
        # dense_cap 12 with the spill table the auto tier would size.
        w._dense_cap_request = 12
        flags.update(dense_cap=12,
                     dense_spill_columns=w._sized_spill_columns(12))
    if flags.pop("spill_full", None):
        w._dense_cap_request = 8
        flags.update(dense_cap=8,
                     dense_spill_columns=w._sized_spill_columns(8),
                     dense_spill_k=3 ** w.dim)
    if flags.get("dense_spill_auto"):
        w._auto_caps = None  # the tier resolves again from this state
    w.sim = w.sim.replace(**flags)
    return w


def plain_versions_refused(pair):
    """A context in which every kernel wrapper's plain version (the pair
    passes', ``expand``'s) raises if called. On CUDA tensors the wrappers
    launch their kernels, so a call would mean that a layout's fold ran a
    plain version on the card."""
    from salva_tpu_torch.ops import binning

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran during layouts_97k")
        return fn

    names = [(pair, n + "_plain")
             for n in ("k_pass", "t_pass", "hoist_ff", "hoist_fb")]
    names += [(binning, "expand_plain"), (binning, "expand_many_plain")]
    return substituted({k: refuse(k[1]) for k in names})


def layout_details(world):
    """The frozen store's bytes and the spill tables of the world's next
    step (a DenseCtx as the step builds it), and ``expand`` on its two
    binnings (the compact tables, the spill columns' extended run table)
    against their plain expansion, bitwise, with its device time."""
    from salva_tpu_torch.geometry.dense_grid import POS_SENTINEL
    from salva_tpu_torch.ops import binning

    ctx = step_ctx(world)
    out = dict(cap=ctx.spec_f.cap, cells=ctx.spec_f.num_cells,
               columns=ctx.maskf.shape[-1])
    fl, bd = world.fluids_state, world.boundaries_state
    call = [(ctx.binf, [(fl.positions, POS_SENTINEL), (fl.velocities, 0.0)]),
            (ctx.binb, [(bd.positions, POS_SENTINEL), (bd.velocities, 0.0)])]
    got, want = binning.expand_many(call), binning.expand_many_plain(call)
    out["expand_bitwise"] = all(
        torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    out["expand_ms"] = cuda_ms(lambda: binning.expand_many(call), 20)
    assert out["expand_bitwise"], "expand differs from its plain expansion"
    if ctx.frozen:
        out["frozen_bytes"] = nbytes(ctx.S)
        out["frozen_blocks"] = len(ctx.S)
    if ctx.spill_E:
        C = ctx.spec_f.num_cells
        out.update(
            E=ctx.spill_E, AADJ=int(ctx._adj_cols.shape[0]),
            K=int(ctx._adj_sp_nb.shape[1]),
            spilled_cells=int((ctx.binf.spill_cells < C).sum()),
            spilled_particles=int(ctx.maskf[:, C:].sum()),
            adjacent_columns=int(ctx._adj_got.sum()),
            spill_overflow=int(ctx.spill_overflow),
        )
    if ctx.compact:
        out.update(active_f=ctx.sf.num_cells - 1,
                   active_b=ctx.sb.num_cells - 1,
                   occupied_f=int((ctx.binf.active_cells
                                   < ctx.spec_f.num_cells).sum()))
    del ctx
    torch.cuda.empty_cache()
    return out


def one_step_record(world):
    d = world.last_diagnostics
    s = world.last_diagnostics.solver
    return dict(pos=live_positions(world).clone(),
                iters=(s.pressure_iters, s.divergence_iters),
                ff=int(d.ncontacts_ff), fb=int(d.ncontacts_fb),
                overflow=int(d.neighbor_overflow),
                spill_overflow=int(d.spill_overflow),
                clamped=int(d.candidate_overflow))


def phase_layouts_97k(pair):
    """layouts_97k: the three remaining dense layouts on the DFSPH dam
    break (``path_world("dfsph")``: 97,336 particles, auto caps, the fitted
    window), each from one shared state after LAYOUTS_AT steps (past
    impact) beside the kernel twin (the same state stepped on the default
    grid): one step held to the twin (LAYOUT_POS_ATOL; identical
    iterations where LAYOUT_SAME_ITERS says so; exact contact counts),
    then LAYOUT_STEPS steps (the held step the first) with the neighbour
    and spill overflow 0 at every step (the spill layout runs on to
    LAYOUT_STEPS_SPILL steps, its overflow past LAYOUT_STEPS logged, not
    gated) and finite positions, a bitwise rerun of the first two,
    ms/step, the device time and busy share of one profiled step, and the
    hand kernels' launches of those steps; the frozen store's bytes, the
    spill tables and, on the spill layouts, the cells past the cap in the
    shared state (the held step's spilled cells) and after each step (the
    host's count); ``expand`` on the layout's binnings against its plain
    expansion (bitwise). spill8_97k (cap 8 + 8 spill rows, the twin's 16
    slots a cell) runs SPILL8_STEPS steps and must spill in its held step.
    The auto tier (``spill_auto_97k``) must resolve to 12 + the same table
    and step bitwise as spill_97k for SPILL_AUTO_STEPS steps. Every kernel
    wrapper's plain version is refused meanwhile.
    Returns ({path: launches}, summary)."""
    tag = "[layouts_97k]"
    base = path_world("dfsph")
    for _ in range(LAYOUTS_AT):
        base.step(DT, GRAVITY)
    n = int(base.fluids_state.alive.sum())
    twin = copy.deepcopy(base)
    reset_counts(pair)
    twin.step(DT, GRAVITY)
    twin_launches = read_counts(pair)
    ref = one_step_record(twin)
    del twin
    log(f"{tag} shared state: {n} particles after {LAYOUTS_AT} steps, caps "
        f"{base._auto_caps}, window {base._fitted_dims}; the kernel twin's "
        f"step: iterations {ref['iters']}, contacts ff {ref['ff']} fb "
        f"{ref['fb']}, overflow {ref['overflow']}, launches {twin_launches}")
    counts0 = base._cell_counts(base.fluids_state.positions,
                                base.fluids_state.alive)
    paths, summary, first_two = {}, {}, {}
    for name in LAYOUTS:
        t_phase = time.perf_counter()
        spill = "spill" in name
        steps = {"spill_97k": LAYOUT_STEPS_SPILL,
                 "spill8_97k": SPILL8_STEPS,
                 "spill_auto_97k": SPILL_AUTO_STEPS}.get(name, LAYOUT_STEPS)
        w = layout_clone(base, name)
        cap = w._effective_sim().dense_cap
        reset_counts(pair)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs, over_cap = [], []
        with plain_versions_refused(pair):
            for _ in range(steps):
                w.step(DT, GRAVITY)
                recs.append(one_step_record(w))
                if spill:
                    counts = w._cell_counts(w.fluids_state.positions,
                                            w.fluids_state.alive)
                    over_cap.append(int((counts > cap).sum()))
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        launches = read_counts(pair)
        paths[name] = launches
        first = recs[0]
        first_two[name] = [r["pos"] for r in recs[:2]]
        sim = w._effective_sim()
        dpos = float((first["pos"] - ref["pos"]).abs().max())
        atol = LAYOUT_POS_ATOL[name]
        log(f"{tag} {name}: dense_cap {sim.dense_cap}, spill columns "
            f"{sim.dense_spill_columns} (K {sim.dense_spill_k}), "
            f"compact {sim.dense_compact}, frozen "
            f"{sim.dense_frozen_pairs} ({sim.dense_pair_dtype})")
        log(f"{tag} {name}: one step from the shared state: max |dpos| "
            f"vs the kernel twin {dpos:.3e} m (atol {atol}); iterations "
            f"{first['iters']} vs {ref['iters']}; contacts ff "
            f"{first['ff']} / {ref['ff']}, fb {first['fb']} / "
            f"{ref['fb']}")
        per_step = [(r["iters"], r["overflow"], r["spill_overflow"],
                     r["clamped"]) for r in recs]
        held = {}
        if spill:
            # The held step bins the shared state: its cells past the cap
            # spill, those past cap + min(8, cap) spill rows are dropped.
            held = dict(held_spilled_cells=int((counts0 > cap).sum()),
                        held_spilled_particles=int(
                            np.clip(counts0 - cap, 0, None).sum()),
                        held_cells_past_rows=int(
                            (counts0 > cap + min(8, cap)).sum()))
            log(f"{tag} {name}: the held step's cells past cap {cap}: "
                f"{held['held_spilled_cells']} "
                f"({held['held_spilled_particles']} particles spilled), "
                f"past its spill rows: {held['held_cells_past_rows']}")
        log(f"{tag} {name}: per step (iterations, overflow, spill "
            f"overflow, clamped): {per_step}"
            + (f"; cells past cap {cap} per step: {over_cap}"
               if spill else ""))
        assert dpos <= atol, f"{tag} {name}: {dpos} from the twin"
        if name == "spill8_97k":
            assert held["held_spilled_cells"] > 0, \
                f"{tag} {name}: no cell spills in the held step"
        if name in LAYOUT_SAME_ITERS:
            assert first["iters"] == ref["iters"], f"{tag} {name} iters"
        assert (first["ff"], first["fb"]) == (ref["ff"], ref["fb"]), \
            f"{tag} {name}: contact counts differ from the twin's"
        for k, r in enumerate(recs[:LAYOUT_STEPS]):
            assert r["overflow"] == 0 and r["spill_overflow"] == 0, \
                f"{tag} {name}: overflow at step {k + 1}: {r['overflow']}"
        assert bool(torch.isfinite(live_positions(w)).all()), \
            f"{tag} {name}: non-finite positions"
        for k in LAYOUT_KERNELS[name]:
            assert launches[k] > 0, f"{tag} {name}: {k} never launched"
        for k in set(MAIN_PATH_KERNELS) - set(LAYOUT_KERNELS[name]):
            assert launches[k] == 0, f"{tag} {name}: {k} launched"
        if name == "spill_auto_97k":
            same = all(torch.equal(a, b) for a, b in zip(
                first_two[name], first_two["spill_97k"]))
            log(f"{tag} {name}: the auto tier resolved to cap "
                f"{sim.dense_cap} with {sim.dense_spill_columns} spill "
                f"columns; its {steps} steps bitwise spill_97k's: {same}")
            assert sim.dense_cap == 12 and same
            assert sim.dense_spill_columns == summary["spill_97k"]["E"]
            summary[name] = dict(dense_cap=sim.dense_cap,
                                 E=sim.dense_spill_columns,
                                 bitwise_spill_97k=same,
                                 launches=launches, per_step=per_step)
            del w
            continue
        # The bitwise rerun of the first two steps, and one profiled step.
        again = layout_clone(base, name)
        rerun = []
        with plain_versions_refused(pair):
            for _ in range(2):
                again.step(DT, GRAVITY)
                rerun.append(live_positions(again).clone())
            busy, dev_ms = busy_share(w, steps=1)
        del again
        bitwise = all(torch.equal(a, b)
                      for a, b in zip(first_two[name], rerun))
        details = layout_details(w)
        log(f"{tag} {name}: {ms:.3f} ms/step over {steps} steps; "
            f"device {dev_ms} ms/step, busy {busy} (one profiled step);"
            f" launches {launches}; bitwise rerun {bitwise}; {details}; "
            f"phase {time.perf_counter() - t_phase:.1f} s")
        assert bitwise, f"{tag} {name}: the rerun differs"
        summary[name] = dict(
            dpos_vs_twin=dpos, pos_atol=atol, iters=first["iters"],
            twin_iters=ref["iters"], steps=steps, ms_per_step=ms,
            device_ms_per_step=dev_ms, busy=busy, launches=launches,
            per_step=per_step, **details, **held,
            **(dict(cells_past_cap=over_cap) if spill else {}))
        del w
        torch.cuda.empty_cache()
    del base
    torch.cuda.empty_cache()
    return paths, summary


def phase_small_overflow(pair):
    """Evidence for ROADMAP Queue 3, item 14 (no gate): bench_torch.py's
    dfsph_4k_dense world (4,096 particles, the grid at the auto caps,
    16 / 16) for SMALL_STEPS steps, as it is and with the 12 + spill auto
    tier (``dense_spill_auto``); each step's neighbour and spill overflow.
    Returns ({path: launches}, {variant: per-step record})."""
    tag = "[small_4k]"
    out, paths = {}, {}
    for name in ("small_4k_plain", "small_4k_spill_auto"):
        w = dam_break_world("cuda", "dfsph", n_target=SMALL_N,
                            layout="dense")
        if name == "small_4k_spill_auto":
            w.sim = w.sim.replace(dense_spill_auto=True)
        reset_counts(pair)
        rows = []
        t0 = time.perf_counter()
        for _ in range(SMALL_STEPS):
            w.step(DT, GRAVITY)
            d = w.last_diagnostics
            rows.append((int(d.neighbor_overflow), int(d.spill_overflow)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SMALL_STEPS * 1e3
        sim = w._effective_sim()
        paths[name] = read_counts(pair)
        out[name] = dict(dense_cap=sim.dense_cap,
                         spill_columns=sim.dense_spill_columns,
                         overflow=[r[0] for r in rows],
                         spill_overflow=[r[1] for r in rows], ms_per_step=ms,
                         grid_refits=w.grid_refit_count)
        worst = max(range(SMALL_STEPS), key=lambda k: rows[k][0])
        log(f"{tag} {name}: N={int(w.fluids_state.alive.sum())}, caps "
            f"{w._auto_caps}, spill columns "
            f"{sim.dense_spill_columns}, {ms:.3f} ms/step; per step "
            f"(overflow, spill overflow): {rows}; largest overflow "
            f"{rows[worst][0]} at step {worst + 1}")
        del w
    return paths, out


def slab_setup(world):
    """The slab path's configuration of ``world``'s next step (the full
    static domain, as ``build_sharded_step_fn`` clears the fitted window),
    its single-device twin's (the same grid without the half stencil and
    with the full-grid boundary binning: the kernels in the forms the
    slabs run them), and the slab path's padded grid specs."""
    from salva_tpu_torch.parallel import pad_spec_for_devices
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config

    world._prepare()
    sim = world._boundary_volume_mode(world._effective_sim(), None)
    sim = sim.replace(fitted_dims=None)
    twin = sim.replace(dense_half_stencil=False, dense_sparse_boundary=False)
    spec_f, spec_b, _ = _dense_config(sim, world.solver_config, ForceSet())
    spec_f = pad_spec_for_devices(spec_f, SLAB_N)
    spec_b = spec_b.replace(dims=spec_f.dims, clamp_nx=spec_f.clamp_nx)
    return sim, twin, spec_f, spec_b


def phase_slab_path(pair, name, world, steps, hold_at, pos_atol):
    """Phase 7b: the slab path (``salva_tpu_torch.parallel``, replicated
    binning) of ``world`` on SLAB_N slabs under ``LocalHalos`` on the one
    card, beside its single-device twin (:func:`slab_setup`), ``steps``
    steps each from the same state: identical pressure and divergence
    iterations and ff contacts at every step, each step's neighbour
    overflow under max(1, N // 1000) on both, positions within
    ``pos_atol`` after step ``hold_at`` (the gap after the last step
    logged, ungated), every main-path kernel launched by the slab run
    (counts reset just before it and read just after). Returns its
    record, with the final state."""
    from salva_tpu_torch.parallel import LocalHalos, build_sharded_step_fn
    from salva_tpu_torch.step import build_step_fn

    tag = f"[{name}]"
    sim, twin_sim, spec_f, _ = slab_setup(world)
    args = (world.solver_config, world._force_set, max(world.num_fluids, 1))
    twin_fn = build_step_fn(twin_sim, *args)
    slab_fn = build_sharded_step_fn(sim, *args, LocalHalos(SLAB_N))
    alive = world.fluids_state.alive
    n = int(alive.sum())
    gate = max(1, n // 1000)
    g = torch.tensor(GRAVITY, dtype=torch.float32, device="cuda")
    es = world._elasticity_state
    log(f"{tag} N={n}, {SLAB_N} slabs (LocalHalos, one thread each) of the "
        f"grid {spec_f.dims} (x padded from {spec_f.clamp_nx or spec_f.dims[0]}"
        f"; {spec_f.dims[0] // SLAB_N} owned x-layers a slab, "
        f"{(spec_f.dims[0] // SLAB_N + 2) * int(np.prod(spec_f.dims[1:]))} "
        f"local cells), caps {spec_f.cap} / {sim.dense_cap_boundary}, "
        f"forces {world._force_set}")

    def drive(fn):
        state = (world.fluids_state, world.boundaries_state,
                 world._solver_state)
        rows, pos, ms = [], {}, []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, d = fn(*state, es, DT, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append((d.solver.pressure_iters, d.solver.divergence_iters,
                         int(d.ncontacts_ff), int(d.neighbor_overflow)))
            if i + 1 in (hold_at, steps):
                pos[i + 1] = state[0].positions[alive].clone()
        return rows, pos, ms, state

    twin_rows, twin_pos, twin_ms, _ = drive(twin_fn)
    reset_counts(pair)
    slab_rows, slab_pos, slab_ms, state = drive(slab_fn)
    launches = read_counts(pair)
    gaps = {k: float((slab_pos[k] - twin_pos[k]).abs().max())
            for k in slab_pos}
    for i, (a, b) in enumerate(zip(slab_rows, twin_rows)):
        log(f"{tag} step {i + 1}: (pressure, divergence iterations, ff "
            f"contacts, overflow) slabs {a}, twin {b}; overflow gate "
            f"< {gate}; {slab_ms[i]:.1f} / {twin_ms[i]:.1f} ms")
    ms = statistics.mean(slab_ms[1:])
    twin = statistics.mean(twin_ms[1:])
    log(f"{tag} slab path {ms:.3f} ms/step, twin {twin:.3f} ms/step "
        f"(steps 2-{steps}); max |dpos| slabs vs twin after step {hold_at} "
        f"{gaps[hold_at]:.3e} m (atol {pos_atol}), after step {steps} "
        f"{gaps[steps]:.3e} m (ungated); kernel launches of the slab run "
        f"{launches}")
    for i, (a, b) in enumerate(zip(slab_rows, twin_rows)):
        assert a[:3] == b[:3], f"{tag} step {i + 1}: {a} vs twin {b}"
        assert a[3] < gate and b[3] < gate, f"{tag} step {i + 1}: overflow"
    assert bool(torch.isfinite(slab_pos[steps]).all())
    assert gaps[hold_at] <= pos_atol, f"{tag} positions differ by {gaps}"
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    return dict(n=n, ms=ms, twin_ms=twin, launches=launches,
                gap_hold=gaps[hold_at], gap_last=gaps[steps],
                iters=[r[:2] for r in slab_rows], state=state, sim=sim,
                twin_sim=twin_sim)


def phase_slab_migrate(pair, world):
    """Phase 7c, slab_97k_migrate: the sharded-binning slab path
    (``build_sharded_step_fn(..., sharded_binning=True)``: each substep
    migrates the rows to their slabs) of phase 7b's world on SLAB_N slabs
    under ``LocalHalos``, SLAB_STEPS steps from the state reordered by
    ``shard_interleave`` (in cube emission order a rank's whole block
    would go to one slab and overflow its send buffer), beside the
    replicated slab step and the single-device twin from the same state:
    identical pressure and divergence iterations, ff contacts and
    neighbour overflow at every step, ``candidate_overflow`` equal to the
    replicated run's (send overflow 0), positions bitwise the replicated
    run's after step SLAB_HOLD_AT (or within MIGRATE_POS_ATOL), every
    main-path kernel launched by the migrated run (counts reset just
    before it and read just after); logs each slab's received rows and the
    three runs' ms/step. Returns its record, with the final state."""
    from salva_tpu_torch.parallel import (
        LocalHalos,
        build_sharded_step_fn,
        domain,
        shard_interleave,
    )
    from salva_tpu_torch.step import build_step_fn

    tag = "[slab_97k_migrate]"
    sim, twin_sim, spec_f, spec_b = slab_setup(world)
    args = (world.solver_config, world._force_set, max(world.num_fluids, 1))
    fns = {
        "twin": build_step_fn(twin_sim, *args),
        "replicated": build_sharded_step_fn(sim, *args, LocalHalos(SLAB_N)),
        "migrated": build_sharded_step_fn(sim, *args, LocalHalos(SLAB_N),
                                          sharded_binning=True),
    }
    start = tuple(shard_interleave(st, SLAB_N) for st in (
        world.fluids_state, world.boundaries_state, world._solver_state))
    alive = start[0].alive
    n = int(alive.sum())
    g = torch.tensor(GRAVITY, dtype=torch.float32, device="cuda")
    nxl = spec_f.dims[0] // SLAB_N
    nl = start[0].capacity // SLAB_N
    cap_f = max(64, -(-5 * nl // (2 * SLAB_N)) + 64)

    def received(fl):
        """Each slab's live fluid rows at state ``fl`` (owned and ghost
        copies), as the migration routes them."""
        t = domain._slab_targets(spec_f, nxl, SLAB_N, fl.positions,
                                 fl.alive)
        return [int((t == r).sum()) for r in range(SLAB_N)]

    def drive(fn):
        state, rows, pos, ms = start, [], {}, []
        for i in range(SLAB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, d = fn(*state, None, DT, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append((d.solver.pressure_iters, d.solver.divergence_iters,
                         int(d.ncontacts_ff), int(d.neighbor_overflow),
                         int(d.candidate_overflow)))
            if i + 1 in (SLAB_HOLD_AT, SLAB_STEPS):
                pos[i + 1] = state[0].positions[alive].clone()
        return rows, pos, ms, state

    runs = {}
    for name in ("twin", "replicated", "migrated"):
        if name == "migrated":
            reset_counts(pair)
        runs[name] = drive(fns[name])
        if name == "migrated":
            launches = read_counts(pair)
    (m_rows, m_pos, m_ms, state) = runs["migrated"]
    r_rows, r_pos, r_ms, _ = runs["replicated"]
    t_rows, t_pos, t_ms, _ = runs["twin"]
    log(f"{tag} N={n} (capacity {start[0].capacity}, {nl} rows a rank), "
        f"{SLAB_N} slabs (LocalHalos) of the grid {spec_f.dims}; send buffer "
        f"{cap_f} rows a rank pair ({SLAB_N * cap_f} received rows a slab), "
        f"boundary {max(64, start[1].capacity // SLAB_N)}; each slab's live "
        f"received fluid rows at the start {received(start[0])}, after step "
        f"{SLAB_STEPS} {received(state[0])}")
    for i, (a, b, c) in enumerate(zip(m_rows, r_rows, t_rows)):
        log(f"{tag} step {i + 1}: (pressure, divergence iterations, ff "
            f"contacts, overflow, candidate overflow) migrated {a}, "
            f"replicated {b}, twin {c}; {m_ms[i]:.1f} / {r_ms[i]:.1f} / "
            f"{t_ms[i]:.1f} ms")
    gaps = {k: float((m_pos[k] - r_pos[k]).abs().max()) for k in m_pos}
    twin_gap = float((m_pos[SLAB_STEPS] - t_pos[SLAB_STEPS]).abs().max())
    ms = {k: statistics.mean(v[2][1:]) for k, v in runs.items()}
    bitwise = torch.equal(m_pos[SLAB_HOLD_AT], r_pos[SLAB_HOLD_AT])
    log(f"{tag} ms/step (steps 2-{SLAB_STEPS}): migrated {ms['migrated']:.3f}"
        f", replicated {ms['replicated']:.3f}, twin {ms['twin']:.3f}; max "
        f"|dpos| migrated vs replicated after step {SLAB_HOLD_AT} "
        f"{gaps[SLAB_HOLD_AT]:.3e} m (bitwise {bitwise}), after step "
        f"{SLAB_STEPS} {gaps[SLAB_STEPS]:.3e} m; vs the twin after step "
        f"{SLAB_STEPS} {twin_gap:.3e} m (ungated); kernel launches of the "
        f"migrated run {launches}")
    for i, (a, b, c) in enumerate(zip(m_rows, r_rows, t_rows)):
        assert a == b, f"{tag} step {i + 1}: migrated {a} vs replicated {b}"
        assert a[:3] == c[:3], f"{tag} step {i + 1}: {a} vs twin {c}"
        assert a[3] < max(1, n // 1000), f"{tag} step {i + 1}: overflow"
    assert bool(torch.isfinite(m_pos[SLAB_STEPS]).all())
    assert gaps[SLAB_HOLD_AT] <= MIGRATE_POS_ATOL, \
        f"{tag} positions differ by {gaps}"
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    return dict(n=n, ms=ms["migrated"], replicated_ms=ms["replicated"],
                twin_ms=ms["twin"], launches=launches,
                gap_hold=gaps[SLAB_HOLD_AT], gap_last=gaps[SLAB_STEPS],
                bitwise=bitwise, state=state, sim=sim, twin_sim=twin_sim)


def phase_slab_migrate_elastic(pair):
    """Phase 7c: dense_elastic's forces (the Becker 2009 elasticity and
    XSPH) on phase 7b's world (full-grid boundary binning, caps 16 / 16),
    MIGRATE_ELASTIC_STEPS steps of the sharded-binning slab path on
    SLAB_N slabs beside the single-device twin: the elasticity's
    acceleration is evaluated on the home rows before the migration and
    routed with them (``a_pw``). The storage stays in emission order (the
    elasticity's rest contacts index the rows), so the send buffer holds a
    rank's whole block (``send_cap``). Identical iterations at every step,
    positions and velocities within tests/test_domain.py's bounds."""
    from salva_tpu_torch.parallel import LocalHalos, build_sharded_step_fn
    from salva_tpu_torch.step import build_step_fn

    tag = "[slab_97k_migrate elastic]"
    world = dam_break_world("cuda", "dfsph", sparse_boundary=False,
                            forces=ELASTIC, dense_caps=(16, 16))
    sim, twin_sim, _, _ = slab_setup(world)
    args = (world.solver_config, world._force_set, max(world.num_fluids, 1))
    nl = world.fluids_state.capacity // SLAB_N
    fns = {"twin": build_step_fn(twin_sim, *args),
           "migrated": build_sharded_step_fn(
               sim, *args, LocalHalos(SLAB_N), sharded_binning=True,
               send_cap=nl)}
    es = world._elasticity_state
    g = torch.tensor(GRAVITY, dtype=torch.float32, device="cuda")
    out = {}
    for name, fn in fns.items():
        state = (world.fluids_state, world.boundaries_state,
                 world._solver_state)
        rows, ms = [], []
        for _ in range(MIGRATE_ELASTIC_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            *state, d = fn(*state, es, DT, g)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append((d.solver.pressure_iters, d.solver.divergence_iters,
                         int(d.ncontacts_ff), int(d.neighbor_overflow),
                         int(d.candidate_overflow)))
        out[name] = (rows, ms, state[0])
    alive = world.fluids_state.alive
    (m_rows, m_ms, m_fl), (t_rows, t_ms, t_fl) = out["migrated"], out["twin"]
    dpos = float((m_fl.positions - t_fl.positions)[alive].abs().max())
    dvel = float((m_fl.velocities - t_fl.velocities)[alive].abs().max())
    for i, (a, b) in enumerate(zip(m_rows, t_rows)):
        log(f"{tag} step {i + 1}: (pressure, divergence iterations, ff "
            f"contacts, overflow, candidate overflow) migrated {a}, twin {b};"
            f" {m_ms[i]:.1f} / {t_ms[i]:.1f} ms")
    log(f"{tag} forces {world._force_set}; send cap {nl} rows (a rank's "
        f"block); after {MIGRATE_ELASTIC_STEPS} steps max |dpos| {dpos:.3e} m "
        f"(atol {ELASTIC_POS_ATOL}), max |dvel| {dvel:.3e} m/s (atol "
        f"{ELASTIC_VEL_ATOL})")
    for i, (a, b) in enumerate(zip(m_rows, t_rows)):
        assert a[:2] == b[:2], f"{tag} step {i + 1}: {a} vs twin {b}"
        assert a[4] == b[4], f"{tag} step {i + 1}: send overflow"
    assert bool(torch.isfinite(m_fl.positions[alive]).all())
    assert dpos <= ELASTIC_POS_ATOL and dvel <= ELASTIC_VEL_ATOL, \
        f"{tag} |dpos| {dpos}, |dvel| {dvel}"
    return dict(ms=statistics.mean(m_ms), twin_ms=statistics.mean(t_ms),
                dpos=dpos, dvel=dvel, iters=[r[:2] for r in m_rows])


def phase_dryrun():
    """Phase 7c: ``salva_tpu_torch.parallel.dryrun(SLAB_N)`` on the card
    (one sharded-binning step of a 6^3 block, with its asserts)."""
    from salva_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    dryrun(SLAB_N)
    log(f"[dryrun] dryrun({SLAB_N}) on the card passed in "
        f"{time.perf_counter() - t0:.2f} s")


def fb_read_bytes(c, counts, h, shifts, dim=3):
    """What the fluid-boundary hoist must read on a full-grid boundary
    binning, every column visited (phase 5's count for its ``full``
    layout): the positions of the fluid slots with a boundary particle
    around, the counts and boundary counts of the cells the live columns
    reach, the positions of the boundary slots in those cells, and the
    volume and velocity of the boundary slots within h of a live fluid
    slot. Returns (bytes, candidate pairs)."""
    C = counts.shape[0]
    c64, cb = counts.long(), c.counts_b.long()
    around = sum(shift_flat(cb, s) for s in shifts)
    n_pf = int((c64 * (around > 0)).sum())
    need = sum(shift_flat((c64 > 0).long(), -s) for s in shifts) > 0
    n_need = int(need.sum())
    n_pb = int((cb * need).sum())
    visit = torch.ones(C, dtype=torch.int64, device="cuda")
    n_wb = boundary_slots_within(c, counts, visit, h, shifts)
    idx = 4 * (C + 2 * n_need)
    read = 4 * (dim * n_pf + dim * n_pb + (1 + dim) * n_wb) + idx
    return read, int((c64 * around).sum())


def near_ties(tag, label, c, got, want, own, boundary=False):
    """Log each slot of the columns ``own`` where a kernel's pair counts
    ``got`` differ from the plain version's ``want``, with its candidate
    pairs whose r^2 lies within 2 float32 ulps of h^2 (the 97k lattice
    holds pairs at r = h; ROADMAP Queue 3, items 5 and 25). The kernels
    round r^2 as the plain versions do, so the caller then holds the
    counts exactly; the log names the slots if they ever part again.
    Returns the number of differing slots."""
    from salva_tpu_torch.geometry import dense_grid as tdg

    diff = ((got != want) & own[None, :]).nonzero().tolist()
    h2 = float(np.float32(c.h * c.h))
    ulp = float(np.spacing(np.float32(h2)))
    Pj, cnt_j = (c.Pb, c.counts_b) if boundary else (c.P, c.counts)
    for r, col in diff:
        pi = c.P[:, r, col]
        ties = []
        for s_ in tdg.flat_shifts(c.spec_f):
            n = col + s_
            if not 0 <= n < Pj.shape[-1]:
                continue
            d = pi[:, None] - Pj[:, :int(cnt_j[n]), n]
            r2 = d[0] * d[0]
            r2 = r2 + d[1] * d[1]
            r2 = r2 + d[2] * d[2]
            ties += [float(v) for v in r2 if abs(float(v) - h2) <= 2 * ulp]
        log(f"{tag} {label}: slot ({r}, {col}) counts {int(got[r, col])} "
            f"(kernel) vs {int(want[r, col])} (plain); candidate r^2 within 2 "
            f"ulps of h^2 = {h2!r}: {ties}")
    return len(diff)


def migrated_ctxs(sim, spec_f, spec_b, fl, bd):
    """One DenseCtx a slab of the sharded-binning path at state ``(fl,
    bd)`` (the whole state, in rank blocks): each rank routes its block's
    rows to their slabs (``domain._route_out`` at the step's default send
    capacities) and bins only the rows it received, as a migrated substep
    does. Returns (each rank's (context, received fluids, received
    boundaries), each rank's received live fluid rows, the fluid send
    buffer's rows a rank, the send overflow)."""
    from salva_tpu_torch.object.state import (
        map_state,
        state_from_leaves,
        state_leaves,
    )
    from salva_tpu_torch.parallel import LocalHalos, domain
    from salva_tpu_torch.solver.dense_common import DenseCtx

    nxl = spec_f.dims[0] // SLAB_N
    nl, ml = fl.capacity // SLAB_N, bd.capacity // SLAB_N
    cap_f = max(64, -(-5 * nl // (2 * SLAB_N)) + 64)
    cap_b = max(64, ml)

    def body(halo):
        r = halo.rank
        out, over = [], 0
        for st, spec, n, cap in ((fl, spec_f, nl, cap_f),
                                 (bd, spec_b, ml, cap_b)):
            st = map_state(lambda a: a[r * n:(r + 1) * n], st)
            leaves = state_leaves(st)
            tgt = domain._slab_targets(spec, nxl, SLAB_N, st.positions,
                                       st.alive)
            recv, _dst, o = domain._route_out(
                halo, domain._pack_rows(leaves), tgt, cap)
            out.append(state_from_leaves(st, domain._unpack_rows(recv,
                                                                 leaves)))
            over += int(o)
        ctx = DenseCtx(sim, spec_f, spec_b, out[0], out[1], halo=halo,
                       need_s2=True)
        return (ctx, *out), int(out[0].alive.sum()), over

    res = LocalHalos(SLAB_N).run(nxl, int(np.prod(spec_f.dims[1:])), body,
                                 migrate=True)
    return ([c for c, _, _ in res], [n for _, n, _ in res],
            SLAB_N * cap_f, sum(o for _, _, o in res))


def slab_kernel_checks(pair, world, run, migrate=False):
    """Phase 7b: each main-path kernel on one slab's local grid at the
    slab run's final state (the slab owning the most particles), against
    its plain version on the interior columns (the kernels treat the cells
    beyond the local grid as empty, the plain versions roll cyclically;
    every reader of a pass output refreshes the ghost columns first):
    phase 5's tolerances, pair counts exact (the differing slots logged
    first, with their near ties), the two-binning ``expand`` bitwise;
    device times beside the single-device twin's at the same state,
    bounds. ``migrate`` (phase 7c): the slab's grid binned from the rows
    the migration routes to it (:func:`migrated_ctxs`), which must equal
    the replicated binning's grid bitwise; no twin. Returns {kernel:
    record}."""
    from salva_tpu_torch.geometry import dense_grid as tdg
    from salva_tpu_torch.ops import binning
    from salva_tpu_torch.parallel import LocalHalos
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config

    tag = "[slab_97k_migrate kernels]" if migrate else "[slab_97k kernels]"
    sim, twin_sim = run["sim"], run["twin_sim"]
    _, _, spec_f, spec_b = slab_setup(world)
    fl, bd = run["state"][0], run["state"][1].clear_forces()
    nxl = spec_f.dims[0] // SLAB_N
    ctxs = LocalHalos(SLAB_N).run(
        nxl, int(np.prod(spec_f.dims[1:])),
        lambda halo: DenseCtx(sim, spec_f, spec_b, fl, bd, halo=halo,
                              need_s2=True))
    owned = [int((c.counts * c.interior[0]).sum()) for c in ctxs]
    rank = int(np.argmax(owned))
    checks = [("slab", ctxs[rank], fl, bd)]
    if migrate:
        mctxs, received, buf_rows, over = migrated_ctxs(sim, spec_f, spec_b,
                                                        fl, bd)
        log(f"{tag} each slab's received live fluid rows {received} (send "
            f"buffer {buf_rows} rows a slab; N = {int(fl.alive.sum())}, "
            f"capacity {fl.capacity}); send overflow {over}")
        assert over == 0, f"{tag} send overflow {over}"
        m, c = mctxs[rank][0], ctxs[rank]
        for what in ("P", "M", "counts", "Pb", "Volb", "counts_b"):
            assert torch.equal(getattr(m, what), getattr(c, what)), \
                f"{tag} migrated slab {rank}'s {what} differs"
        checks = [("slab", *mctxs[rank])]
    else:
        tf, tb, _ = _dense_config(twin_sim, world.solver_config, ForceSet())
        checks.append(("twin", DenseCtx(twin_sim, tf, tb, fl, bd,
                                        need_s2=True), fl, bd))
    gen = torch.Generator(device="cuda").manual_seed(7)
    records = {}
    for label, c, fl, bd in checks:
        own = (c.interior[0] if label == "slab" else
               torch.ones(c.spec_f.num_cells, dtype=torch.bool,
                          device="cuda"))
        spec, h, P, M, counts = c.spec_f, c.h, c.P, c.M, c.counts
        C = spec.num_cells
        shifts = tdg.flat_shifts(spec)
        K = (c.rho * 1e-6 * c.maskf).contiguous()
        Q = c.V.contiguous()
        Vb = (torch.randn(c.Vbvel.shape, generator=gen, device="cuda")
              * c.maskb[None]).contiguous()
        fb = (spec, h, 3, "cubic", "cubic", P, counts, c.Pb, c.Volb, Vb,
              c.counts_b)
        items = [(c.binf, [(fl.positions, tdg.POS_SENTINEL),
                           (fl.velocities, 0.0)]),
                 (c.binb, [(bd.positions, tdg.POS_SENTINEL),
                           (bd.velocities, 0.0), (bd.volumes, 0.0)])]
        # hoist_ff first: its pair count is the others' within-h count.
        calls = {
            "hoist_ff": (lambda: pair.hoist_ff(spec, h, 3, "cubic", "cubic",
                                               P, M, counts),
                         lambda: pair.hoist_ff_plain(spec, h, 3, "cubic",
                                                     "cubic", P, M, counts),
                         HOIST_TOL),
            "k_pass": (lambda: pair.k_pass(spec, h, 3, "cubic", P, M, K,
                                           counts),
                       lambda: pair.k_pass_plain(spec, h, 3, "cubic", P, M,
                                                 K, counts), KT_TOL),
            "t_pass": (lambda: pair.t_pass(spec, h, 3, "cubic", P, M, Q,
                                           counts),
                       lambda: pair.t_pass_plain(spec, h, 3, "cubic", P, M,
                                                 Q, counts), KT_TOL),
            "hoist_fb": (lambda: pair.hoist_fb(*fb),
                         lambda: pair.hoist_fb_plain(*fb), HOIST_TOL),
            "expand": (lambda: tuple(binning.expand_many(items)),
                       lambda: tuple(binning.expand_many_plain(items)),
                       None),
        }
        c64 = counts.long()
        n_live = int(c64.sum())
        cand = sum(int((c64 * shift_flat(c64, s)).sum()) for s in shifts)
        within = 0
        for name, (kern, plain, tol) in calls.items():
            out, ref = kern(), plain()
            if name == "expand":
                for o_t, r_t in zip(out, ref):
                    assert all(torch.equal(o, r) for o, r in zip(o_t, r_t)), \
                        f"expand ({label}) differs from plain"
                err = 0.0
                read = written = 0
                for binned, its in items:
                    cap_, C_ = binned.mask.shape
                    nch = sum(1 if v.ndim == 1 else v.shape[1] for v, _ in its)
                    read += (int(torch.clamp(binned.count, max=cap_).sum())
                             * 4 * (nch + 1) + 8 * C_)
                    written += 4 * nch * cap_ * C_
                b_ms, b_by = (read + written) / HBM_BYTES_PER_S * 1e3, "bytes"
            else:
                out, ref = as_tuple(out), as_tuple(ref)
                names = OUTPUTS[name]
                if len(out) > len(names):
                    parted = near_ties(tag, f"{name} ({label})", c, out[-1],
                                       ref[-1], own,
                                       boundary=name == "hoist_fb")
                    assert parted == 0 and torch.equal(
                        out[-1][..., own], ref[-1][..., own]), \
                        f"{tag} {name} ({label}): pair counts differ"
                err = max(check_output(f"{name} ({label}).{o}",
                                       out[i][..., own], ref[i][..., own],
                                       tol)[0]
                          for i, o in enumerate(names))
                if name == "hoist_ff":
                    within = int(out[-1].sum())
                if name == "hoist_fb":
                    read, fb_cand = fb_read_bytes(c, counts, h, shifts)
                    b_ms, b_by, _ = bound(name, 3, read, nbytes(out),
                                          fb_cand, int(out[-1].sum()))
                else:
                    planes = {"k_pass": [P, M, K], "t_pass": [P, M, Q],
                              "hoist_ff": [P, M]}[name]
                    b_ms, b_by, _ = bound(
                        name, 3, live_bytes(planes, n_live) + 4 * C,
                        nbytes(out), cand,
                        within)
            ms = cuda_ms(kern, 50)
            plain_ms = cuda_ms(plain, 5) if label == "slab" else None
            rec = records.setdefault(name, {})
            if label == "slab":
                rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, cells=C, rank=rank)
            else:
                rec.update(twin_ms=ms, twin_bound_ms=b_ms, twin_cells=C)
            log(f"{tag} {name} ({label}, {C} cells"
                + (f", slab {rank}, interior columns" if label == "slab"
                   else ", single device") + f"): max abs err {err:.4e}; "
                f"kernel {ms:.4f} ms device time"
                + (f", plain {plain_ms:.4f} ms" if plain_ms else "")
                + f"; bound {b_ms:.5f} ms ({b_by}); kernel / bound "
                f"{ms / b_ms:.1f}")
    return records


def small_dam_world(device, layout, dense_caps=(None, None)):
    """``tests/test_brute.py``'s ``_dam_world`` at n=5: 125 particles on
    a lattice 2 radii apart, 0.4 m up, falling at 2 m/s over a sampled
    0.8 x 0.1 x 0.8 floor, in a static domain, no window fitting."""
    from salva_tpu_torch import shapes
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.world import Boundary, Fluid, LiquidWorld

    radius = 0.05
    world = LiquidWorld(particle_radius=radius, dim=3, layout=layout,
                        domain=((-1.0, -0.4, -1.0), (1.0, 2.0, 1.0)),
                        fit_grid=False, dense_cap=dense_caps[0],
                        dense_cap_boundary=dense_caps[1], device=device)
    ax = np.arange(5) * 2.0 * radius
    pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    pos[:, 1] += 0.4
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    world.add_fluid(Fluid(pos, density0=1000.0, velocities=vel))
    floor = shape_surface_sample(shapes.Cuboid((0.8, 0.1, 0.8)), radius, 3)
    floor[:, 1] -= 0.1
    world.add_boundary(Boundary(floor))
    return world


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def step_world(world, steps, device):
    """``steps`` steps of ``world``: (iterations per step, step-1
    contacts (ff, fb), overflow per step, live positions, ms/step)."""
    iters, overflow, first = [], [], None
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        world.step(DT, GRAVITY)
        d = world.last_diagnostics
        iters.append((d.solver.pressure_iters, d.solver.divergence_iters))
        overflow.append(int(d.neighbor_overflow))
        if first is None:
            first = (int(d.ncontacts_ff), int(d.ncontacts_fb))
    _sync(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    alive = world.fluids_state.alive
    return dict(iters=iters, first=first, overflow=overflow,
                pos=world.fluids_state.positions[alive].clone(), ms=ms)


def phase_brute(pair, device="cuda", steps=10):
    """Phase 8: the brute all-pairs tier on two small worlds. Each world
    resolves ``layout="auto"`` to brute and is stepped twice from the same
    inputs (bitwise equal, no kernel launched), then against the same
    world at ``layout="dense"`` (the kernels). The 125-particle world's
    floor sits on the grid's cell edges, where the host's float64
    occupancy measure (the auto cap tier) undercounts the device's
    float32 binning: with auto caps the grid drops boundary particles
    (logged here, one step), so its dense twin names caps of 32. Returns
    each path's launch counts."""
    scenes = {
        "dam_n5": (lambda layout, caps=(None, None):
                   small_dam_world(device, layout, caps), (32, 32)),
        "bench_16": (lambda layout, caps=(None, None):
                     dam_break_world(device, n_target=16 ** 3,
                                     layout=layout, dense_caps=caps),
                     (None, None)),
    }
    launches = {}
    for name, (make, dense_caps) in scenes.items():
        tag = f"[brute {name}]"
        runs = []
        for _ in range(2):
            world = make("auto")
            sim = world._effective_sim()
            assert sim.layout == "brute", f"{tag} auto resolved {sim.layout}"
            reset_counts(pair)
            runs.append(step_world(world, steps, device))
            counts = read_counts(pair)
            assert not any(counts.values()), f"{tag} launched {counts}"
        launches[f"brute_{name}"] = counts
        n = runs[0]["pos"].shape[0]
        assert runs[0]["iters"] == runs[1]["iters"]
        assert torch.equal(runs[0]["pos"], runs[1]["pos"]), \
            f"{tag} two runs differ"
        if dense_caps != (None, None):
            auto = make("dense")
            auto.warn_overflow = False
            auto.step(DT, GRAVITY)
            log(f"{tag} the grid with auto caps {auto._auto_caps}: overflow "
                f"{int(auto.last_diagnostics.neighbor_overflow)} at step 1; "
                f"the dense twin runs caps {dense_caps}")
        dense = make("dense", dense_caps)
        dsim = dense._effective_sim()
        reset_counts(pair)
        grid = step_world(dense, steps, device)
        launches[f"dense_{name}"] = read_counts(pair)
        brute = runs[0]
        dpos = float((brute["pos"] - grid["pos"]).abs().max())
        log(f"{tag} N={n}: brute {brute['ms']:.3f} / {runs[1]['ms']:.3f} "
            f"ms/step (caps {sim.dense_cap} x {sim.brute_cells} cyclic "
            f"cells fluid, {sim.dense_cap_boundary} boundary), dense "
            f"{grid['ms']:.3f} ms/step (caps {dsim.dense_cap}/"
            f"{dsim.dense_cap_boundary}, window {dsim.fitted_dims}), "
            f"{steps} steps each")
        log(f"{tag} iterations brute {brute['iters']} vs dense "
            f"{grid['iters']}; step-1 contacts (ff, fb) {brute['first']} vs "
            f"{grid['first']}; overflow {brute['overflow'][-1]} / "
            f"{grid['overflow'][-1]}; max |dpos| {dpos:.3e} m (atol "
            f"{BRUTE_POS_ATOL[name]}); dense launches "
            f"{launches[f'dense_{name}']}")
        assert brute["first"] == grid["first"], "step-1 contacts differ"
        assert brute["iters"] == grid["iters"], "iterations differ"
        assert not any(brute["overflow"]) and not any(grid["overflow"])
        assert bool(torch.isfinite(brute["pos"]).all())
        assert dpos <= BRUTE_POS_ATOL[name], f"positions differ by {dpos}"
        for k in MAIN_PATH_KERNELS:
            assert launches[f"dense_{name}"][k] > 0, f"dense {name}: {k}"
    return launches


def resolved_layout(world):
    """brute, dense or gather: what the next step of ``world`` runs."""
    from salva_tpu_torch.step import _dense_config

    sim = world._effective_sim()
    if sim.layout == "brute":
        return "brute"
    if world._force_set is None:
        world._force_set = world._build_force_set()
    dense = _dense_config(sim, world.solver_config, world._force_set)
    return "dense" if dense is not None else "gather"


def live_positions(world):
    fl = world.fluids_state
    return fl.positions[fl.alive]


def rigid_state_finite(pipeline):
    dev = pipeline._device
    return all(bool(torch.isfinite(t).all())
               for t in dev.rigid_state[:4]) if dev else True


def harness_twin(device_coupling, subs=None):
    """A fresh 64k harness stepped HARNESS_TWIN_STEPS times on one coupling
    path, with the module attributes ``subs`` substituted: ((iterations,
    ff, fb, overflow) per step, live positions)."""
    from salva_tpu_torch import scenes

    scene = scenes.harness_basic3(nparticles=HARNESS_N)
    scene.pipeline._device_request = device_coupling
    rec = []
    with substituted(subs or {}):
        for _ in range(HARNESS_TWIN_STEPS):
            scene.step()
            d = scene.world.last_diagnostics
            rec.append((d.solver.pressure_iters, d.solver.divergence_iters,
                        int(d.ncontacts_ff), int(d.ncontacts_fb),
                        int(d.neighbor_overflow)))
    return rec, live_positions(scene.world).clone()


def plain_subs(pair):
    """The plain versions substituted for every kernel wrapper of the
    coupled paths (the pair passes, ``expand``, the rigid solve)."""
    from salva_tpu_torch.ops import binning, rigid

    subs = {(pair, n): getattr(pair, n + "_plain")
            for n in ("k_pass", "t_pass", "hoist_ff", "hoist_fb")}
    subs[(binning, "expand_many")] = binning.expand_many_plain
    subs[(rigid, "solve_contacts")] = rigid.solve_contacts_plain
    return subs


def phase_coupled_harness(pair):
    """The coupled main path: harness_basic3 at 64,000 particles through
    ``scenes.harness_basic3`` and ``FluidsPipeline.step`` on the card, its
    walls coupled on the device coupling path, the fluid on the dense
    layout through the pair kernels and ``expand``. HARNESS_STEPS (warm-up,
    timed) steps with the world's counters on (each step ends in a
    synchronize): ms/step, iterations, the coupling counters per step,
    then 2 profiled steps (device ms/step, busy share). Gates: the
    overflow gate, finite positions, the fluid inside the walls' inner
    faces; then a fresh device run, a host-coupling twin
    (``device_coupling=False``) and a device run through the plain
    versions (substituted here for every kernel wrapper; it launches
    nothing), HARNESS_TWIN_STEPS steps each: identical iterations and
    overflow, positions within PATH_POS_ATOL; contacts identical between
    the coupling paths at every step and between kernels and plain
    versions at the first (their shared input). Phase 5's cubic checks
    then run at the timed run's state: every kernel of the path against
    its plain version on one input at the harness's own shapes (caps
    16 / 24, the walls' sparse fb table), pair counts exact, planted
    faults caught."""
    from salva_tpu_torch import scenes

    tag = "[coupled_harness]"
    scene = scenes.harness_basic3(nparticles=HARNESS_N)
    world = scene.world
    assert world.device.type == "cuda" and scene.pipeline.device_coupling
    n = int(world.fluids_state.alive.sum())
    assert n == HARNESS_N ** 3, n
    world.counters.enable()
    warm, steps = HARNESS_STEPS
    reset_counts(pair)
    iters, update_ms, transmit_ms, step_ms = [], [], [], []
    t0 = time.perf_counter()
    for i in range(warm + steps):
        if i == warm:
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
        scene.step()
        if i >= warm:
            c = world.counters
            s_ = world.last_diagnostics.solver
            iters.append((s_.pressure_iters, s_.divergence_iters))
            update_ms.append(c.cd.boundary_update_time.time * 1e3)
            transmit_ms.append(c.coupling_transmit_time.time * 1e3)
            step_ms.append(c.step_time.time * 1e3)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(pair)
    ms = elapsed / steps * 1e3
    layout = resolved_layout(world)
    sim = world._effective_sim()
    d = world.last_diagnostics
    overflow = int(d.neighbor_overflow)
    pos = live_positions(world)
    finite = bool(torch.isfinite(pos).all())
    reach = float(pos[:, [0, 2]].abs().max())
    lowest = float(pos[:, 1].min())
    n_b = int(world.boundaries_state.alive.sum())
    share = (sum(update_ms) + sum(transmit_ms)) / sum(step_ms)
    log(f"{tag} N={n}, {n_b} boundary particles, layout {layout}, coupling "
        f"path {'device' if scene.pipeline.device_coupling else 'host'}: "
        f"{ms:.3f} ms/step over {steps} timed steps ({warm} warm-up steps "
        f"took {warm_s:.2f} s)")
    log(f"{tag} iterations per timed step (pressure, divergence): {iters}")
    log(f"{tag} caps {world._auto_caps} (fluid, boundary), window "
        f"{sim.fitted_dims or 'full domain'}, fb table {world._fb_cols_cache}"
        f", grid refits {world.grid_refit_count}")
    log(f"{tag} coupling counters per timed step (host ms): boundary "
        f"update {[round(v, 3) for v in update_ms]}, transmit "
        f"{[round(v, 3) for v in transmit_ms]}; their share of the step "
        f"{share:.4f}")
    log(f"{tag} last step: overflow {overflow} (gate < {max(1, n // 1000)}), "
        f"clamped {int(d.candidate_overflow)}, contacts ff "
        f"{int(d.ncontacts_ff)} fb {int(d.ncontacts_fb)}, max density ratio "
        f"{float(d.max_density_ratio):.4f}; positions finite {finite}, "
        f"max |x|, |z| {reach:.4f} m (walls' inner faces {WALL_INNER}), "
        f"lowest y {lowest:.4f} m")
    log(f"{tag} kernel launches in this run ({warm + steps} steps): "
        f"{launches}")
    assert layout == "dense", f"{tag} resolved {layout}"
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    assert overflow < max(1, n // 1000), f"{tag} overflow {overflow}"
    assert finite, f"{tag} non-finite positions"
    assert reach <= WALL_INNER and lowest >= 0.0, f"{tag} fluid left the box"
    busy, dev_ms = busy_share(world, step=scene.step)
    log(f"{tag} 2 profiled steps: device {dev_ms} ms/step, busy {busy}")
    # Phase 5's cubic checks at this state: every kernel of the path and
    # its plain version on one input, at the harness's caps, grid and
    # walls' fb table.
    mod = sys.modules[__name__]
    with substituted({(mod, "log"): lambda m: print(
            m.replace("[kernels]", "[kernels harness]", 1), flush=True)}):
        checks = phase_kernels(pair, world, full=False)
    del scene, world
    torch.cuda.empty_cache()
    dev_rec, dev_pos = harness_twin(True)
    host_rec, host_pos = harness_twin(False)
    dpos = float((dev_pos - host_pos).abs().max())
    log(f"{tag} twins, {HARNESS_TWIN_STEPS} steps: device path "
        f"(iterations, ff, fb, overflow) {dev_rec}, host path {host_rec}; "
        f"max |dpos| {dpos:.3e} m (atol {PATH_POS_ATOL['dfsph']})")
    assert dev_rec == host_rec, f"{tag} the coupling paths differ"
    assert dpos <= PATH_POS_ATOL["dfsph"], f"{tag} positions differ {dpos}"
    torch.cuda.empty_cache()
    reset_counts(pair)
    t0 = time.perf_counter()
    plain_rec, plain_pos = harness_twin(True, plain_subs(pair))
    plain_launches = read_counts(pair)
    dpos_p = float((dev_pos - plain_pos).abs().max())
    log(f"{tag} plain twin (device path, every kernel wrapper replaced by "
        f"its plain version), {HARNESS_TWIN_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: {plain_rec} vs the kernels' "
        f"{dev_rec}; max |dpos| {dpos_p:.3e} m (atol "
        f"{PATH_POS_ATOL['dfsph']}); launches {plain_launches}")
    assert not any(plain_launches.values()), f"{tag} the plain run launched"
    # Iterations and overflow identical at every step; contacts at the
    # first step, whose input the two runs share. From the second step
    # the runs' positions differ in their last bits, and the lattice
    # puts ~10^5 pairs at r = h, so a pair count may differ by a few
    # ties: the kernels' counts are held on one input by the checks
    # below, at this world's state.
    assert [r[:2] + r[4:] for r in plain_rec] == \
        [r[:2] + r[4:] for r in dev_rec], f"{tag} iterations differ"
    assert plain_rec[0] == dev_rec[0], f"{tag} step-1 contacts differ"
    assert dpos_p <= PATH_POS_ATOL["dfsph"], \
        f"{tag} kernel and plain positions differ by {dpos_p}"
    torch.cuda.empty_cache()
    return dict(n=n, ms=ms, device_ms=dev_ms, busy=busy, iters=iters,
                launches=launches, update_ms=update_ms,
                transmit_ms=transmit_ms, coupling_share=share, layout=layout,
                kernels=checks)


def faucet_schedule(steps, dt):
    """The step indices at which faucet3's callback emits a sheet (its
    rule: one every 0.06 s of simulated time, the first at t = 0)."""
    last, out = -1.0, []
    for i in range(steps):
        t = i * dt
        if t - last >= 0.06:
            last = t
            out.append(i)
    return out


def tracks_bodies(scene):
    """Max distance between each dynamic body's sampled boundary and its
    samples placed at the body's pose (host poses after one sync)."""
    world, pip = scene.world, scene.pipeline
    rw = pip.sync_bodies()
    alive = world.boundaries_state.alive.cpu().numpy()
    pos = world.boundaries_state.positions.cpu().numpy()
    gap, moved = 0.0, []
    for e in pip.coupling.entries.values():
        body = rw.body_of_collider(e.collider)
        if e.sampling.kind != "static" or not body.is_dynamic:
            continue
        R, t = rw.collider_pose(e.collider)
        want = e.sampling.points @ R.T + t
        got = pos[(world._boundary_slot_owner == e.boundary) & alive]
        assert got.shape == want.shape
        gap = max(gap, float(np.abs(got - want).max()))
        moved.append(body.translation.tolist())
    return gap, moved


def phase_scenes(pair):
    """Every SCENES entry at its published size, SCENE_STEPS steps through
    ``scenes.run`` on the card (the default coupling path: the device
    one), the world's counters on; then 1 profiled step. Logs the
    layout, ms/step (all steps, and the last half), device ms/step and
    busy share, particle and boundary counts, iterations, the coupling
    counters' share, body poses, the neighbor overflow of every step.
    Gates: finite state; every step's overflow under the
    max(1, N // 1000) gate of the coupled harness; faucet3's sheets
    emitted on its schedule and its particles below y = -2 deleted, both
    counted exactly (the fall to y = -2 takes ~0.7 s, so after the run
    the fluid is moved down by 2 m + its median height and the scene's
    callback deletes the lower half); basic2 and layers2's dynamic
    bodies' boundaries at their bodies' poses; custom_forces's
    attractors pulling each side outward (tests/test_scenes.py). Then
    basic2 one step on each coupling path, body state within RIGID_TOL
    and positions within PATH_POS_ATOL. Returns a row a scene, and
    basic2's launch counts."""
    from salva_tpu_torch import scenes

    rows = {}
    launches = None
    for name, make in scenes.SCENES.items():
        tag = f"[scenes {name}]"
        scene = make()
        world, pip = scene.world, scene.pipeline
        assert world.device.type == "cuda" and pip.device_coupling
        world.counters.enable()
        rec = dict(iters=[], share=[], live=[], t=[], overflow=[])
        user_cb = scene.callback

        def callback(s, i, t, rec=rec, user_cb=user_cb, world=world):
            # Before step i: the counters and diagnostics hold step i - 1.
            rec["t"].append(time.perf_counter())
            if i > 0:
                c = world.counters
                d = world.last_diagnostics.solver
                rec["iters"].append((d.pressure_iters, d.divergence_iters))
                rec["overflow"].append(
                    int(world.last_diagnostics.neighbor_overflow))
                rec["share"].append((c.cd.boundary_update_time.time
                                     + c.coupling_transmit_time.time)
                                    / c.step_time.time)
            if user_cb is not None:
                fl = world.fluids_state
                below = int((fl.alive & (fl.positions[:, 1] < -2.0)).sum())
                before = int(fl.alive.sum())
                user_cb(s, i, t)
                rec["live"].append((before, below,
                                    int(world.fluids_state.alive.sum())))

        scene.callback = callback
        reset_counts(pair)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenes.run(scene, SCENE_STEPS)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        c = world.counters
        d = world.last_diagnostics.solver
        rec["iters"].append((d.pressure_iters, d.divergence_iters))
        rec["overflow"].append(int(world.last_diagnostics.neighbor_overflow))
        rec["share"].append((c.cd.boundary_update_time.time
                             + c.coupling_transmit_time.time)
                            / c.step_time.time)
        if name == "basic2":
            launches = read_counts(pair)
        ms_all = (t_end - t0) / SCENE_STEPS * 1e3
        half = SCENE_STEPS // 2
        ms_last = (t_end - rec["t"][half]) / (SCENE_STEPS - half) * 1e3
        layout = resolved_layout(world)
        fl, bd = world.fluids_state, world.boundaries_state
        n = int(fl.alive.sum())
        n_b = int(bd.alive.sum())
        finite = (bool(torch.isfinite(fl.positions[fl.alive]).all())
                  and bool(torch.isfinite(fl.velocities[fl.alive]).all())
                  and bool(torch.isfinite(bd.positions[bd.alive]).all())
                  and rigid_state_finite(pip))
        poses = [b.translation.round(4).tolist()
                 for b in pip.sync_bodies().bodies if b.is_dynamic]
        share = statistics.median(rec["share"][half:])
        log(f"{tag} layout {layout}, coupling path "
            f"{'device' if pip.device_coupling else 'host'}, {n} fluid / "
            f"{n_b} boundary particles: {ms_all:.3f} ms/step over "
            f"{SCENE_STEPS} steps, {ms_last:.3f} over the last {half}; "
            f"coupling counters' share of a step (median, last {half}) "
            f"{share:.4f}")
        log(f"{tag} iterations per step (pressure, divergence): "
            f"{rec['iters']}; dynamic bodies at {poses}")
        gate = max(1, n // 1000)
        log(f"{tag} neighbor overflow per step {rec['overflow']} (gate < "
            f"{gate}), clamped {int(world.last_diagnostics.candidate_overflow)}"
            f" at the last step")
        assert finite, f"{tag} non-finite state"
        assert max(rec["overflow"]) < gate, f"{tag} overflow {rec['overflow']}"
        if name == "faucet3":
            fl_h = scene.fluid_handles[0]
            emits = faucet_schedule(SCENE_STEPS, scene.dt)
            for i, (before, below, after) in enumerate(rec["live"]):
                want = before - below + (100 if i in emits else 0)
                assert after == want, f"{tag} step {i}: {after} != {want}"
            assert n == 100 * len(emits), (n, emits)
            # The deletion half: the fluid moved down by 2 m + its median
            # height, then the scene's own callback.
            y = world.fluids_state.positions[world.fluids_state.alive][:, 1]
            world.transform_fluid_by(
                fl_h, None, (0.0, -(2.0 + float(torch.median(y))), 0.0))
            fl = world.fluids_state
            below = int((fl.alive & (fl.positions[:, 1] < -2.0)).sum())
            user_cb(scene, SCENE_STEPS, SCENE_STEPS * scene.dt)
            left = int(world.fluids_state.alive.sum())
            log(f"{tag} emitted at steps {emits} ({n} live after "
                f"{SCENE_STEPS} steps, as scheduled); moved down, {below} "
                f"of {n} below y = -2: the callback leaves {left}")
            assert 0 < below < n and left == n - below, (below, left)
            scene.step()
            assert bool(torch.isfinite(
                live_positions(world)).all()), f"{tag} non-finite"
        if name in ("basic2", "layers2"):
            gap, moved = tracks_bodies(scene)
            log(f"{tag} dynamic bodies' boundaries vs their poses: max "
                f"|d| {gap:.3e} m")
            assert gap <= RIGID_TOL, f"{tag} boundaries off their bodies"
            assert all(m[1] < 10.6 for m in moved), moved
        if name.startswith("custom_forces"):
            pos = live_positions(world)
            vel = world.fluids_state.velocities[world.fluids_state.alive]
            right = float(vel[pos[:, 0] > 0.05, 0].mean())
            left_v = float(vel[pos[:, 0] < -0.05, 0].mean())
            log(f"{tag} mean x velocity right of x = 0.05: {right:.4e}, "
                f"left of -0.05: {left_v:.4e} m/s")
            assert right > 0.0 and left_v < 0.0, f"{tag} attractors"
        busy, dev_ms = busy_share(world, steps=1, step=scene.step)
        log(f"{tag} 1 profiled step: device {dev_ms} ms/step, busy {busy}")
        rows[name] = dict(layout=layout, coupling="device", n=n,
                          boundary=n_b, ms=ms_all, ms_last=ms_last,
                          device_ms=dev_ms, busy=busy, iters=rec["iters"],
                          overflow=max(rec["overflow"]),
                          coupling_share=share, poses=poses)
        del scene, world, pip
        torch.cuda.empty_cache()
    # basic2 one step on each coupling path (no rigid contact yet: the
    # paths differ by float32 order; the device path's projection
    # tie-break (first index) never acts).
    # The host path's step sizes its caps before its ground's dynamic
    # sampling grows the boundary (ROADMAP Queue 3, item 19): it drops
    # entries at this first step, as the JAX package does; logged.
    state, over = {}, {}
    for use in (True, False):
        scene = scenes.basic2()
        scene.pipeline._device_request = use
        scene.step()
        over[use] = int(scene.world.last_diagnostics.neighbor_overflow)
        bodies = [b for b in scene.pipeline.sync_bodies().bodies
                  if b.is_dynamic]
        state[use] = (np.concatenate([np.concatenate(
            [b.translation, b.rotation.ravel(), b.linvel,
             np.atleast_1d(b.angvel)]) for b in bodies]),
            live_positions(scene.world).clone())
    gap_b = float(np.abs(state[True][0] - state[False][0]).max())
    gap_p = float((state[True][1] - state[False][1]).abs().max())
    log(f"[scenes basic2] one step on each coupling path: body state max "
        f"|d| {gap_b:.3e} (tol {RIGID_TOL}), positions {gap_p:.3e} m (atol "
        f"{PATH_POS_ATOL['dfsph']}); neighbor overflow device {over[True]}, "
        f"host {over[False]}")
    assert gap_b <= RIGID_TOL and gap_p <= PATH_POS_ATOL["dfsph"]
    assert over[True] == 0, "[scenes basic2] device path overflow"
    return rows, launches


def basic2_dense():
    """basic2 pinned to the dense layout (its world's ``sim.layout``; the
    scene builder has no layout argument): on the card ``auto`` resolves
    it to the brute tier, which runs no kernel."""
    from salva_tpu_torch import scenes

    scene = scenes.basic2()
    scene.world.sim = scene.world.sim.replace(layout="dense")
    return scene


def phase_twin_2d(pair):
    """2D on the card: basic2's dense twin TWIN_2D_STEPS steps through the
    kernels (its launch counts) and as many through the plain versions
    (substituted here: the pair passes, ``expand`` and the rigid solve),
    identical iterations, positions within PATH_POS_ATOL; then phase 5's
    cubic checks at dim = 2 at the kernel run's state. Returns (the
    launch counts, the 2D kernel records)."""
    tag = "[twin 2D]"
    runs = {}
    subs = plain_subs(pair)
    for kind in ("kernels", "plain"):
        scene = basic2_dense()
        reset_counts(pair)
        iters = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with substituted(subs if kind == "plain" else {}):
            for _ in range(TWIN_2D_STEPS):
                scene.step()
                d = scene.world.last_diagnostics
                iters.append((d.solver.pressure_iters,
                              d.solver.divergence_iters))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TWIN_2D_STEPS * 1e3
        runs[kind] = dict(scene=scene, iters=iters, ms=ms,
                          launches=read_counts(pair),
                          pos=live_positions(scene.world).clone())
    k, p = runs["kernels"], runs["plain"]
    world = k["scene"].world
    layout = resolved_layout(world)
    dpos = float((k["pos"] - p["pos"]).abs().max())
    d = world.last_diagnostics
    sb = float(world.boundaries_state.velocities.abs().max())
    log(f"{tag} basic2 (dim 2) on the {layout} layout, caps "
        f"{world._auto_caps}, window {world._effective_sim().fitted_dims}: "
        f"kernels {k['ms']:.3f} ms/step, plain {p['ms']:.3f} ms/step; "
        f"iterations {k['iters']} vs {p['iters']}; max |dpos| {dpos:.3e} m "
        f"(atol {PATH_POS_ATOL['dfsph']}); contacts ff "
        f"{int(d.ncontacts_ff)} fb {int(d.ncontacts_fb)}, overflow "
        f"{int(d.neighbor_overflow)}; boundary speeds up to {sb:.4f} m/s")
    log(f"{tag} launches: kernels run {k['launches']}, plain run "
        f"{p['launches']}")
    assert layout == "dense"
    for name in MAIN_PATH_KERNELS + ("rigid_solve",):
        assert k["launches"][name] > 0, f"{tag} {name} never launched"
    assert not any(p["launches"].values()), f"{tag} the plain run launched"
    assert k["iters"] == p["iters"], f"{tag} iterations differ"
    assert dpos <= PATH_POS_ATOL["dfsph"], f"{tag} positions differ {dpos}"
    del runs["plain"]
    mod = sys.modules[__name__]
    with substituted({(mod, "log"): lambda m: print(
            m.replace("[kernels]", "[kernels 2D]", 1), flush=True)}):
        results = phase_kernels(pair, world, full=False)
    return k["launches"], results


def phase_rigid_solve(pair):
    """The rigid solve kernel against its plain version on basic2's
    contact table: basic2's three dynamic bodies (box, ball, capsule),
    frozen on the device path, set 5 cm into the heightfield ground at
    their x, sliding (0.3, -1.0) m/s and spinning 0.5 rad/s, and their
    contacts found as the device step finds them. Velocities within
    RIGID_TOL, a bitwise rerun, two planted faults caught (friction off;
    one iteration instead of 8), times and the bound."""
    from salva_tpu_torch import scenes
    from salva_tpu_torch.ops import rigid
    from salva_tpu_torch.sampling.shape_sampling import _shape_aabb

    tag = "[rigid_solve]"
    scene = scenes.basic2()
    dev = scene.pipeline._maybe_device()
    rw = scene.pipeline.bodies
    rs = dev.rigid_state
    trans = rs.trans.clone()
    ground = next(c.shape for c in rw.colliders
                  if not rw.bodies[c.body].is_dynamic)
    for c in rw.colliders:
        if not rw.bodies[c.body].is_dynamic:
            continue
        lo, _ = _shape_aabb(c.shape, 2)
        x = trans[c.body, :1].cpu()
        trans[c.body, 1] = float(ground._height_at(x[None])[0]) - lo[1] - 0.05
    dyn = dev.dynamic_mask[:, None]
    rs = rs._replace(
        trans=trans,
        linvel=torch.where(dyn, torch.tensor([0.3, -1.0], device="cuda"),
                           0.0),
        angvel=torch.where(dev.dynamic_mask, 0.5, 0.0))
    con = dev._find_contacts_dev(rs, 0.0)
    count = int(con["count"])
    args = (rs.trans, rs.rot, rs.linvel, rs.angvel, dev.inv_mass,
            dev.inv_inertia, con["a"], con["b"], con["p"], con["n"],
            con["count"])
    consts = (dev.restitution, dev.friction, dev.contact_iterations)

    def kern(*c):
        return rigid.solve_contacts(*args, *(c or consts))

    def plain():
        return rigid.solve_contacts_plain(*args, *consts)

    reset_counts(pair)
    out, ref = kern(), plain()
    assert read_counts(pair)["rigid_solve"] == 1
    again = kern()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), \
        f"{tag} not bitwise deterministic"
    errs = [check_output(f"rigid_solve.{o}", got, want,
                         dict(rtol=0.0, atol=RIGID_TOL))[0]
            for o, got, want in zip(("linvel", "angvel"), out, ref)]
    for fault, c in (("friction off", (consts[0], 0.0, consts[2])),
                     ("one iteration", (consts[0], consts[1], 1))):
        wrong = kern(*c)
        assert any(not torch.allclose(w, r, rtol=0.0, atol=RIGID_TOL)
                   for w, r in zip(wrong, ref)), f"{tag} fault {fault}"
        log(f"{tag} planted fault '{fault}' caught")
    ms = cuda_ms(kern, 50)
    one = call_ms(kern, 20)
    plain_ms = cuda_ms(plain, 3)
    # The bound counts what this table needs: the bodies, the live rows
    # of the contact table and its count read once, the velocities
    # written once; the impulses the plain version applied, each at its
    # own body count.
    tally = {}
    rigid.solve_contacts_plain(*args, *consts, tally=tally)
    rows = (con["a"], con["b"], con["p"], con["n"])
    read = (nbytes(args[:6]) + nbytes(t[:count] for t in rows)
            + con["count"].element_size())
    written = nbytes(out)
    ops = sum(OPS_RIGID_IMPULSE[2][k] * v for k, v in tally.items())
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = ops / FP32_OPS_PER_S
    b_ms = max(t_bytes, t_ops) * 1e3
    b_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"{tag} basic2's table: {count} contacts of {dev.max_contacts}, "
        f"{consts[2]} iterations; max abs err linvel {errs[0]:.3e}, angvel "
        f"{errs[1]:.3e} (atol {RIGID_TOL}); kernel {ms:.4f} ms device time "
        f"({one:.4f} ms a call), plain {plain_ms:.4f} ms; bound "
        f"{b_ms:.3e} ms ({b_by}; {read} B read, {written} B written, "
        f"{ops} float32 operations for the impulses applied "
        f"{dict((f'{k[0]}/{k[1]}', v) for k, v in sorted(tally.items()))}):"
        f" one dependent chain, bound by latency")
    assert count > 3, f"{tag} only {count} contacts"
    return dict(max_abs_err=max(errs), ms=ms, call_ms=one,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, contacts=count,
                impulses={f"{k[0]}/{k[1]}": v for k, v in tally.items()})


def adaptive_record(world):
    """(substeps, (pressure, divergence) iterations, overflow) of the
    world's last step."""
    s_ = world.last_diagnostics.solver
    return (world.counters.nsubsteps,
            (s_.pressure_iters, s_.divergence_iters),
            int(world.last_diagnostics.neighbor_overflow))


def same_state(a, b):
    fa, fb = a.fluids_state, b.fluids_state
    return (torch.equal(fa.positions, fb.positions)
            and torch.equal(fa.velocities, fb.velocities)
            and torch.equal(fa.alive, fb.alive))


def phase_adaptive_ckpt(pair):
    """Phase 13, adaptive_ckpt_97k: bench.py's dam break at 97,336
    particles with dfsph_97k_visc's forces (``FORCES``), DFSPH on the dense
    layout, ``adaptive_timestep=True`` and ``debug_checks=True``,
    ADAPTIVE_STEPS steps of ADAPTIVE_DT through ``LiquidWorld.step``. Per
    step: substeps, iterations, overflow against the max(1, N // 1000)
    gate, ms/step; a second fresh world takes the same steps under the
    profiler (each step's device busy share) and must end bitwise equal.
    Fails if no step split. After step CKPT_AFTER the world is saved with
    ``io.save_world`` (the file's size logged) and loaded into a fresh
    world on the card with ``io.load_world``; both then take the remaining
    steps, bitwise equal with identical substeps and iterations at every
    step. A plain twin (every kernel wrapper replaced by its plain
    version) runs to the first split step: the same substeps and
    iterations on every step, its gap to the kernel run logged; the split
    step alone, from the kernel run's state and from the plain twin's,
    within PATH_POS_ATOL of the plain versions' step; two witnesses of the
    gap's cause logged beside it. Then phase
    5's cubic checks at the path's state after its last step."""
    import tempfile

    from salva_tpu_torch import io as tio

    tag = "[adaptive_ckpt_97k]"

    def fresh():
        w = dam_break_world("cuda", "dfsph", forces=FORCES, adaptive=True)
        w.debug_checks = True
        return w

    world = fresh()
    n = int(world.fluids_state.alive.sum())
    gate = max(1, n // 1000)
    assert world.timestep_manager.adaptive and world.device.type == "cuda"
    reset_counts(pair)
    recs, ms, kernel_pos, restored, ckpt_bytes = [], [], [], None, 0
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    path = os.path.join(tmp, "adaptive_ckpt_97k.npz")
    # The state before the first split step, for the plain twin's step
    # from the same input (saved before every step until one splits).
    pre_split = os.path.join(tmp, "pre_split.npz")
    tio.save_world(world, pre_split)
    for i in range(ADAPTIVE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world.step(ADAPTIVE_DT, GRAVITY)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        recs.append(adaptive_record(world))
        kernel_pos.append(world.fluids_state.positions.clone())
        if all(r[0] == 1 for r in recs):
            tio.save_world(world, pre_split)
        if restored is not None:
            restored.step(ADAPTIVE_DT, GRAVITY)
            again = adaptive_record(restored)
            same = same_state(world, restored)
            log(f"{tag} step {i + 1}: the resumed world "
                f"{'equals' if same else 'DIFFERS from'} the "
                f"uninterrupted one bitwise; substeps / iterations / "
                f"overflow {again} vs {recs[-1]}")
            assert same and again == recs[-1], f"{tag} resume differs"
        if i + 1 == CKPT_AFTER:
            t1 = time.perf_counter()
            tio.save_world(world, path)
            save_s = time.perf_counter() - t1
            ckpt_bytes = os.path.getsize(path)
            t1 = time.perf_counter()
            restored = tio.load_world(path)
            load_s = time.perf_counter() - t1
            assert restored.device.type == "cuda"
            assert same_state(world, restored)
            log(f"{tag} saved after step {i + 1}: {ckpt_bytes} bytes "
                f"in {save_s:.3f} s, loaded on the card in "
                f"{load_s:.3f} s (adaptive "
                f"{restored.timestep_manager.adaptive}, debug checks "
                f"{restored.debug_checks}, caps {restored._auto_caps}, "
                f"window {restored._fitted_dims})")
    launches = read_counts(pair)
    for i, (rec, t) in enumerate(zip(recs, ms)):
        log(f"{tag} step {i + 1}: {rec[0]} substeps, iterations (pressure, "
            f"divergence) {rec[1]}, overflow {rec[2]} (gate < {gate}), "
            f"{t:.3f} ms")
    log(f"{tag} N={n}: {sum(ms) / len(ms):.3f} ms/step over "
        f"{ADAPTIVE_STEPS} steps of {ADAPTIVE_DT:.6f} s "
        f"({sum(r[0] for r in recs)} substeps); caps {world._auto_caps}, "
        f"window {world._fitted_dims}, grid refits {world.grid_refit_count}"
        f"; kernel launches (the timed and the resumed world's steps): "
        f"{launches}")
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    assert all(r[2] < gate for r in recs), f"{tag} overflow gate"
    split = [i for i, r in enumerate(recs) if r[0] > 1]
    assert split, f"{tag} no step took more than one substep: {recs}"
    del restored
    torch.cuda.empty_cache()

    # Per-step busy share: a second fresh world under the profiler.
    busy, dev_ms = [], []
    twin = fresh()
    for _ in range(ADAPTIVE_STEPS):
        b, d = busy_share(twin, steps=1,
                          step=lambda: twin.step(ADAPTIVE_DT, GRAVITY))
        busy.append(None if b is None else round(b, 4))
        dev_ms.append(None if d is None else round(d, 3))
    same = same_state(world, twin)
    log(f"{tag} a second run under the profiler: device busy share per "
        f"step {busy}, device ms per step {dev_ms}; end state bitwise equal "
        f"to the timed run: {same}")
    assert same, f"{tag} two runs differ"
    del twin
    torch.cuda.empty_cache()

    # The plain twin (every kernel wrapper replaced by its plain version):
    # from step 1 to the first split step, the same substeps and
    # iterations on every step, its gap to the kernel run logged per step;
    # then the first split step alone from the kernel run's state before
    # it, positions within PATH_POS_ATOL. Two witnesses of the gap's
    # cause: the kernel run's split step taken from the plain twin's state
    # before it (the kernels on both sides; the input gap is the earlier
    # steps' summation order), and from the kernel run's own state with
    # every live x nudged by one ulp. If either drifts from the kernel run
    # as far as the plain twin does, the gap is the state's amplification
    # of rounding, not a kernel fault; the split step from the plain
    # twin's state is also taken by the plain versions, a second one-step
    # hold.
    first = split[0]
    alive = world.fluids_state.alive

    def gap(pos, i):
        return float((pos[alive] - kernel_pos[i][alive]).abs().max())

    plain_pre = os.path.join(tmp, "plain_pre_split.npz")
    reset_counts(pair)
    with substituted(plain_subs(pair)):
        plain = fresh()
        plain_recs, plain_gaps = [], []
        for i in range(first + 1):
            if i == first:
                tio.save_world(plain, plain_pre)
            plain.step(ADAPTIVE_DT, GRAVITY)
            plain_recs.append(adaptive_record(plain))
            plain_gaps.append(gap(plain.fluids_state.positions, i))
        del plain
        plain = tio.load_world(pre_split)
        plain.step(ADAPTIVE_DT, GRAVITY)
        split_rec = adaptive_record(plain)
        dpos = gap(plain.fluids_state.positions, first)
        del plain
        plain = tio.load_world(plain_pre)
        in_gap = (gap(plain.fluids_state.positions, first - 1)
                  if first else 0.0)
        plain.step(ADAPTIVE_DT, GRAVITY)
        plain_on_plain = plain.fluids_state.positions.clone()
    plain_launches = read_counts(pair)
    del plain
    witness = tio.load_world(plain_pre)
    witness.step(ADAPTIVE_DT, GRAVITY)
    from_plain = gap(witness.fluids_state.positions, first)
    hold2 = float((witness.fluids_state.positions[alive]
                   - plain_on_plain[alive]).abs().max())
    witness_rec = adaptive_record(witness)
    del witness, plain_on_plain
    nudged = tio.load_world(pre_split)
    fl = nudged.fluids_state
    x = fl.positions
    bumped = torch.stack([torch.nextafter(x[:, 0], torch.full_like(
        x[:, 0], float("inf"))), x[:, 1], x[:, 2]], dim=1)
    nudged.fluids_state = fl.replace(
        positions=torch.where(fl.alive[:, None], bumped, x))
    nudged.step(ADAPTIVE_DT, GRAVITY)
    from_nudge = gap(nudged.fluids_state.positions, first)
    nudge_rec = adaptive_record(nudged)
    del nudged
    tmp_dir.cleanup()
    log(f"{tag} plain twin from step 1 to the first split step "
        f"({first + 1}): {plain_recs} vs the kernels' {recs[:first + 1]}; "
        f"max |dpos| per step {[f'{g:.3e}' for g in plain_gaps]} m "
        f"(logged); the split step alone from the kernel run's state "
        f"before it: {split_rec} vs {recs[first]}, max |dpos| {dpos:.3e} m "
        f"(atol {PATH_POS_ATOL['dfsph']}); launches {plain_launches}")
    log(f"{tag} witnesses, step {first + 1} through the kernels: from the "
        f"plain twin's state before it ({in_gap:.3e} m from the kernel "
        f"run's) {witness_rec}, {from_plain:.3e} m from the kernel run "
        f"and {hold2:.3e} m from the plain versions' step on that state "
        f"(atol {PATH_POS_ATOL['dfsph']}); from the kernel run's state "
        f"with every live x one ulp up {nudge_rec}, {from_nudge:.3e} m "
        f"from the kernel run")
    assert not any(plain_launches.values()), f"{tag} the plain run launched"
    assert [r[:2] for r in plain_recs] == [r[:2] for r in recs[:first + 1]], \
        f"{tag} plain substeps / iterations differ"
    assert split_rec[:2] == recs[first][:2], f"{tag} plain split step"
    assert dpos <= PATH_POS_ATOL["dfsph"], f"{tag} plain positions {dpos}"
    assert hold2 <= PATH_POS_ATOL["dfsph"], \
        f"{tag} kernels vs plain on the plain twin's state {hold2}"
    del kernel_pos
    torch.cuda.empty_cache()

    mod = sys.modules[__name__]
    with substituted({(mod, "log"): lambda m: print(
            m.replace("[kernels]", "[kernels adaptive]", 1), flush=True)}):
        checks = phase_kernels(pair, world, full=False)
    del world
    torch.cuda.empty_cache()
    return dict(n=n, ms=ms, records=recs, busy=busy, device_ms=dev_ms,
                ckpt_bytes=ckpt_bytes, launches=launches, kernels=checks,
                plain_gaps=plain_gaps, split_gap=dpos,
                witness_gaps=dict(input=in_gap, from_plain_state=from_plain,
                                  from_nudge=from_nudge, hold=hold2))


def icosphere(subdivisions=2, radius=MESH_RADIUS):
    """A closed icosphere of 20 * 4^subdivisions triangles: (float32
    vertices, int32 indices)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mids, out = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = out
    return ((np.asarray(verts) * radius).astype(np.float32),
            np.asarray(faces, np.int32))


def mesh_pipeline(mesh, samples):
    """bench.py's dam break inside a FluidsPipeline on the card (the
    device coupling path): the block lifted by MESH_LIFT (the domain's top
    with it) over the sampled Cuboid floor, and ``mesh`` on two fixed
    bodies resting on the floor, static-sampled (``samples``) at x =
    -MESH_X and with DynamicContactSampling at x = +MESH_X; the boundary
    cap MESH_CAP_B. Returns the pipeline, the domain and the two bodies'
    translations."""
    from salva_tpu_torch import scenes, shapes
    from salva_tpu_torch.coupling import ColliderSampling, FluidsPipeline
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.world import Boundary, Fluid

    n_side = round(N_TARGET ** (1.0 / 3.0))
    radius = 0.05
    half = n_side * radius
    wall = max(1.5 * half, half + 0.5)
    domain = ((-wall - 0.3, -0.4, -wall - 0.3),
              (wall + 0.3, 2.0 * half + 1.0 + MESH_LIFT, wall + 0.3))
    pip = FluidsPipeline(radius, 2.0, dim=3, domain=domain)
    world = pip.liquid_world
    world._dense_cap_boundary_request = MESH_CAP_B
    pos = scenes.cube_fluid((n_side,) * 3, radius)
    pos[:, 1] += half + radius + MESH_LIFT
    vel = np.zeros_like(pos)
    vel[:, 1] = -2.0
    world.add_fluid(Fluid(pos, density0=1000.0, velocities=vel,
                          nonpressure_forces=[]))
    floor = shape_surface_sample(shapes.Cuboid((wall, 0.1, wall)), radius, 3)
    floor[:, 1] -= 0.1
    world.add_boundary(Boundary(floor))
    poses = []
    for x, sampling in ((-MESH_X, ColliderSampling.static_sampling(samples)),
                        (MESH_X, ColliderSampling.dynamic_contact_sampling())):
        t = np.float32([x, MESH_RADIUS, 0.0])
        body = pip.bodies.add_body("fixed", translation=t)
        co = pip.bodies.add_collider(body, mesh)
        bo = world.add_boundary(Boundary(np.zeros((0, 3))))
        pip.coupling.register_coupling(bo, co, sampling)
        poses.append(t)
    return pip, domain, poses


def host_query_check(world, mesh, mesh_field, pose, box):
    """A card-vs-CPU consistency check of the queries: the shape query of
    ``world`` with ``mesh`` (answered through its voxelized field on the
    card) and its box query against the same field evaluated in float64
    on the CPU and the same box in numpy float64: hits equal except where
    the CPU's distance lies within QUERY_TIE of the particle radius.
    Returns the counts."""
    from salva_tpu_torch.world import _slot_ids

    r = world.particle_radius
    eye = np.eye(3, dtype=np.float32)
    got_shape = world.particles_intersecting_shape(mesh, eye, pose)
    got_box = world.particles_intersecting_aabb(*box)
    want_shape, want_box, ties = [], [], 0
    for kind, state, alive, owner in world._query_sets():
        pos = state.positions.cpu().numpy()
        d = mesh_field.sdf(torch.from_numpy(pos - pose).double()).numpy()
        hits = np.where(alive & (d <= r))[0]
        ties += int((alive & (np.abs(d - r) <= QUERY_TIE)).sum())
        want_shape.extend(_slot_ids(kind, owner, alive, hits))
        p64 = pos.astype(np.float64)
        off = p64 - np.clip(p64, box[0], box[1])
        near = np.sqrt((off * off).sum(-1)) < r
        want_box.extend(_slot_ids(kind, owner, alive,
                                  np.where(alive & near)[0]))
    diff = len(set(got_shape) ^ set(want_shape))
    assert diff <= ties, f"shape query: {diff} hits differ, {ties} ties"
    assert got_box == want_box, "box query differs from the host's"
    return len(got_shape), len(want_shape), len(got_box), ties


def phase_trimesh_queries(pair):
    """Phase 14, trimesh_and_queries: an icosphere of 320 triangles
    (radius MESH_RADIUS) voxelized on the card (``trimesh_sdf``, resolution
    48) and sampled by the native surface sampler (its g++ build timed
    apart), in the 97,336-particle dam break on the device coupling path
    (``mesh_pipeline``): static sampling on one body, DynamicContactSampling
    through the VoxelSdf on the other. MESH_STEPS steps of DT with the
    world's counters on, each gated as phase 11 (overflow, finite state,
    the fluid inside the domain): ms/step, the coupling counters' share of
    the step, the emitted contact samples per step, the kernel launches.
    Then ``particles_intersecting_shape(mesh)`` and
    ``particles_intersecting_aabb`` against the same field and box
    evaluated on the CPU (a card-vs-CPU consistency check; the CPU tests
    hold the queries to the JAX package), phase 5's cubic checks at this
    state, the device busy share over two profiled steps and two steps
    split by stage (``stage_split``). Last, ``z_sort`` on the gather_dfsph world and
    ZSORT_STEPS steps beside an unsorted twin, matched by particle:
    identical iterations, positions within PATH_POS_ATOL."""
    from salva_tpu_torch import native, shapes
    from salva_tpu_torch.ops import _build
    from salva_tpu_torch.sampling import shape_surface_sample
    from salva_tpu_torch.sampling.voxelize import trimesh_sdf

    tag = "[trimesh_and_queries]"
    v, f = icosphere()
    mesh = shapes.TriMesh.from_arrays(v, f)
    assert len(mesh.indices) == 320
    t0 = time.perf_counter()
    lib = _build.build_host(native._SOURCE)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = shape_surface_sample(mesh, 0.05, 3)
    sample_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = trimesh_sdf(mesh, resolution=48, device="cuda")
    torch.cuda.synchronize()
    vox_s = time.perf_counter() - t0
    # The field on the card against the same arithmetic on the CPU, at a
    # resolution the CPU evaluates in seconds.
    small_card = trimesh_sdf(mesh, resolution=12, device="cuda")
    small_cpu = trimesh_sdf(mesh, resolution=12, device="cpu")
    vox_same = np.array_equal(small_card.values, small_cpu.values)
    log(f"{tag} mesh: {len(v)} vertices, {len(f)} triangles; sampler built "
        f"in {build_s:.2f} s ({lib.name}), {len(samples)} surface samples "
        f"in {sample_s:.4f} s; voxelized on the card at resolution 48 "
        f"({field.shape}, spacing {field.spacing:.5f} m) in {vox_s:.3f} s; "
        f"the card's field at resolution 12 bitwise equal to the CPU's: "
        f"{vox_same}")
    assert vox_same, f"{tag} the card's voxelization differs from the CPU's"
    assert len(samples) > 100

    pip, domain, poses = mesh_pipeline(mesh, samples)
    world = pip.liquid_world
    n = int(world.fluids_state.alive.sum())
    gate = max(1, n // 1000)
    assert pip.device_coupling and world.device.type == "cuda"
    world.counters.enable()
    reset_counts(pair)
    recs, step_ms, share = [], [], []
    for i in range(MESH_STEPS):
        pip.step(GRAVITY, DT)
        c = world.counters
        step_ms.append(c.step_time.time * 1e3)
        coupling_ms = (c.cd.boundary_update_time.time
                       + c.coupling_transmit_time.time) * 1e3
        share.append(coupling_ms / step_ms[-1])
        d = world.last_diagnostics
        dyn = pip._device.dynamic_entries[0]
        emitted = int(world.boundaries_state.alive[dyn["slots"]].sum())
        pos = live_positions(world)
        lo = torch.tensor(domain[0], device="cuda")
        hi = torch.tensor(domain[1], device="cuda")
        inside = bool(((pos >= lo) & (pos <= hi)).all())
        finite = bool(torch.isfinite(pos).all())
        over = int(d.neighbor_overflow)
        bd = world.boundaries_state
        occ_b = world._max_cell_occupancy(bd.positions, bd.alive)
        recs.append((over, emitted, (d.solver.pressure_iters,
                                     d.solver.divergence_iters), occ_b))
        log(f"{tag} step {i + 1}: {step_ms[-1]:.3f} ms, coupling share "
            f"{share[-1]:.4f}, contact samples emitted {emitted}, overflow "
            f"{over} (gate < {gate}), iterations {recs[-1][2]}, boundary "
            f"cell occupancy {occ_b} (cap {MESH_CAP_B}), finite {finite}, "
            f"inside the domain {inside}")
        assert over < gate and finite and inside, f"{tag} step {i + 1} gate"
        assert occ_b <= MESH_CAP_B, f"{tag} boundary occupancy {occ_b}"
    launches = read_counts(pair)
    log(f"{tag} N={n}, {int(world.boundaries_state.alive.sum())} boundary "
        f"particles: {sum(step_ms) / MESH_STEPS:.3f} ms/step, coupling "
        f"share {sum(share) / MESH_STEPS:.4f}; layout "
        f"{resolved_layout(world)}, caps {world._resolved_dense_caps()}; "
        f"launches {launches}")
    for k in MAIN_PATH_KERNELS:
        assert launches[k] > 0, f"{k} was never launched on {tag}"
    assert max(r[1] for r in recs) > 0, f"{tag} no contact sample emitted"
    box = (np.array([-2.0, 0.0, -0.5]), np.array([2.0, 1.2, 0.5]))
    counts = host_query_check(world, mesh, field, poses[1], box)
    log(f"{tag} queries: the mesh at x = +{MESH_X} holds {counts[0]} "
        f"particles (the same field on the CPU {counts[1]}, {counts[3]} "
        f"ties within {QUERY_TIE}); the box {box[0].tolist()}.."
        f"{box[1].tolist()} holds {counts[2]} (the CPU's box test equal)")
    # Phase 5's cubic checks at this state: the boundary cap MESH_CAP_B
    # and an fb table that holds the projected contact samples.
    mod = sys.modules[__name__]
    with substituted({(mod, "log"): lambda m: print(
            m.replace("[kernels]", "[kernels mesh]", 1), flush=True)}):
        checks = phase_kernels(pair, world, full=False)
    # Where the step's time goes: the device busy share over two profiled
    # steps, then two steps split by stage.
    busy, dev_ms = busy_share(world, step=lambda: pip.step(GRAVITY, DT))
    stages, sync_ms = stage_split(lambda: pip.step(GRAVITY, DT))
    log(f"{tag} 2 profiled steps: device {dev_ms} ms/step, busy {busy}; "
        f"2 steps split by stage, {sync_ms:.3f} ms/step with a synchronize "
        f"around each stage: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items())
        + f", the rest {sync_ms - sum(stages.values()):.3f}")
    assert world.last_diagnostics.neighbor_overflow < gate, \
        f"{tag} overflow in the profiled steps"
    del pip, world
    torch.cuda.empty_cache()

    # z_sort on the gather layout beside an unsorted twin.
    sorted_w, twin = path_world("gather_dfsph"), path_world("gather_dfsph")
    t0 = time.perf_counter()
    perm = sorted_w.z_sort()
    torch.cuda.synchronize()
    zs_s = time.perf_counter() - t0
    moved = int((perm != np.arange(len(perm))).sum())
    perm_t = torch.as_tensor(perm, device="cuda")
    its = []
    for _ in range(ZSORT_STEPS):
        for w in (sorted_w, twin):
            w.step(DT, GRAVITY)
        its.append(tuple((w.last_diagnostics.solver.pressure_iters,
                          w.last_diagnostics.solver.divergence_iters)
                         for w in (sorted_w, twin)))
    alive = sorted_w.fluids_state.alive
    assert torch.equal(alive, twin.fluids_state.alive[perm_t])
    dpos = float((sorted_w.fluids_state.positions[alive]
                  - twin.fluids_state.positions[perm_t][alive]).abs().max())
    log(f"{tag} z_sort of the gather_dfsph world in {zs_s:.3f} s ({moved} "
        f"slots moved); {ZSORT_STEPS} steps beside the unsorted twin: "
        f"iterations (sorted, unsorted) {its}; max |dpos| by particle "
        f"{dpos:.3e} m (atol {PATH_POS_ATOL['dfsph']})")
    assert moved > 0
    assert all(a == b for a, b in its), f"{tag} z_sort iterations differ"
    assert dpos <= PATH_POS_ATOL["dfsph"], f"{tag} z_sort positions {dpos}"
    del sorted_w, twin
    torch.cuda.empty_cache()
    return dict(n=n, ms=step_ms, coupling_share=share, records=recs,
                voxelize_s=vox_s, sample_s=sample_s, build_s=build_s,
                launches=launches, queries=counts, zsort_gap=dpos,
                busy=busy, device_ms=dev_ms, stages=stages,
                sync_ms=sync_ms, kernels=checks)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from salva_tpu_torch.ops import _build, pair

    # Warnings (a dense cap grown after an overflow, say) go to stdout, in
    # order with the phase that raised them.
    warnings.showwarning = (
        lambda message, category, *_: log(
            f"[warning] {category.__name__}: {message}"))
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
    for name, spec in PATHS.items():
        if (name in ("dfsph", "dfsph_implicit_visc")
                or spec.get("layout") == "gather"):
            continue
        t0 = time.perf_counter()
        other, run = phase_main_path(pair, name)
        if spec.get("forces") == ELASTIC:
            elastic_share(other, run["ms"], f"[main {name}]")
        del other
        torch.cuda.empty_cache()
        paths[name] = run["launches"]
        log(f"[main {name}] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    visc = phase_implicit_visc(pair, world)
    paths["dfsph_implicit_visc"] = visc["launches"]
    torch.cuda.empty_cache()
    log(f"[main dfsph_implicit_visc] phase took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_kernels(pair, world)
    del world
    torch.cuda.empty_cache()
    log(f"[kernels] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sparse_run = phase_path_parity(pair, "dfsph")
    phase_expand_vs_gather(pair, sparse_run)
    for name in ("iisph", "dfsph_forces", "iisph_forces",
                 "dfsph_poly6_spiky", "dfsph_tension"):
        phase_path_parity(pair, name)
    log(f"[parity] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["dfsph_full_grid"] = phase_full_grid(pair, sparse_run)
    log(f"[full grid] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    layout_paths, layouts = phase_layouts_97k(pair)
    paths.update(layout_paths)
    small_paths, small = phase_small_overflow(pair)
    paths.update(small_paths)
    log("[layouts_97k] summary " + json.dumps(
        {"layouts_97k": layouts, "small_4k": small}))
    log(f"[layouts_97k] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slab_world = dam_break_world("cuda", "dfsph", sparse_boundary=False,
                                 dense_caps=(16, 16))
    slab = phase_slab_path(pair, "slab_97k", slab_world, SLAB_STEPS,
                           SLAB_HOLD_AT, PATH_POS_ATOL["dfsph"])
    paths["slab_97k"] = slab["launches"]
    kernels_slab = slab_kernel_checks(pair, slab_world, slab)
    del slab_world, slab
    torch.cuda.empty_cache()
    slab_iisph = phase_slab_path(
        pair, "slab_97k_iisph_forces",
        dam_break_world("cuda", "iisph", sparse_boundary=False,
                        forces=FORCES, dense_caps=(16, 16)),
        SLAB_IISPH_STEPS, SLAB_IISPH_STEPS, PATH_POS_ATOL["iisph"])
    paths["slab_97k_iisph_forces"] = slab_iisph["launches"]
    del slab_iisph
    torch.cuda.empty_cache()
    log(f"[slab_97k] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mig_world = dam_break_world("cuda", "dfsph", sparse_boundary=False,
                                dense_caps=(16, 16))
    migrate = phase_slab_migrate(pair, mig_world)
    paths["slab_97k_migrate"] = migrate["launches"]
    kernels_migrate = slab_kernel_checks(pair, mig_world, migrate,
                                         migrate=True)
    del mig_world, migrate
    torch.cuda.empty_cache()
    phase_slab_migrate_elastic(pair)
    torch.cuda.empty_cache()
    phase_dryrun()
    log(f"[slab_97k_migrate] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.update(phase_brute(pair))
    log(f"[brute] phase took {time.perf_counter() - t0:.1f} s")
    # The coupled phases: 2D on the card first (its phase-5 checks profile
    # one hoist call, as phase 5 does, before any stepping profile).
    t0 = time.perf_counter()
    paths["twin_2d"], kernels_2d = phase_twin_2d(pair)
    log(f"[twin 2D] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels["rigid_solve"] = phase_rigid_solve(pair)
    log(f"[rigid_solve] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    harness = phase_coupled_harness(pair)
    paths["coupled_harness"] = harness.pop("launches")
    kernels_harness = harness.pop("kernels")
    log(f"[coupled_harness] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    scene_rows, paths["scenes_basic2"] = phase_scenes(pair)
    log(f"[scenes] phase took {time.perf_counter() - t0:.1f} s")
    log("[coupled] summary " + json.dumps(
        {"coupled_harness": harness, "scenes": scene_rows}))
    # The gather phases come last: their busy share profiles the steps,
    # and with those profiles taken before phase 5, its profiles of one
    # hoist call came back without device events on an H100.
    for name, spec in PATHS.items():
        if spec.get("layout") != "gather":
            continue
        t0 = time.perf_counter()
        run = phase_gather_path(pair, name, rerun=name == "gather_dfsph")
        paths[name] = run["launches"]
        log(f"[main {name}] phase took {time.perf_counter() - t0:.1f} s")
    for name in GATHER_ONE_STEP:
        t0 = time.perf_counter()
        paths[name] = phase_gather_short(pair, name)["launches"]
        log(f"[short {name}] phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    adaptive = phase_adaptive_ckpt(pair)
    paths["adaptive_ckpt_97k"] = adaptive.pop("launches")
    kernels_adaptive = adaptive.pop("kernels")
    log(f"[adaptive_ckpt_97k] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh = phase_trimesh_queries(pair)
    paths["trimesh_and_queries"] = mesh.pop("launches")
    kernels_mesh = mesh.pop("kernels")
    log(f"[trimesh_and_queries] phase took {time.perf_counter() - t0:.1f} s")
    log("[host world] summary " + json.dumps(
        {"adaptive_ckpt_97k": adaptive, "trimesh_and_queries": mesh}))

    records = []
    for name, k in kernels.items():
        if name == "k_pass_v2":
            on, launches = "phase 5 checks (no main path runs it)", \
                k["check_launches"]
        elif name == "rigid_solve":
            on = "scenes_basic2"
            launches = paths[on][name]
        else:
            on, launches = "dfsph_forces", paths["dfsph_forces"][name]
        extra = {key: k[key] for key in ("kernel_names", "by_kernel",
                                         "full_grid", "fluid", "boundary",
                                         "contacts", "impulses")
                 if key in k}
        if name in kernels_slab:
            extra["slab"] = dict(kernels_slab[name],
                                 launches=paths["slab_97k"][name],
                                 launches_path="slab_97k")
        if name in kernels_migrate:
            extra["slab_migrate"] = dict(
                kernels_migrate[name],
                launches=paths["slab_97k_migrate"][name],
                launches_path="slab_97k_migrate")
        for label, checks, path in (("dim2", kernels_2d, "twin_2d"),
                                    ("harness", kernels_harness,
                                     "coupled_harness"),
                                    ("adaptive", kernels_adaptive,
                                     "adaptive_ckpt_97k"),
                                    ("mesh", kernels_mesh,
                                     "trimesh_and_queries")):
            if name not in checks:
                continue
            k2 = checks[name]
            extra[label] = dict(
                {key: k2[key] for key in (
                    "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                    "bound_by", "full_grid", "boundary") if key in k2},
                launches=paths[path][name], launches_path=path)
        records.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=launches,
            launches_path=on,
            launches_by_path={p: c.get(name, 0) for p, c in paths.items()},
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
