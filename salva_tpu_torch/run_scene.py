"""Headless scene runner of the port: the harness analog of the
reference's ``all_examples2`` / ``all_examples3`` launchers and
``FluidsHarnessPlugin`` (``examples3d/all_examples3.rs``,
``harness_plugin.rs:42-75``), and with ``--render`` the testbed plugin's
frames (``viz``).

Usage::

    python -m salva_tpu_torch.run_scene --list
    python -m salva_tpu_torch.run_scene basic3 --steps 200 [--profile]
    python -m salva_tpu_torch.run_scene basic2 --steps 20 --device cpu \\
        --render frames --every 10

The scene runs on the card unless ``--device cpu`` is passed. Rendering
needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    from . import scenes as scn

    ap = argparse.ArgumentParser(prog="python -m salva_tpu_torch.run_scene")
    ap.add_argument("scene", nargs="?", help="scene name")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="enable the per-stage counters")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--render", metavar="DIR", default=None,
                    help="write a PNG frame every --every steps to DIR")
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--mode", default="velocity",
                    choices=["static", "velocity", "arrows"])
    ap.add_argument("--boundaries", action="store_true",
                    help="render the boundary particles too")
    args = ap.parse_args(argv)

    if args.list or not args.scene:
        print("\n".join(sorted(scn.SCENES)))
        return 0
    if args.scene not in scn.SCENES:
        print(f"unknown scene {args.scene!r}; available:", file=sys.stderr)
        print("\n".join(sorted(scn.SCENES)), file=sys.stderr)
        return 2
    scene = scn.SCENES[args.scene](device=args.device)
    if args.profile:
        scene.world.counters.enable()
    if args.render:
        from .viz import RenderOptions, render_frame

        os.makedirs(args.render, exist_ok=True)
        opt = RenderOptions(mode=args.mode,
                            render_boundary_particles=args.boundaries)

    t0 = time.perf_counter()
    for i in range(args.steps):
        if scene.callback is not None:
            scene.callback(scene, i, i * scene.dt)
        scene.step()
        if (i + 1) % 50 == 0 or i == 0:
            d = scene.world.last_diagnostics
            n = sum(len(scene.world.fluid_positions(h))
                    for h in scene.fluid_handles)
            print(f"step {i + 1:5d}  particles={n}  "
                  f"pressure_iters={int(d.solver.pressure_iters)}  "
                  f"density_err={float(d.solver.pressure_error):.4f}")
        if args.render and (i + 1) % args.every == 0:
            scene.pipeline.sync_bodies()
            path = os.path.join(args.render,
                                f"{args.scene}_{i + 1:05d}.png")
            render_frame(scene.world, path, opt,
                         title=f"{args.scene} step {i + 1}")
            print(path)
    dt_wall = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt_wall:.2f}s "
          f"({dt_wall / max(args.steps, 1) * 1e3:.1f} ms/step)")
    if args.profile:
        print(scene.world.counters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
