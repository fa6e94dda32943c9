"""Headless visualization — the renderer-plugin slot.

Port of ``salva_tpu.viz``. The reference ships a bevy testbed plugin
(``src/integrations/rapier/testbed_plugin.rs``) with per-particle entities,
color modes (StaticColor / VelocityColor / VelocityArrows, `:46-71`) and a
per-step profiling string (`:508-510`). Headless TPU has no interactive
window; the equivalent here renders frames to PNG via matplotlib's Agg
backend with the same color modes, driven from the scene runner
(``python -m salva_tpu_torch.run_scene <scene> --render DIR``). The
particle arrays are fetched from the world's device once a frame;
matplotlib is imported only inside :func:`render_frame`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RenderOptions:
    """Color modes mirror `FluidsRenderingMode` (`testbed_plugin.rs:46-71`)."""

    mode: str = "velocity"  # "static" | "velocity" | "arrows"
    vmin: float = 0.0
    vmax: float = 5.0
    static_color: Tuple[float, float, float] = (0.2, 0.5, 0.9)
    render_boundary_particles: bool = False
    size: Tuple[int, int] = (800, 600)
    dpi: int = 100
    # Axes to plot for 3D scenes (projected): (0, 1) = x/y.
    axes: Tuple[int, int] = (0, 1)


def render_frame(world, path: str, options: Optional[RenderOptions] = None,
                 fluid_colors: Optional[dict] = None, title: str = ""):
    """Render one frame of a LiquidWorld to ``path`` (PNG)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    opt = options or RenderOptions()
    w, h = opt.size
    fig, ax = plt.subplots(figsize=(w / opt.dpi, h / opt.dpi), dpi=opt.dpi)

    ax0, ax1 = opt.axes
    fl = world.fluids_state
    alive = fl.alive.cpu().numpy()
    pos = fl.positions.cpu().numpy()[alive]
    vel = fl.velocities.cpu().numpy()[alive]
    fid = fl.fluid_id.cpu().numpy()[alive]

    if opt.mode == "static":
        if fluid_colors:
            colors = np.array(
                [fluid_colors.get(int(i), opt.static_color) for i in fid]
            )
        else:
            colors = [opt.static_color]
        ax.scatter(pos[:, ax0], pos[:, ax1], s=2, c=colors, linewidths=0)
    else:
        speed = np.linalg.norm(vel, axis=-1)
        sc = ax.scatter(
            pos[:, ax0], pos[:, ax1], s=2, c=speed, cmap="viridis",
            vmin=opt.vmin, vmax=opt.vmax, linewidths=0,
        )
        fig.colorbar(sc, ax=ax, label="|v| (m/s)")
        if opt.mode == "arrows" and len(pos):
            step = max(1, len(pos) // 500)
            ax.quiver(
                pos[::step, ax0], pos[::step, ax1],
                vel[::step, ax0], vel[::step, ax1],
                angles="xy", scale_units="xy", scale=20.0, width=0.002,
                color="0.3",
            )

    if opt.render_boundary_particles:
        bd = world.boundaries_state
        balive = bd.alive.cpu().numpy()
        bpos = bd.positions.cpu().numpy()[balive]
        if len(bpos):
            ax.scatter(bpos[:, ax0], bpos[:, ax1], s=1, c="0.6", linewidths=0)

    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def profiling_string(world) -> str:
    """`FluidsTestbedPlugin::profiling_string` (`testbed_plugin.rs:508-510`)."""
    return f"Fluids: {world.counters.step_time.time * 1000.0:.2f}ms"
