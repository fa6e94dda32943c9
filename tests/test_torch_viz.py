"""The PyTorch port's renderer (``salva_tpu_torch.viz``) and scene runner
(``python -m salva_tpu_torch.run_scene``) on the CPU: frames are written
in every colour mode, as the JAX package's ``viz`` writes them."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import run_scene

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world():
    w = st.LiquidWorld(particle_radius=0.05, dim=2, device="cpu")
    xs = (np.arange(5) * 0.1).astype(np.float32)
    w.add_fluid(st.Fluid(np.stack(np.meshgrid(xs, xs, indexing="ij"),
                                  -1).reshape(-1, 2)))
    w.add_boundary(st.Boundary(np.array([[0.0, -0.2], [0.1, -0.2]],
                                        np.float32)))
    w.step(1.0 / 200.0, (0.0, -9.81))
    return w


def test_render_frame(tmp_path):
    pytest.importorskip("matplotlib")
    from salva_tpu_torch.viz import RenderOptions, profiling_string, \
        render_frame

    w = _world()
    for mode in ("static", "velocity", "arrows"):
        path = str(tmp_path / f"{mode}.png")
        opt = RenderOptions(mode=mode, render_boundary_particles=True)
        assert render_frame(w, path, opt, fluid_colors={0: (1, 0, 0)},
                            title=mode) == path
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    w.counters.enable()
    w.step(1.0 / 200.0, (0.0, -9.81))
    assert profiling_string(w).startswith("Fluids: ")


def test_run_scene_renders_on_the_cpu(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "frames"
    assert run_scene.main(["basic2", "--steps", "2", "--device", "cpu",
                           "--render", str(out), "--every", "1",
                           "--profile"]) == 0
    assert sorted(os.listdir(out)) == ["basic2_00001.png",
                                       "basic2_00002.png"]
    text = capsys.readouterr().out
    assert "step     1  particles=" in text and "ms/step" in text


def test_run_scene_lists_and_refuses():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-m", "salva_tpu_torch.run_scene",
                          "--list"], capture_output=True, text=True,
                         env=env, timeout=120, cwd=_ROOT)
    assert out.returncode == 0 and "faucet3" in out.stdout.split()
    assert run_scene.main(["no_such_scene"]) == 2
