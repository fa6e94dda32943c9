"""``harness_basic3``, the coupled main path, on the dense layout against
the JAX package on the CPU, on both coupling paths.

On the card the harness resolves to the dense layout through the pair
kernels; on the CPU ``auto`` resolves it to the gather layout
(``tests/test_torch_scenes_3d.py``), so here both packages' worlds are
pinned to ``layout="dense"`` (the world's ``sim.layout``; the scene
builder has no layout argument). At ``nparticles=5`` the grid is the
scene's own (basic3's box, 33 x 17 x 33 cells), which the CPU's plain
passes step in about a minute, so each path is held for one step: the
step whose dense layout is sized from the walls' static samples, which
the JAX side gets posed before it as the port writes them
(``test_torch_coupling.pose_static_samples``). Held: the same resolved
layout, caps and fb table, no overflow, fluid and boundary positions
within 2e-6 m, identical iterations, exact contact counts (``hold``).
"""

import pytest
import torch

from test_torch_coupling import pose_static_samples
from test_torch_scenes_2d import build_both, run_and_hold

torch.set_num_threads(1)


@pytest.mark.parametrize("device_coupling", [False, True],
                         ids=["host", "device"])
def test_harness_dense_matches_jax(device_coupling):
    sj, st = build_both("harness_basic3", device_coupling, nparticles=5)
    for s in (sj, st):
        s.world.sim = s.world.sim.replace(layout="dense")
    pose_static_samples(sj.pipeline)
    assert st.pipeline.device_coupling == device_coupling
    assert run_and_hold(sj, st, steps=1) == "dense"
    wj, wt = sj.world, st.world
    assert int(wt.last_diagnostics.neighbor_overflow) == 0
    assert int(wj.last_diagnostics.neighbor_overflow) == 0
    assert wt._auto_caps == wj._auto_caps
    assert wt._fb_cols_cache == wj._fb_cols_cache
    assert int(wt.boundaries_state.alive.sum()) == 13458  # basic3's walls
