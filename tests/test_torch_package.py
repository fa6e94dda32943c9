"""Package-level guarantees of the PyTorch port: it imports neither jax nor
flax, CPU runs never launch a kernel, the kernel wrappers validate their
operands, unported paths raise, and the state converters round-trip."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.object.state import state_from_numpy, state_to_numpy
from salva_tpu_torch.ops import pair

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_and_flax_out():
    """Every module of the package imports in a fresh interpreter without
    pulling in jax or flax."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {_ROOT!r})\n"
        "import salva_tpu_torch\n"
        "for m in pkgutil.walk_packages(salva_tpu_torch.__path__,"
        " 'salva_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules"
        " if n.startswith('salva_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _tiny_world(dim=2):
    w = st.LiquidWorld(particle_radius=0.05, dim=dim,
                       domain=((-1.0, -0.4), (1.0, 1.5)), layout="dense",
                       device="cpu")
    xs = (np.arange(6) * 0.1).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs + 0.1, indexing="ij"),
                   -1).reshape(-1, 2)
    w.add_fluid(st.Fluid(pos))
    floor = np.stack([np.arange(-0.5, 1.0, 0.1, dtype=np.float32),
                      np.full(15, -0.05, np.float32)], -1)
    w.add_boundary(st.Boundary(floor))
    return w


def test_cpu_run_launches_no_kernel():
    pair.reset_launches()
    w = _tiny_world()
    for _ in range(3):
        w.step(1.0 / 200.0, (0.0, -9.81))
    assert w.device.type == "cpu"
    assert pair.LAUNCHES == {"k_pass": 0, "t_pass": 0, "hoist_ff": 0}
    pos = w.fluid_positions(0)
    assert pos.shape == (36, 2) and np.isfinite(pos).all()
    d = w.last_diagnostics
    assert d.solver.pressure_iters >= 1 and int(d.ncontacts_ff) > 0


def test_default_device_follows_cuda_availability():
    w = st.LiquidWorld(dim=3)
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert w.device.type == want
    assert w.fluids_state.device.type == want


def _operands(dim=3, cap=4):
    spec = tdg.DenseGridSpec((0.0,) * dim, (4,) * dim, cap, 0.2)
    C = spec.num_cells
    P = torch.full((dim, cap, C), tdg.POS_SENTINEL)
    M = torch.zeros((cap, C))
    counts = torch.zeros((C,), dtype=torch.int32)
    return spec, P, M, counts


def test_wrappers_reject_bad_operands():
    spec, P, M, counts = _operands()
    K = torch.zeros_like(M)
    pair.k_pass(spec, 0.2, 3, "cubic", P, M, K, counts)  # accepted
    with pytest.raises(TypeError):
        pair.k_pass(spec, 0.2, 3, "cubic", P.double(), M, K, counts)
    with pytest.raises(ValueError):
        pair.t_pass(spec, 0.2, 3, "cubic", P, M, K, counts)  # Q not [3,cap,C]
    with pytest.raises(ValueError):
        pair.hoist_ff(spec, 0.2, 3, "cubic", "cubic", P, M[:, :-1], counts)
    with pytest.raises(ValueError):
        pair.k_pass(spec, 0.2, 3, "cubic", P, M, K, counts.long())
    with pytest.raises(ValueError):
        pair.k_pass(spec, 0.2, 2, "cubic", P, M, K, counts)  # dim vs spec
    with pytest.raises(RuntimeError):
        pair.k_pass(spec, 0.2, 3, "cubic", P.to("meta"), M.to("meta"),
                    K.to("meta"), counts.to("meta"))


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        w = st.LiquidWorld(dim=2, layout="gather", device="cpu")
        w.add_fluid(st.Fluid(np.zeros((4, 2), np.float32)))
        w.step(0.01, (0.0, -9.81))
    with pytest.raises(NotImplementedError):
        _tiny_world().add_fluid(
            st.Fluid(np.zeros((4, 2), np.float32),
                     nonpressure_forces=[object()])
        )
    with pytest.raises(NotImplementedError):
        _tiny_world().step_with_coupling(0.01, (0.0, -9.81), object())
    w = _tiny_world()
    w.sim = w.sim.replace(dense_spill_columns=512)
    with pytest.raises(NotImplementedError):
        w.step(0.01, (0.0, -9.81))


def test_dense_ctx_layout_round_trips():
    """to_f / unbin_f / unbin_b move values between particle and grid
    layout without changing them; particles outside the grid keep the
    fallback."""
    from salva_tpu_torch.solver.dense_common import DenseCtx
    from salva_tpu_torch.solver.nonpressure import ForceSet
    from salva_tpu_torch.step import _dense_config

    w = _tiny_world()
    w.step(1.0 / 200.0, (0.0, -9.81))
    sim = w._boundary_volume_mode(w._effective_sim(), None)
    spec_f, spec_b, _ = _dense_config(sim, w.solver_config, ForceSet())
    ctx = DenseCtx(sim, spec_f, spec_b, w.fluids_state, w.boundaries_state,
                   need_s2=False)
    vel = w.fluids_state.velocities
    back = ctx.unbin_f(ctx.to_f(vel), torch.full_like(vel, -7.0))
    inside = ctx.binf.in_grid
    assert bool(inside.any()) and not bool(inside.all())  # dead slots
    assert torch.equal(back[inside], vel[inside])
    assert bool((back[~inside] == -7.0).all())
    fallback = torch.full_like(w.boundaries_state.volumes, -1.0)
    (multi,) = ctx.unbin_b_multi([(ctx.Volb, fallback)])
    assert torch.equal(ctx.unbin_b(ctx.Volb, fallback), multi)
    assert bool((multi[ctx.binb.in_grid] > 0).all())


def test_state_numpy_round_trip():
    w = _tiny_world()
    for state in (w.fluids_state, w.boundaries_state):
        arrays = state_to_numpy(state)
        assert arrays["memberships"].dtype == np.uint32
        back = state_from_numpy(arrays)
        assert type(back) is type(state)
        for name, arr in arrays.items():
            np.testing.assert_array_equal(
                state_to_numpy(back)[name], arr, err_msg=name
            )
    solver = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        state_to_numpy(state_from_numpy(solver)), solver
    )
    with pytest.raises(ValueError):
        state_from_numpy({"positions": np.zeros((1, 2), np.float32)})


def test_kernel_build_is_keyed_by_source_hash():
    from salva_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent.parent.name == "salva_tpu_torch"
    assert path.parent.parent.parent.name == "build"
    assert len(path.parent.name) == 16
