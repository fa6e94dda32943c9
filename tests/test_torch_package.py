"""Package-level guarantees of the PyTorch port: it imports neither jax,
flax nor the JAX package, the default device is the card (no silent CPU fallback), CPU runs
never launch a kernel, the kernel wrappers validate their operands,
unported paths raise (and the gather layout, the elasticity and custom
forces, coupling and the last dense layouts, ported since, run), and the
state converters round-trip."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import salva_tpu_torch as st
from salva_tpu_torch import forces
from salva_tpu_torch.geometry import dense_grid as tdg
from salva_tpu_torch.object.state import state_from_numpy, state_to_numpy
from salva_tpu_torch.ops import binning, pair

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_and_flax_out():
    """Every module of the package imports in a fresh interpreter without
    pulling in jax, flax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {_ROOT!r})\n"
        "import salva_tpu_torch\n"
        "for m in pkgutil.walk_packages(salva_tpu_torch.__path__,"
        " 'salva_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'salva_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules"
        " if n.startswith('salva_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _tiny_world(dim=2, solver=None, dense_cap=None):
    w = st.LiquidWorld(solver=solver, particle_radius=0.05, dim=dim,
                       domain=((-1.0, -0.4), (1.0, 1.5)), layout="dense",
                       dense_cap=dense_cap, device="cpu")
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
    binning.reset_launches()
    w = _tiny_world()
    for _ in range(3):
        w.step(1.0 / 200.0, (0.0, -9.81))
    assert w.device.type == "cpu"
    assert pair.LAUNCHES == {"k_pass": 0, "t_pass": 0, "hoist_ff": 0,
                             "hoist_fb": 0, "k_pass_v2": 0}
    assert binning.LAUNCHES == {"expand": 0}
    pos = w.fluid_positions(0)
    assert pos.shape == (36, 2) and np.isfinite(pos).all()
    d = w.last_diagnostics
    assert d.solver.pressure_iters >= 1 and int(d.ncontacts_ff) > 0


def test_default_device_follows_cuda_availability(monkeypatch):
    """The default device is the card; without one the world raises and
    names ``device="cpu"`` instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        st.LiquidWorld(dim=3)
    w = st.LiquidWorld(dim=3, device="cpu")
    assert w.fluids_state.device.type == "cpu"
    # With a card present the default resolves to it (states are not
    # allocated on it here: only the device choice is checked).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(st.world.FluidsState, "empty",
                        staticmethod(lambda cap, dim, device: device))
    monkeypatch.setattr(st.world.BoundariesState, "empty",
                        staticmethod(lambda cap, dim, device: device))
    w = st.LiquidWorld(dim=3)
    assert w.device == torch.device("cuda")
    assert w.fluids_state == torch.device("cuda")


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
    # hoist_fb: the full-grid form (no cell map) needs Cb == C; the map
    # and the column list are int32.
    C = spec.num_cells
    Pb = torch.full((3, 2, C), tdg.POS_SENTINEL)
    Volb, cb = torch.zeros((2, C)), torch.zeros((C,), dtype=torch.int32)
    fb = (spec, 0.2, 3, "cubic", "cubic", P, counts)
    pair.hoist_fb(*fb, Pb, Volb, Pb, cb)  # accepted
    with pytest.raises(ValueError):
        pair.hoist_fb(*fb, Pb[..., :-1], Volb[:, :-1], Pb[..., :-1], cb[:-1])
    with pytest.raises(ValueError):
        pair.hoist_fb(*fb, Pb, Volb, Pb, cb,
                      cell_to_col=torch.zeros(C + 1, dtype=torch.int64))
    with pytest.raises(ValueError):  # a column list needs the cell map
        pair.hoist_fb(*fb, Pb, Volb, Pb, cb,
                      cols=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pair.hoist_fb(*fb, Pb, Volb, Pb, cb,
                      cell_to_col=torch.zeros(C + 1, dtype=torch.int32),
                      cols=torch.zeros(4, dtype=torch.int64))
    with pytest.raises(TypeError):
        pair.hoist_fb(*fb, Pb, Volb.double(), Pb, cb)


def test_unported_paths_raise():
    # The gather layout steps on the CPU (its parity with the JAX package
    # is held by tests/test_torch_gather_*.py).
    w = st.LiquidWorld(dim=2, layout="gather", device="cpu")
    w.add_fluid(st.Fluid(np.zeros((4, 2), np.float32)))
    w.step(0.01, (0.0, -9.81))
    assert bool(torch.isfinite(w.fluids_state.positions).all())
    with pytest.raises(NotImplementedError):
        _tiny_world().add_fluid(
            st.Fluid(np.zeros((4, 2), np.float32),
                     nonpressure_forces=[object()])
        )
    # The elasticity and custom forces are accepted; a custom force has no
    # dense form, so the dense layout refuses it when it steps.
    from salva_tpu_torch.solver.nonpressure import CustomForce

    class Push(CustomForce):
        def apply(self, ctx):
            return torch.ones_like(ctx.fluids.positions)

    w = _tiny_world()
    w.add_fluid(st.Fluid(np.zeros((4, 2), np.float32) + 0.5,
                         nonpressure_forces=[
                             forces.Becker2009Elasticity(1e5, 0.3)]))
    w.step(0.01, (0.0, -9.81))
    assert w._elasticity_state is not None
    w = _tiny_world()
    w.add_fluid(st.Fluid(np.zeros((4, 2), np.float32) + 0.5,
                         nonpressure_forces=[Push()]))
    with pytest.raises(ValueError, match="no dense implementation"):
        w.step(0.01, (0.0, -9.81))
    # Coupling is ported: a step with the no-op coupling equals step()
    # (volumes recomputed every coupled step; from a fresh world both
    # recompute), and what stays unported raises by name.
    from salva_tpu_torch.coupling import NoOpCoupling

    plain, coupled = _tiny_world(), _tiny_world()
    for _ in range(2):
        plain.step(0.01, (0.0, -9.81))
        coupled.step_with_coupling(0.01, (0.0, -9.81), NoOpCoupling())
        assert torch.equal(coupled.fluids_state.positions,
                           plain.fluids_state.positions)
    # Ported since: adaptive substepping, a TriMesh collider on the device
    # coupling path, z_sort, the queries and the debug checks run; a shape
    # of the JAX package is refused by name.
    w = _tiny_world()
    w.timestep_manager.adaptive = True
    w.debug_checks = True
    vel = torch.zeros_like(w.fluids_state.velocities)
    vel[:, 0] = 3.0
    w.fluids_state = w.fluids_state.replace(velocities=vel)
    w.counters.enable()
    w.step(1.0 / 30.0, (0.0, -9.81))
    assert w.counters.nsubsteps > 1
    assert st.LiquidWorld(dim=2, adaptive_timestep=True,
                          device="cpu").timestep_manager.adaptive
    w.z_sort()
    assert len(w.particles_intersecting_aabb((-1.0, -1.0), (1.0, 1.0))) \
        == 36 + 15
    from salva_tpu_torch.shapes import Ball, TriMesh
    from salva_tpu_torch.coupling import FluidsPipeline

    assert len(w.particles_intersecting_shape(Ball(5.0), np.eye(2),
                                              np.zeros(2))) == 36 + 15
    mesh = TriMesh.from_arrays(
        [[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.0, 0.0, 0.5],
         [0.0, 0.5, 0.0]], [[0, 1, 2], [0, 3, 1], [1, 3, 2], [2, 3, 0]])
    pip = FluidsPipeline(0.05, dim=3, device="cpu")
    pip.liquid_world.add_fluid(st.Fluid(np.float32([[0.0, 0.1, 0.0]])))
    body = pip.bodies.add_body("fixed")
    pip.bodies.add_collider(body, mesh)
    pip._device_request = True
    pip.step((0.0, -9.81, 0.0), 0.01)
    assert pip.device_coupling
    assert isinstance(pip._device.colliders[0].shape, st.shapes.VoxelSdf)
    from salva_tpu.shapes import TriMesh as JaxTriMesh

    pip = FluidsPipeline(0.05, dim=3, device="cpu")
    body = pip.bodies.add_body("fixed")
    pip.bodies.add_collider(body, JaxTriMesh.from_arrays(np.eye(3),
                                                         [[0, 1, 2]]))
    pip._device_request = True
    with pytest.raises(NotImplementedError, match="TriMesh"):
        pip.step((0.0, -9.81, 0.0), 0.01)
    # Ported since: the compact layout, frozen pair coefficients (both
    # storage dtypes) and the dense+spill structure (explicit and auto)
    # step on the CPU, with their diagnostics; frozen pairs with spill
    # stay refused, as in the JAX package.
    # (The spill world's cap of 3 sits under its 4 particles a cell, so
    # every occupied cell spills: K = 9 holds a column's whole stencil.)
    for flag in (dict(dense_spill_columns=512, dense_spill_k=9),
                 dict(dense_spill_auto=True),
                 dict(dense_compact=True), dict(dense_frozen_pairs=True),
                 dict(dense_frozen_pairs=True, dense_pair_dtype="bfloat16")):
        w = _tiny_world(dense_cap=3 if "dense_spill_columns" in flag
                        else None)
        w.sim = w.sim.replace(**flag)
        for _ in range(2):
            w.step(0.01, (0.0, -9.81))
        d = w.last_diagnostics
        assert np.isfinite(w.fluid_positions(0)).all(), flag
        assert int(d.ncontacts_ff) > 0, flag
        assert int(d.neighbor_overflow) == int(d.spill_overflow) == 0, flag
    w = _tiny_world(dense_cap=3)
    w.sim = w.sim.replace(dense_spill_columns=512, dense_frozen_pairs=True)
    with pytest.raises(NotImplementedError, match="dense_spill_columns"):
        w.step(0.01, (0.0, -9.81))
    # Ported since the first slice: IISPH and the full-grid boundary
    # binning step on the CPU, and so do the full-stencil plain folds
    # (dense_half_stencil=False) and the brute tier.
    w = _tiny_world(solver=st.IISPHConfig())
    w.sim = w.sim.replace(dense_sparse_boundary=False)
    for _ in range(2):
        w.step(0.01, (0.0, -9.81))
    assert w._solver_state.shape == (w.fluids_state.capacity,)
    assert int(w.last_diagnostics.ncontacts_fb) > 0
    for flag in (dict(dense_half_stencil=False), dict(layout="brute")):
        w = _tiny_world()
        w.sim = w.sim.replace(**flag)
        for _ in range(2):
            w.step(0.01, (0.0, -9.81))
        assert w._effective_sim().layout == flag.get("layout", "dense")
        assert int(w.last_diagnostics.ncontacts_fb) > 0
        assert int(w.last_diagnostics.neighbor_overflow) == 0


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
        back = state_from_numpy(arrays, device="cpu")
        assert type(back) is type(state)
        for name, arr in arrays.items():
            np.testing.assert_array_equal(
                state_to_numpy(back)[name], arr, err_msg=name
            )
    solver = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(
        state_to_numpy(state_from_numpy(solver, device="cpu")), solver
    )
    with pytest.raises(ValueError):
        state_from_numpy({"positions": np.zeros((1, 2), np.float32)},
                         device="cpu")
    with pytest.raises(TypeError):
        state_from_numpy(solver)  # the caller names the device


def test_kernel_build_is_keyed_by_source_hash():
    from salva_tpu_torch.ops import _build

    paths = _build.library_paths()
    assert len(paths) == len(_build._SOURCES) == 3  # one library a source
    assert len({p.parent.name for p in paths}) == len(paths)
    for path in paths:
        assert path.parent.parent.name == "salva_tpu_torch"
        assert path.parent.parent.parent.name == "build"
        assert len(path.parent.name) == 16


@pytest.mark.parametrize("layout", ["dense", "brute"])
@pytest.mark.parametrize("force", [
    forces.Akinci2013SurfaceTension(1.0, 10.0),
    forces.WCSPHSurfaceTension(1.0, 0.5),
    forces.He2014SurfaceTension(1.0, 0.5),
    forces.DFSPHViscosity(0.5, max_viscosity_iter=2),
], ids=lambda f: type(f).__name__)
def test_ported_forces_are_accepted_and_step(force, layout):
    """``add_fluid`` accepts each force this slice ported; a CPU world
    whose second fluid carries it, under poly6 / spiky, on the grid and
    on the brute tier (whose force views are its cyclic offsets), merges
    it into its force set and steps (finite positions), launching no
    kernel."""
    w = _tiny_world()
    w.sim = w.sim.replace(kernel_density="poly6", kernel_gradient="spiky",
                          layout=layout)
    xs = (np.arange(4) * 0.1 + 0.7).astype(np.float32)
    pos = np.stack(np.meshgrid(xs, xs + 0.1, indexing="ij"), -1)
    w.add_fluid(st.Fluid(pos.reshape(-1, 2), density0=800.0,
                         nonpressure_forces=[force]))
    pair.reset_launches()
    for _ in range(2):
        w.step(0.01, (0.0, -9.81))
    (merged,) = w._force_set
    assert type(merged).__name__ == type(force).__name__ + "Force"
    coeffs = next(v for k, v in vars(merged).items()
                  if k.endswith("coefficients"))
    assert coeffs[0] == 0.0 and coeffs[1] > 0.0  # only fluid 1 carries it
    assert bool(torch.isfinite(w.fluids_state.positions).all())
    assert int(w.last_diagnostics.ncontacts_fb) > 0
    assert w._effective_sim().layout == layout
    assert not any(pair.LAUNCHES.values())
