"""Bitwise parity and operation counts of the dense solver's passes on
every layout, on the CPU, between two checkouts of the port.

``dump`` binds one small seeded world (a jittered block over a floor,
random velocities) as a ``DenseCtx`` on each layout below and records
every hoisted field, ``t_pass``, ``k_pass``, ``boundary_forces``, and
each dense pair force through ``apply_forces``, with the number of aten
operations each call dispatched (a ``TorchDispatchMode``: on the card
each is a launch or a host-side view, and the dense path is host-bound).
``compare`` reads two dumps and prints, per layout and pass, whether
every output is ``torch.equal`` and both operation counts; it exits 1 if
an output differs or a count grew. Run ``dump`` with each checkout's
package on the path, e.g. for a parent commit unpacked beside the change:

    git archive <parent> | tar -x -C /tmp/parent
    cd /tmp/parent && PYTHONPATH=. python <repo>/tools/fold_parity.py \
        dump /tmp/a.pt && cd <repo>
    PYTHONPATH=. python tools/fold_parity.py dump /tmp/b.pt
    python tools/fold_parity.py compare /tmp/a.pt /tmp/b.pt

Layouts: the grid with sparse boundary binning (with and without its fb
table) and with full-grid binning, each with the half stencil and
without; the brute tier; the compact layout; dense+spill (with and
without the fb table); frozen pairs in float32 and bfloat16; and the slab
path on two slabs (``LocalHalos``; counts per slab, taken in its thread).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

RADIUS = 0.05
DOMAIN = ((-0.6, -0.3, -0.6), (0.6, 0.9, 0.6))
DT = 0.004
# A sparse fb table narrower than half the grid's columns, so that the
# table's fold runs (the world's own sizing rounds to 512, the whole
# grid here; 1,000 columns).
FB_COLUMNS = 400

LAYOUTS = {
    "grid_sparse": dict(dense_fb_columns=FB_COLUMNS),
    "grid_sparse_no_table": dict(dense_fb_columns=None),
    "grid_full": dict(dense_sparse_boundary=False),
    "grid_sparse_full_stencil": dict(dense_half_stencil=False),
    "grid_full_full_stencil": dict(dense_sparse_boundary=False,
                                   dense_half_stencil=False),
    "brute": dict(layout="brute"),
    "compact": dict(dense_compact=True),
    "spill": dict(dense_spill_columns=64, dense_fb_columns=FB_COLUMNS),
    "spill_no_table": dict(dense_spill_columns=64, dense_fb_columns=None),
    "frozen_f32": dict(dense_frozen_pairs=True, dense_pair_dtype="float32"),
    "frozen_bf16": dict(dense_frozen_pairs=True,
                        dense_pair_dtype="bfloat16"),
    "slab": dict(dense_sparse_boundary=False),
}
# The fluid cap of the spill layouts (a lattice cell holds 8).
SPILL_CAP = 4
HOISTED = ("rho", "Gf", "Gb", "Gsum", "Sb", "sq_mm", "s2_ff", "s2_m",
           "count", "cnt_ff", "cnt_fb", "Volb", "P", "M", "maskf", "Pb",
           "maskb")


class Count(TorchDispatchMode):
    """Counts the aten operations dispatched inside it (this thread)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def counted(fn):
    with Count() as c:
        out = fn()
    return out, c.n


def flat(out):
    """Every tensor of a nested output, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    if out is None:
        return []
    raise TypeError(type(out))


def world(layout):
    import salva_tpu_torch as st
    from salva_tpu_torch.config import DFSPHConfig

    rng = np.random.default_rng(7)
    n = 6
    g = np.meshgrid(*[np.arange(n, dtype=np.float32) * 2 * RADIUS] * 3,
                    indexing="ij")
    pos = np.stack(g, -1).reshape(-1, 3) + np.float32([-0.25, 0.02, -0.25])
    pos = pos + rng.uniform(-0.3, 0.3, pos.shape).astype(np.float32) * RADIUS
    vel = rng.normal(0.0, 0.5, pos.shape).astype(np.float32)
    xs = np.arange(-0.5, 0.5, 2 * RADIUS, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    floor = np.stack([gx.ravel(), np.full(gx.size, -2 * RADIUS, np.float32),
                      gz.ravel()], -1)
    spill = "dense_spill_columns" in LAYOUTS[layout]
    w = st.LiquidWorld(solver=DFSPHConfig(), particle_radius=RADIUS, dim=3,
                       domain=DOMAIN,
                       layout=LAYOUTS[layout].get("layout", "dense"),
                       dense_cap=SPILL_CAP if spill else 16,
                       dense_cap_boundary=16, fit_grid=False, device="cpu")
    w.add_fluid(st.Fluid(pos, density0=1000.0, velocities=vel))
    w.add_boundary(st.Boundary(floor))
    return w


def ctx_setup(layout):
    """(world, sim, spec_f, spec_b) of the layout's next step."""
    from salva_tpu_torch.step import _dense_config

    w = world(layout)
    w._prepare()
    sim = w._boundary_volume_mode(w._effective_sim(), None)
    over = {k: v for k, v in LAYOUTS[layout].items() if k != "layout"}
    sim = sim.replace(recompute_boundary_volumes=True, **over)
    spec_f, spec_b, _ = _dense_config(sim, w.solver_config, w._force_set)
    return w, sim, spec_f, spec_b


def dense_forces():
    from salva_tpu_torch.solver import forces_dense as fd

    return {
        "xsph": fd.XSPHViscosityDense((0.1,), (0.2,)),
        "artificial_visc": fd.ArtificialViscosityDense(
            (0.05,), (0.03,), (1.0,), (0.5,), (10.0,)),
        "akinci": fd.Akinci2013SurfaceTensionDense((1.0,), (0.5,)),
        "wcsph_tension": fd.WCSPHSurfaceTensionDense((1.0,), (0.5,)),
        "he_tension": fd.He2014SurfaceTensionDense((1.0,), (0.5,)),
        "dfsph_visc": fd.DFSPHViscosityDense((0.1,), (1,), 1, 1, 0.01),
    }


def passes(ctx, fluids, forces=True):
    """{name: (outputs, operation count)} of one bound context."""
    g = torch.Generator().manual_seed(3)
    Q = torch.randn(ctx.V.shape, generator=g) * ctx.maskf[None]
    K = torch.randn(ctx.maskf.shape, generator=g) * ctx.maskf
    coef = torch.randn(ctx.maskf.shape, generator=g) * ctx.maskf
    out = {"hoisted": (tuple(getattr(ctx, f) for f in HOISTED), None)}
    if getattr(ctx, "frozen", False):
        out["frozen_S"] = (tuple(ctx.S), None)
    out["volumes"] = counted(lambda: (ctx._compute_boundary_volumes(),
                                      ctx.Volb)[1])
    out["hoist"] = counted(lambda: (ctx._hoist(), tuple(
        getattr(ctx, f) for f in HOISTED))[1])
    out["t_pass"] = counted(lambda: ctx.t_pass(Q))
    out["k_pass"] = counted(lambda: ctx.k_pass(K))
    out["boundary_forces"] = counted(lambda: ctx.boundary_forces(coef))
    if forces:
        dt = torch.tensor(DT)
        A = torch.zeros_like(ctx.P)
        for name, force in dense_forces().items():
            out["force_" + name] = counted(lambda: ctx.apply_forces(
                [force], fluids, ctx.V, dt, 1.0 / dt, A))
    return {k: ([t.detach().clone() for t in flat(v)], n)
            for k, (v, n) in out.items()}


def bind(layout):
    """(the layout's DenseCtx, its fluids, the binding's operation count)
    on one device."""
    from salva_tpu_torch.solver.dense_common import DenseCtx

    w, sim, spec_f, spec_b = ctx_setup(layout)
    fl, bd = w.fluids_state, w.boundaries_state.clear_forces()
    ctx, n = counted(lambda: DenseCtx(sim, spec_f, spec_b, fl, bd,
                                      need_s2=True))
    return ctx, fl, n


def dump_layout(layout):
    from salva_tpu_torch.solver.dense_common import DenseCtx

    if layout != "slab":
        ctx, fl, n = bind(layout)
        res = passes(ctx, fl, forces=not ctx.spill_E)
        res["bind"] = ([], n)
        return res
    from salva_tpu_torch.parallel import LocalHalos, pad_spec_for_devices

    w, sim, spec_f, spec_b = ctx_setup(layout)
    fl, bd = w.fluids_state, w.boundaries_state.clear_forces()
    spec_f = pad_spec_for_devices(spec_f, 2)
    spec_b = spec_b.replace(dims=spec_f.dims, clamp_nx=spec_f.clamp_nx)
    nxl = spec_f.dims[0] // 2

    def body(halo):
        ctx, n = counted(lambda: DenseCtx(sim, spec_f, spec_b, fl, bd,
                                          halo=halo, need_s2=True))
        res = passes(ctx, fl)
        res["bind"] = ([], n)
        return res

    ranks = LocalHalos(2).run(nxl, int(np.prod(spec_f.dims[1:])), body)
    return {f"{k}@{r}": v for r, res in enumerate(ranks)
            for k, v in res.items()}


def dump(path):
    torch.set_num_threads(1)
    out = {}
    for layout in LAYOUTS:
        out[layout] = dump_layout(layout)
        print(layout, {k: n for k, (_, n) in out[layout].items()},
              flush=True)
    torch.save(out, path)


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    bad = 0
    for layout in a:
        for name, (ta, na) in a[layout].items():
            tb, nb = b[layout][name]
            same = len(ta) == len(tb) and all(
                x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
                for x, y in zip(ta, tb))
            grew = na is not None and nb > na
            bad += (not same) + grew
            print(f"{layout:26s} {name:24s} "
                  f"{'equal' if same else 'DIFFERS':8s} ops {na} -> {nb}"
                  f"{'  GREW' if grew else ''}")
    print("ok" if not bad else f"{bad} failures")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
