"""Operation counts of the dense solver's plain folds.

On the card the dense path is host-bound: every aten operation a plain
fold dispatches is a launch, or a view the host must still dispatch. Each
case counts the operations of one call of one fold (the
``TorchDispatchMode`` of ``tools/fold_parity.py``) on that tool's seeded
3D world bound as a ``DenseCtx`` on the CPU, and holds the count to at
most the count at commit 6d193e3 (``PARENT``, measured with these
fixtures on that commit), so that a change to the folds dispatches no more
operations than that commit did. The outputs are held elsewhere: against
the JAX package by the parity tests, and bitwise between two checkouts
by ``tools/fold_parity.py`` itself.
"""

import importlib.util
import os

import pytest
import torch

from salva_tpu_torch.solver import full_folds

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The counts at commit 6d193e3, by (the tool's layout, fold).
PARENT = {
    "brute-t_pass": 2302,
    "brute-k_pass": 2145,
    "brute-hoist_ff": 4160,
    "brute-hoist_fb": 4767,
    "brute-boundary_forces": 2496,
    "brute-boundary_volumes": 2057,
    "grid_sparse-t_pass": 1199,
    "grid_sparse-k_pass": 1081,
    "grid_sparse-hoist": 5976,
    "grid_sparse-boundary_forces": 2514,
    "grid_sparse-boundary_volumes": 1793,
    "grid_sparse_full_stencil-t_pass": 1942,
    "grid_sparse_full_stencil-k_pass": 1810,
    "spill-t_pass": 6441,
    "spill-k_pass": 6103,
}


def _fold_parity():
    """``tools/fold_parity.py`` as a module (it imports the port only
    inside its functions)."""
    spec = importlib.util.spec_from_file_location(
        "fold_parity", os.path.join(_ROOT, "tools", "fold_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = _fold_parity()


def calls(ctx):
    """Each fold of ``ctx`` as a call of no arguments."""
    g = torch.Generator().manual_seed(5)
    Q = torch.randn(ctx.V.shape, generator=g) * ctx.maskf[None]
    K = torch.randn(ctx.maskf.shape, generator=g) * ctx.maskf
    sim, grid = ctx.sim, (ctx.spec_f, ctx.h, ctx.dim)
    kd, kg = sim.kernel_density, sim.kernel_gradient
    return {
        "t_pass": lambda: ctx.t_pass(Q),
        "k_pass": lambda: ctx.k_pass(K),
        "hoist": ctx._hoist,
        "hoist_ff": lambda: full_folds.hoist_ff(
            *grid, kd, kg, ctx.P, ctx.M, ctx.maskf, need_s2=True,
            jview=ctx.jff),
        "hoist_fb": lambda: full_folds.hoist_fb(
            *grid, kd, kg, ctx.P, ctx.maskf, ctx.Pb, ctx.maskb, ctx.Volb,
            ctx.Vbvel, need_s2=True, jview=ctx.jfb),
        "boundary_forces": lambda: ctx.boundary_forces(K),
        "boundary_volumes": ctx._compute_boundary_volumes,
    }


def count(case):
    layout, fold = case.split("-")
    ctx, _, _ = TOOL.bind(layout)
    return TOOL.counted(calls(ctx)[fold])[1]


@pytest.mark.parametrize("case", list(PARENT))
def test_fold_dispatches_no_more_operations(case):
    n = count(case)
    assert 0 < n <= PARENT[case], (case, n, PARENT[case])
