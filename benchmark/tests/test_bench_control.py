"""The control comes out not correct on the card: each cell at its own
size, put through the run's own path (``harness.run_cell``) with the
control in the program's place and a short window, is judged by the run's
own verdict and limits; the program on the same seeds is correct. And on
its own every step of a control's episode reads over a limit, so a
sample of any one step fails it. Run on the card with

    python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""

import time

import pytest
import torch

from benchmark import calibrate, harness

CELLS = ("harness_basic3_n40.collapse", "basic3_n15.collapse")
SEEDS = (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_runs_verdict_fails_the_control(name, seed):
    _needs_card()
    cell = harness.load_cell(name)
    control = cell.limits["control"]
    bad, rows = harness.run_cell(cell, seed, 2.0, False, time.monotonic(),
                                 control=control)
    print(name, seed, control, rows)
    assert bad["correct"] is False, rows
    good, rows = harness.run_cell(cell, seed, 2.0, False, time.monotonic())
    print(name, seed, "program", rows)
    assert good["correct"] is True, rows


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_every_step_of_the_control_reads_over_a_limit(name):
    _needs_card()
    cell = harness.load_cell(name)
    limits = cell.limits
    per_step = calibrate.readings(cell, SEEDS[0], "cuda", limits["control"])
    over = [max(g[k] / limits[k] for k in g) for g in per_step]
    print(name, "smallest step's widest reading / limit", min(over))
    assert min(over) > 1.0, over
