"""A run with the timed path broken underneath comes out not correct.

The harness runs on the CPU here (its look for a card is skipped), on
basic3_n15's brute tier at 4^3 particles, with the cell's own limits. The
program's step is broken after the set-up, so the fault sits in every
step of the window and in the check's sample. (The cell runs on one card:
it has no exchange between chips to leave out.)"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_harness import small_cell
from salva_tpu_torch.coupling import FluidsPipeline


def _run(monkeypatch, fault):
    cell = small_cell()
    good = FluidsPipeline.step
    calls = {"n": 0}

    def step(self, gravity, dt):
        calls["n"] += 1
        if calls["n"] <= int(cell.traffic["warmup_steps"]):
            return good(self, gravity, dt)
        fault(self, good, gravity, dt)

    monkeypatch.setattr(FluidsPipeline, "step", step)
    result, rows = harness.run_cell(cell, 17, 0.0, False, time.monotonic(),
                                       device="cpu", layout="brute",
                                       device_coupling=True)
    return result, dict((k, (v, lim)) for k, v, lim in rows)


def unchanged(pip, good, gravity, dt):
    """The step returns the state it was given."""


def half_left_out(pip, good, gravity, dt):
    """Only the first half of the particles is stepped."""
    w = pip.liquid_world
    old = w.fluids_state
    good(pip, gravity, dt)
    new = w.fluids_state
    half = torch.arange(old.capacity) < old.capacity // 2
    w.fluids_state = new.replace(
        positions=torch.where(half[:, None], new.positions, old.positions),
        velocities=torch.where(half[:, None], new.velocities, old.velocities))


def answer_altered(pip, good, gravity, dt):
    """One particle's position is nudged by 1e-4 m where the step writes
    it."""
    good(pip, gravity, dt)
    w = pip.liquid_world
    pos = w.fluids_state.positions.clone()
    pos[int(w.fluid_slots(0)[7]), 1] += 1e-4
    w.fluids_state = w.fluids_state.replace(positions=pos)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    result, rows = _run(monkeypatch, fault)
    assert result["correct"] is False
    assert rows["pos_gap_m"][0] > rows["pos_gap_m"][1]


def test_the_unbroken_run_is_correct(monkeypatch):
    result, rows = _run(monkeypatch, lambda pip, good, g, dt: good(pip, g, dt))
    assert result["correct"] is True, rows
    assert result["attempted"] >= 1 and result["failed"] == 0
