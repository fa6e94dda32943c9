"""``bench_torch.py`` (the port's benchmark) run on the CPU at a toy size.

Not a speed test: it checks that the script runs its rows end to end on
the plain passes (``--device cpu``), gates them, skips the rows its
budget cannot afford with a marker, and prints one JSON line, last on
stdout, with the fields ``bench.py`` prints and the per-row stamps.
``BENCH_LAYOUT=brute``: on the CPU ``layout="auto"`` never resolves to the
brute tier and resolves this toy scene to the gather layout, which is no
row of the benchmark; the brute rows and ``dfsph_4k_dense`` (always the
grid) then cover both tiers.
"""

import json

import pytest
import torch

import bench_torch

# One intra-op thread (see tests/test_torch_dam_break.py).
torch.set_num_threads(1)

TOY = dict(BENCH_N="125", BENCH_STEPS="2", BENCH_WARMUP="1",
           BENCH_REPEATS="1", BENCH_SKIP_1M="1", BENCH_BUDGET="0",
           BENCH_LAYOUT="brute")
TOP_FIELDS = ("metric", "value", "unit", "ms_per_step", "pressure_iters",
              "divergence_iters", "grid_refits_in_window", "iters_per_step",
              "dense_layout", "rows")
ROW_FIELDS = ("name", "metric", "n", "layout", "dense_layout", "dense_cap",
              "dense_cap_boundary", "fitted_dims", "value", "value_spread",
              "ms_per_step", "ms_per_step_spread", "device_ms_per_step",
              "pressure_iters", "divergence_iters", "iters_per_step",
              "neighbor_overflow", "overflow_limit", "max_density_ratio",
              "host_dispatch_us", "device", "power_limit", "git_rev",
              "source_sha256", "gates_checked", "gate_failures")


def _run(monkeypatch, capsys, env):
    for k in list(TOY) + ["BENCH_PALLAS", "BENCH_FROZEN", "BENCH_SPILL",
                          "BENCH_PAIR_DTYPE", "BENCH_CAP", "BENCH_WARM"]:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(lines[-1])


def test_bench_runs_its_rows_and_gates(monkeypatch, capsys):
    rc, out = _run(monkeypatch, capsys, TOY)
    assert rc == 0, out.get("failed_rows")
    for k in TOP_FIELDS:
        assert k in out, k
    assert out["unit"] == "particle-steps/s"
    rows = {r["name"]: r for r in out["rows"]}
    assert list(rows) == ["dfsph_97k", "iisph_97k", "dfsph_4k_auto",
                          "dfsph_4k_dense"]
    # The budget (0 s) skips the visc rows; BENCH_SKIP_1M the 1M row.
    assert "skipped_dfsph_97k_visc" in out and "skipped_iisph_97k_visc" in out
    assert "skipped_1m" in out
    primary = rows["dfsph_97k"]
    assert out["metric"] == primary["metric"]
    assert out["value"] == primary["value"] > 0
    assert len(out["iters_per_step"]) == 2
    for r in rows.values():
        for k in ROW_FIELDS:
            assert k in r, (r["name"], k)
        assert r["n"] == 125 and r["gate_failures"] == []
        assert "neighbor_overflow" in r["gates_checked"]
        assert r["neighbor_overflow"] < r["overflow_limit"] == 1
        assert 0.9 <= r["max_density_ratio"] <= 2.0
        assert r["device"] == "cpu" and r["device_ms_per_step"] is None
        spread = r["ms_per_step_spread"]
        assert spread["min"] <= r["ms_per_step"] <= spread["max"]
    assert rows["dfsph_4k_auto"]["layout"] == "brute"
    assert rows["dfsph_4k_auto"]["brute_cells"] == 32
    assert rows["dfsph_4k_dense"]["layout"] == "dense"
    assert rows["iisph_97k"]["divergence_iters"] == 0


def test_bench_reports_a_failed_gate(monkeypatch, capsys):
    """A row that fails a gate stays in the output, with its failure, and
    the script exits 1."""
    monkeypatch.setattr(bench_torch, "DENSITY_RATIO", (5.0, 6.0))
    rc, out = _run(monkeypatch, capsys, dict(TOY, BENCH_N="27"))
    assert rc == 1
    assert out["failed_rows"] == [r["name"] for r in out["rows"]]
    for r in out["rows"]:
        assert any("density ratio" in f for f in r["gate_failures"])


def test_bench_refuses_unported_knobs_and_a_missing_card(monkeypatch,
                                                         capsys):
    """``BENCH_PALLAS`` stays refused (the port has no Pallas switch);
    ``BENCH_FROZEN`` (with ``BENCH_PAIR_DTYPE``) and ``BENCH_SPILL`` run,
    and every row names the layout it ran: the 64-particle lattice (8 a
    cell) resolves the grid row to 12 + spill under ``BENCH_SPILL``."""
    monkeypatch.setenv("BENCH_PALLAS", "1")
    with pytest.raises(NotImplementedError, match="BENCH_PALLAS"):
        bench_torch.main(["--device", "cpu"])
    monkeypatch.delenv("BENCH_PALLAS")
    toy = dict(TOY, BENCH_N="64")
    for knobs, grid, brute in (
            (dict(BENCH_FROZEN="1", BENCH_PAIR_DTYPE="bfloat16"),
             "grid+frozen_bfloat16", "brute+frozen_bfloat16"),
            (dict(BENCH_SPILL="1"), "grid+spill512", "brute")):
        rc, out = _run(monkeypatch, capsys, dict(toy, **knobs))
        assert rc == 0, out.get("failed_rows")
        rows = {r["name"]: r for r in out["rows"]}
        assert rows["dfsph_4k_dense"]["dense_layout"] == grid
        assert rows["dfsph_4k_dense"]["dense_cap"] == (
            12 if "BENCH_SPILL" in knobs else 16)
        assert out["dense_layout"] == rows["dfsph_97k"]["dense_layout"]
        assert out["dense_layout"] == brute
        monkeypatch.delenv("BENCH_PAIR_DTYPE", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_torch.main([])
