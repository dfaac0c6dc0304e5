"""A whole run on the CPU at small shapes, past the look for a card: the
result's keys, the metrics each mode reports, and ``correct`` false when
the timed path is broken underneath."""

import json

import pytest

from benchmark.spec import Cell
from benchmark.tests._small import small_config

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False, fault=None, seed=6_000_000_001):
    import importlib.util

    from benchmark.spec import HERE

    spec = importlib.util.spec_from_file_location("bench_run_cli",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_cell(cell, seed, 0.5, trace, device="cpu", fault=fault,
                        config=small_config(cell))


@pytest.mark.parametrize("cell", ["humanoid-sim.update", "pong-sim.update"])
def test_sound_run_line(cell):
    r = _run(cell)
    keys = list(r)
    assert keys[:5] == REQUIRED and keys[-1] == "check"
    assert set(keys) <= set(REQUIRED) | {"breakdown", "check"}
    json.dumps(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {m["name"] for m in Cell(cell).end_to_end}
    assert {"setup_s", "peak_mem_gib"} < set(r["metrics"])
    for name, c in r["check"].items():
        assert set(c) == {"value", "limit"}, name


def test_traced_run_reports_per_layer_metrics():
    r = _run("humanoid-sim.update", trace=True)
    assert r["correct"] is True
    # on the CPU the device metrics read nothing and are left out
    assert set(r["metrics"]) == {"cg_iters_per_update",
                                 "ls_trials_per_update"}
    assert r["metrics"]["cg_iters_per_update"]["value"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0


def test_pinned_cell_reports_its_rate_per_layer():
    """The pinned cell's rate spreads past any bound: it reports it, with
    its other readings, as per-layer metrics of its own, and only memory
    and set-up end to end."""
    cell = "humanoid-sim.update-pinned"
    assert {m["name"] for m in Cell(cell).end_to_end} == {"peak_mem_gib",
                                                          "setup_s"}
    r = _run(cell, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"updates_per_s.unbounded",
                                 "cg_iters_per_update.unbounded",
                                 "ls_trials_per_update.unbounded"}
    assert r["metrics"]["updates_per_s.unbounded"]["value"] > 0


@pytest.mark.parametrize("cell", ["humanoid-sim.update", "pong-sim.update",
                                  "humanoid-sim.update-pinned"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_update_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert r["correct"] is False, r["check"]
