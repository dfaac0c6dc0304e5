"""The benchmark's layout: every piece a cell names is found by its name,
``BENCHMARK.json`` keeps the contract's shape, nothing under
``benchmark/`` imports JAX or the JAX package, and the reference imports
nothing of the program."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import check, spec

ROOT = spec.ROOT
BENCH = spec.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "trpo_tpu"}


def _bench():
    return json.loads(spec.SPEC_FILE.read_text())


def test_benchmark_json_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    entries = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}
    for key, fields in entries.items():
        names = [e["name"] for e in b[key]]
        assert len(set(names)) == len(names)
        for e in b[key]:
            assert set(e) - {"workloads"} == fields, e
            assert NAME.match(e["name"]), e["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_pieces_found_by_name(cell):
    c = spec.Cell(cell)
    assert c.chips in (1, 4)
    assert c.config["name"] == c.entry["config"]
    for mod in (c.family, c.reference, c.flops):
        assert mod.__file__.endswith(f"{c.config['family']}.py")
    assert set(c.limits) >= set(check.NUMBERS)
    assert c.limits["search"] == 0
    assert c.end_to_end and c.per_layer
    assert callable(c.unit.Workload)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


def test_a_mix_names_its_unit_of_work():
    """Two mixes, one unit: a new mix of an existing unit is a data file."""
    a = spec.Cell("humanoid-sim.update")
    b = spec.Cell("humanoid-sim.update-pinned")
    assert a.unit is b.unit
    assert a.unit.__file__.endswith("mixes/update.py")
    assert a.mix["ladder"] is None and b.mix["ladder"]["pinned"] is True


def test_a_metric_twin_shares_its_reader():
    for twin in ("updates_per_s.device_bound", "updates_per_s.unbounded"):
        assert spec.metric_reader(twin) is spec.metric_reader("updates_per_s")
    assert spec.metric_reader("k1.roofline").__file__.endswith(
        "metrics/k1.roofline.py")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")


def test_every_config_used_and_files_distinct():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "torch"}, tops


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA here: a non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "humanoid-sim.update", "--seed", "5000000001", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(spec.SPEC_FILE, tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "humanoid-sim.update", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import importlib.util
    import types

    s = importlib.util.spec_from_file_location("bench_run_cli_fm",
                                               BENCH / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    assert "trpo_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "trpo_tpu_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jax"]
