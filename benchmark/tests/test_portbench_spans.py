"""The readers of the program's own spans and counters (``spans.py``,
``metrics/fvp.roofline.py``, ``cg_iter_ms.py``, ``linesearch_ms.py``,
``host_reads_per_update.py``, ``ls_evals_per_update.py``): each reads
nothing on a CPU traced run or from a program without spans, and, given a
buffer with stated device times, computes the formula its docstring
states. On the card (``python -m pytest benchmark/tests -q -m gpu``) a
traced flagship run reports all five."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.spec import HERE, Cell, load_json, metric_reader
from benchmark.tests._small import small_config

NEW = ("fvp.roofline", "cg_iter_ms", "linesearch_ms",
       "host_reads_per_update", "ls_evals_per_update")
PEAK = load_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]


class _Rec(SimpleNamespace):
    def device_ms(self):
        return self.ms


@pytest.fixture
def program():
    """The program's counters and span buffer, emptied, restored after."""
    from trpo_torch.ops import _build

    _build.reset_launches()
    yield _build
    _build.reset_launches()


def _ctx(cell_name):
    cell = Cell(cell_name)
    wl_rows = {"humanoid-sim.update": 37_536, "pong-sim.update": 2_048,
               "humanoid-sim.update-pinned": 50_048}[cell_name]
    return SimpleNamespace(config=cell.config, flops=cell.flops,
                           fvp_rows=wl_rows, peak=PEAK)


def _fill(_build, fvp_ms=(0.8, 0.9, 1.0), cg_ms=(10.0, 14.0),
          ls_ms=(3.0, 5.0)):
    """Two updates: 20 CG iterations, 20 trials, 21 host reads."""
    for name, times in (("trpo/fvp", fvp_ms), ("trpo/cg_solve", cg_ms),
                        ("trpo/linesearch", ls_ms),
                        ("trpo/grad_and_surrogate", (1.0, 1.0))):
        for ms in times:
            _build.SPANS.add(_Rec(name=name, parent=None, ms=ms))
    _build.SPAN_COUNTS.update({"trpo/grad_and_surrogate": 2,
                               "trpo/cg_solve/iteration": 20,
                               "trpo/linesearch/trial": 20,
                               "trpo/fvp": 3, "trpo/cg_solve": 2,
                               "trpo/linesearch": 2})
    _build.HOST_READS.update({"cg.exit": 20, "ladder.pinned": 1})


@pytest.mark.parametrize("cell_name", ["humanoid-sim.update",
                                       "pong-sim.update",
                                       "humanoid-sim.update-pinned"])
def test_readers_compute_their_formulas(program, cell_name):
    _fill(program)
    ctx = _ctx(cell_name)
    got = {m: metric_reader(m).read(ctx) for m in NEW}
    bound = max(ctx.flops.fvp(ctx.config, ctx.fvp_rows) / PEAK["tf32_flops"],
                ctx.flops.fvp_bytes(ctx.config, ctx.fvp_rows)
                / PEAK["hbm_bytes_per_s"])
    assert got["fvp.roofline"] == pytest.approx(100 * bound / 0.9e-3)
    assert got["cg_iter_ms"] == pytest.approx(24.0 / 20)
    assert got["linesearch_ms"] == pytest.approx(8.0 / 2)
    assert got["host_reads_per_update"] == pytest.approx(21 / 2)
    assert got["ls_evals_per_update"] == pytest.approx(20 / 2)


@pytest.mark.parametrize("metric", NEW)
def test_readers_read_nothing_without_device_spans(program, metric,
                                                   monkeypatch):
    ctx = _ctx("humanoid-sim.update")
    assert metric_reader(metric).read(ctx) is None        # nothing recorded
    program.SPAN_COUNTS.update({"trpo/grad_and_surrogate": 2,
                                "trpo/linesearch/trial": 20})
    assert metric_reader(metric).read(ctx) is None        # a CPU stretch
    _fill(program)
    program.SPANS.dropped = 1
    assert metric_reader(metric).read(ctx) is None        # past the cap
    program.SPANS.dropped = 0
    assert metric_reader(metric).read(ctx) is not None
    monkeypatch.delattr(program, "SPANS")
    assert metric_reader(metric).read(ctx) is None        # an older program


def test_cpu_traced_run_reports_none_of_them():
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run_spans",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cell = "humanoid-sim.update"
    r = mod.run_cell(cell, 6_000_000_007, 0.5, True, device="cpu",
                     config=small_config(cell))
    assert r["correct"] is True
    assert not set(NEW) & set(r["metrics"])
    assert {m["name"] for m in Cell(cell).per_layer} >= set(NEW)


@pytest.mark.gpu
def test_traced_flagship_run_reports_all_five():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cells run on the card)")
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_run_spans_gpu",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    r = mod.run_cell("humanoid-sim.update", 7_000_000_011, 2.0, True)
    assert r["correct"] is True
    values = {m: r["metrics"][m]["value"] for m in NEW}
    assert 0 < values["fvp.roofline"] <= r["metrics"]["k1.roofline"]["value"]
    assert values["cg_iter_ms"] > 0 and values["linesearch_ms"] > 0
    assert values["host_reads_per_update"] >= 1
    assert values["ls_evals_per_update"] == 10.0
