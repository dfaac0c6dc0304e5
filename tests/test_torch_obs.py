"""The port's telemetry (``trpo_torch/obs/``) against the reference's
(``trpo_tpu/obs/``): the event schema (the reference's own
``validate_event`` accepts every record the port writes), the JSONL
sink's crash-safe tail, the health rules (the same findings on the same
rows), the recompile counterpart (kernel builds and graph captures), the
allocator gauges, the status endpoint (``render_prometheus`` byte-identical
for one snapshot), ``Telemetry`` through ``learn`` on every driver, and
the run-cumulative solver counters in ``TrainState`` (every key of the
reference's row, equal to the running sums, restored at zero from a
checkpoint written without them, continued exactly on resume).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.envs import native_build
from trpo_torch.obs import (
    EventBus,
    HealthConfig,
    HealthMonitor,
    JsonlSink,
    RecompileMonitor,
    StatusServer,
    StatusSink,
    Telemetry,
    live_memory_gauges,
    manifest_fields,
    program_memory_analysis,
    render_prometheus,
    validate_event,
)
from trpo_torch.obs.device_metrics import METRIC_KEYS
from trpo_torch.ops.flat import tree_map
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger
from trpo_tpu.obs import events as ref_events
from trpo_tpu.obs import health as ref_health
from trpo_tpu.obs import server as ref_server

TINY = dict(env="cartpole", n_envs=4, batch_timesteps=64, cg_iters=4,
            vf_train_steps=5, policy_hidden=(16,), n_iterations=2)


def _agent(**kw):
    return TRPOAgent("cartpole", TRPOConfig(**{**TINY, **kw}), device="cpu")


class Rows(StatsLogger):
    def __init__(self):
        super().__init__(stream=open("/dev/null", "w"))
        self.rows = []

    def log(self, iteration, stats):
        super().log(iteration, stats)
        self.rows.append(dict(stats))


def _both_valid(rec):
    assert validate_event(rec) == [], rec
    assert ref_events.validate_event(rec) == [], rec


# ---------------------------------------------------------------------------
# the event schema and the sinks
# ---------------------------------------------------------------------------


def test_event_schema_roundtrip_and_reference_validator(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    bus = EventBus(JsonlSink(path))
    bus.emit("run_manifest", **manifest_fields(TRPOConfig(), device="cpu"))
    bus.emit("iteration", iteration=1,
             stats={"entropy": torch.tensor(0.5), "n": np.int64(3),
                    "ok": np.bool_(True)})
    bus.emit("phase", name="iteration", ms=1.5, calls=2, total_s=0.003)
    bus.emit("health", check="nan_guard", level="error", message="m")
    bus.emit("recompile", program="build:x", count=1, unexpected=False)
    bus.emit("memory", scope="live", iteration=1, live_buffer_bytes=0)
    bus.emit("status", port=8080, url="http://127.0.0.1:8080")
    bus.emit("recovery", action="restore", reason="nan_guard", iteration=3)
    bus.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["kind"] for r in recs] == [
        "run_manifest", "iteration", "phase", "health", "recompile",
        "memory", "status", "recovery"]
    for rec in recs:
        _both_valid(rec)
    # 0-d tensors and numpy scalars come out as JSON scalars
    assert recs[1]["stats"] == {"entropy": 0.5, "n": 3, "ok": True}
    man = recs[0]
    assert man["jax_version"] == "n/a" and man["backend"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["device_name"] == "cpu" and man["schema"] == "trpo-tpu-events"


def test_event_bus_rejects_invalid_and_unknown():
    bus = EventBus()
    with pytest.raises(ValueError, match="unknown kind"):
        bus.emit("no_such_kind", x=1)
    with pytest.raises(ValueError, match="level"):
        bus.emit("health", check="c", level="fatal", message="m")
    with pytest.raises(ValueError, match="iteration"):
        bus.emit("iteration", iteration="1", stats={})


def test_jsonl_sink_repairs_a_crash_cut_tail(tmp_path):
    path = tmp_path / "ev.jsonl"
    path.write_text('{"v": 1}\n{"v": 1, "kind": "hea')
    bus = EventBus(JsonlSink(str(path)))
    bus.emit_batch("phase", [{"name": "a", "ms": 1.0},
                             {"name": "b", "ms": 2.0}])
    bus.close()
    lines = path.read_text().splitlines()
    assert lines[0] == '{"v": 1}' and len(lines) == 3
    assert [json.loads(x)["name"] for x in lines[1:]] == ["a", "b"]


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------


def test_health_rules_match_the_reference():
    """The same rows through both monitors: the same findings, in the same
    order (names, levels, iterations), including the ladder's fallback and
    pin, the drain bound and the memory-leak window."""
    cfg = dict(rollback_streak=2, ev_collapse=-0.5, ev_warmup_iterations=0,
               memory_leak_window=4, memory_leak_min_growth=1000,
               memory_leak_warmup=1)
    base = {"entropy": 1.0, "vf_explained_variance": 0.5,
            "kl_rolled_back": False, "nan_guard": False, "fallbacks": 0,
            "solve_pinned": False}
    rows = [base, {**base, "kl_rolled_back": True},
            {**base, "kl_rolled_back": True},
            {**base, "kl_rolled_back": True},
            {**base, "vf_explained_variance": -2.0},
            {**base, "vf_explained_variance": 0.9},
            {**base, "fallbacks": 1, "solve_cosine": 0.9},
            {**base, "fallbacks": 1, "solve_pinned": True},
            {**base, "entropy": float("nan"), "nan_guard": True}]
    found = []
    for mod in (ref_health, None):
        events = []
        if mod is None:
            mon = HealthMonitor(bus=EventBus(events.append),
                                config=HealthConfig(**cfg))
        else:
            mon = mod.HealthMonitor(
                bus=ref_events.EventBus(events.append),
                config=mod.HealthConfig(**cfg))
        for i, row in enumerate(rows, 1):
            mon.observe_iteration(i, row)
        mon.observe_drain(1, 1, 2)
        mon.observe_drain(0, 2, 2)
        for i, b in enumerate([0, 2000, 2400, 2800, 3200, 3600]):
            mon.observe_memory(20 + i, 10_000 + b)
        found.append([(e["check"], e["level"], e.get("iteration"))
                      for e in events])
        for e in events:
            _both_valid(e)
    assert found[0] == found[1]
    assert [c for c, _, _ in found[1]] == [
        "kl_rollback_streak", "ev_collapse", "solve_fallback",
        "solve_pinned", "nan_entropy", "nan_guard",
        "stats_drain_backpressure", "memory_leak"]


def test_recompile_monitor_flags_a_forced_rebuild_after_steady(tmp_path):
    """A kernel build is the port's "compile": a native env library built
    again after the run is marked steady is an unexpected rebuild."""
    recs = []
    mon = RecompileMonitor(bus=EventBus(recs.append))
    with mon:
        native_build.build(tmp_path / "a")
        mon.mark_steady()
        native_build.build(tmp_path / "a")      # cached: not a build
        native_build.build(tmp_path / "b")      # forced: a new build
    native_build.build(tmp_path / "c")          # stopped: not counted
    name = "build:" + native_build.LIB_NAME
    assert mon.total_compiles() == {name: 2}
    assert mon.unexpected_retraces() == {name: 1}
    assert [(r["count"], r["unexpected"]) for r in recs] == [
        (1, False), (2, True)]
    for rec in recs:
        _both_valid(rec)


def test_memory_gauges_on_the_cpu_and_no_program_analysis():
    g = live_memory_gauges("cpu")
    assert g == {"device": "cpu", "live_buffer_bytes": 0,
                 "device_bytes_reserved": 0, "device_peak_bytes": 0}
    with pytest.raises(NotImplementedError, match="live_memory_gauges"):
        program_memory_analysis(None, ())


# ---------------------------------------------------------------------------
# the status endpoint
# ---------------------------------------------------------------------------


def _fold(sink_cls, bus_cls):
    sink = sink_cls()
    bus = bus_cls(sink)
    bus.emit("run_manifest", **manifest_fields(None, device="cpu"))
    bus.emit("iteration", iteration=3,
             stats={"mean_episode_reward": float("nan"), "entropy": 0.25,
                    "linesearch_success": True, "cg_iters_total": 12})
    bus.emit("health", check="ev_collapse", level="warn", message="m",
             iteration=3)
    bus.emit("recompile", program="build:x", count=2, unexpected=True)
    bus.emit("memory", scope="live", iteration=3, device="cpu",
             live_buffer_bytes=7)
    sink.set_phases({"iteration": {"mean_ms": 1.25, "calls": 3,
                                   "total_s": 0.00375}})
    sink.set_gauges(depth=1, high_water=2, maxsize=2)
    return sink.snapshot


def test_render_prometheus_is_byte_identical_to_the_reference():
    snap = _fold(StatusSink, EventBus)
    text = render_prometheus(snap)
    assert text == ref_server.render_prometheus(snap)
    assert text == ref_server.render_prometheus(
        _fold(ref_server.StatusSink, ref_events.EventBus))
    assert "trpo_iteration 3\n" in text
    assert 'trpo_iteration_stat{stat="mean_episode_reward"} NaN' in text
    assert "trpo_recompile_unexpected_total 1" in text


def test_status_server_serves_status_metrics_and_404():
    sink = StatusSink()
    server = StatusServer(sink, 0)
    try:
        EventBus(sink).emit("iteration", iteration=5,
                            stats={"reward": float("nan")})
        with urllib.request.urlopen(server.url + "/status") as r:
            snap = json.loads(r.read())
        assert snap["iteration"] == 5 and snap["stats"]["reward"] is None
        with urllib.request.urlopen(server.url + "/metrics") as r:
            assert b"trpo_iteration 5" in r.read()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url + "/nope")
    finally:
        server.close()


# ---------------------------------------------------------------------------
# Telemetry through learn
# ---------------------------------------------------------------------------


def test_learn_with_every_telemetry_option(tmp_path):
    """A cartpole ``learn`` with every option on: each JSONL record passes
    the reference's validator, one iteration event per iteration, a live
    memory record per iteration, the status endpoint mid-run, 0
    unexpected builds after steady, and the profiler window's trace."""
    path = str(tmp_path / "ev.jsonl")
    tel = Telemetry(events_jsonl=path, health_checks=True, status_port=0,
                    memory_accounting=True,
                    profile_dir=str(tmp_path / "prof"), profile_iteration=2)
    scraped = []

    def scrape(state, stats):
        with urllib.request.urlopen(tel.status_server.url + "/metrics") as r:
            scraped.append(r.read().decode())

    try:
        _agent(n_iterations=3).learn(logger=Rows(), telemetry=tel,
                                     callback=scrape)
    finally:
        tel.close()
    recs = [json.loads(line) for line in open(path)]
    for rec in recs:
        _both_valid(rec)
    kinds = [r["kind"] for r in recs]
    assert kinds[:2] == ["run_manifest", "status"]
    assert [r["iteration"] for r in recs if r["kind"] == "iteration"] == [
        1, 2, 3]
    assert kinds.count("memory") == 3 and "phase" in kinds
    assert not [r for r in recs if r["kind"] == "recompile"
                and r["unexpected"]]
    assert recs[0]["driver"] == "serial" and recs[0]["n_iterations"] == 3
    assert ["trpo_iteration 1" in s for s in scraped] == [True, False, False]
    assert "trpo_iteration 3" in scraped[-1]
    assert len(tel.profile_traces) == 1
    trace = json.load(open(tel.profile_traces[0]))
    assert any("iteration" in str(e.get("name")) for e in
               trace["traceEvents"])


def test_the_profile_window_closes_when_learn_raises(tmp_path):
    tel = Telemetry(profile_dir=str(tmp_path / "prof"), profile_iteration=1)
    agent = _agent()
    state = agent.init_state()
    poisoned = state._replace(policy_params=tree_map(
        lambda t: t * float("nan"), state.policy_params))
    with pytest.raises(FloatingPointError):
        agent.learn(state=poisoned, logger=Rows(), telemetry=tel)
    assert tel._profiler is None and len(tel.profile_traces) == 1
    tel.close()


def test_overlap_driver_emits_rows_and_train_spans():
    """The overlapped loop: one iteration event per iteration and, with a
    trace rate, a ``train/run`` root over each window's chunk spans and
    each update's stage spans, every parent present."""
    recs = []
    tel = Telemetry(sinks=[recs.append])
    agent = _agent(rollout_chunk=4, train_overlap=1, trace_sample_rate=1.0)
    agent.learn(n_iterations=2, logger=Rows(), telemetry=tel)
    tel.close()
    for rec in recs:
        _both_valid(rec)
    assert [r["iteration"] for r in recs if r["kind"] == "iteration"] == [
        1, 2]
    spans = [r for r in recs if r["kind"] == "span"]
    names = {s["name"] for s in spans}
    assert names == {"train/run", "train/rollout_chunk", "train/update",
                     "train/advantage", "train/fvp_cg_solve",
                     "train/linesearch", "train/vf_fit"}
    ids = {s["span"] for s in spans}
    assert all(s.get("parent") in ids for s in spans
               if s["name"] != "train/run")
    assert {s["process"] for s in spans} == {"train"}


# ---------------------------------------------------------------------------
# the run-cumulative solver counters (TrainState.metrics)
# ---------------------------------------------------------------------------


def _reference_row_keys():
    from trpo_tpu.agent import TRPOAgent as TpuAgent
    from trpo_tpu.config import TRPOConfig as TpuConfig
    from trpo_tpu.utils.metrics import StatsLogger as TpuLogger

    rows = []

    class Keep(TpuLogger):
        def log(self, iteration, stats):
            rows.append(dict(stats))

    TpuAgent("cartpole", TpuConfig(**{**TINY, "n_iterations": 1})).learn(
        logger=Keep())
    return set(rows[0])


def test_rows_carry_the_reference_counters_as_running_sums():
    ref_keys = _reference_row_keys()
    logger = Rows()
    _agent(n_iterations=3, cg_residual_rtol=0.3).learn(logger=logger)
    rows = logger.rows
    # the port's row has every key of the reference's (no exception)
    assert ref_keys <= set(rows[0]), ref_keys - set(rows[0])
    running = dict.fromkeys(METRIC_KEYS, 0)
    for row in rows:
        running["cg_iters_total"] += row["cg_iterations"]
        running["cg_early_exit_total"] += row["cg_early_exit"]
        running["linesearch_trials_total"] += row["linesearch_trials"]
        running["rollback_total"] += row["kl_rolled_back"]
        running["nan_guard_total"] += row["nan_guard"]
        assert {k: row[k] for k in METRIC_KEYS} == running
        assert all(type(row[k]) is int for k in METRIC_KEYS)
    assert running["cg_early_exit_total"] > 0  # rtol 0.3 exits early


def test_restore_checkpoint_predating_device_metrics(tmp_path):
    agent = _agent()
    state = agent.init_state()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, state._replace(metrics=None))  # a step written without them
    restored = ck.restore(agent.init_state())
    assert all(int(v) == 0 and v.dtype == torch.int64
               for v in restored.metrics)
    _, stats = agent.run_iteration(restored)
    assert int(stats["cg_iters_total"]) == int(stats["cg_iterations"])


def test_resume_continues_the_counters_exactly(tmp_path):
    agent = _agent()
    whole = Rows()
    agent.learn(n_iterations=3, logger=whole)
    ck = Checkpointer(str(tmp_path / "ck"))
    first = Rows()
    state = agent.learn(n_iterations=2, logger=first)
    ck.save(2, state)
    resumed = Rows()
    agent.learn(n_iterations=1, state=ck.restore(agent.init_state()),
                logger=resumed)
    for k in METRIC_KEYS:
        assert resumed.rows[0][k] == whole.rows[2][k], k


def test_stats_logger_re_emits_rows_on_its_bus():
    recs = []
    logger = StatsLogger(stream=open("/dev/null", "w"),
                         bus=EventBus(recs.append))
    logger.log(4, {"entropy": 0.5, "ok": True})
    assert recs[0]["kind"] == "iteration" and recs[0]["iteration"] == 4
    assert recs[0]["stats"] == {"entropy": 0.5, "ok": True}


def test_async_driver_reports_its_drain_gauges(tmp_path):
    """The host-env async driver drives telemetry from its drain thread:
    every row is an iteration event and the drain gauges reach the status
    snapshot."""
    recs = []
    tel = Telemetry(sinks=[recs.append], status_port=0)
    try:
        agent = TRPOAgent("native:pendulum", TRPOConfig(
            env="native:pendulum", n_envs=4, batch_timesteps=64,
            cg_iters=3, vf_train_steps=2, policy_hidden=(8,),
            host_async_pipeline=True), device="cpu")
        agent.learn(n_iterations=3, logger=Rows(), telemetry=tel)
        snap = tel.status.snapshot
    finally:
        tel.close()
    assert [r["iteration"] for r in recs if r["kind"] == "iteration"] == [
        1, 2, 3]
    assert recs[0]["driver"] == "async"
    assert snap["drain"]["maxsize"] == 2 and snap["finished"]
