"""The port's live observability plane (``trpo_torch/obs/aggregate.py``,
``trpo_torch/obs/alerts.py``, ``python -m trpo_torch.scripts.observatory``
and the validator's alert contracts) against the reference's
(``tests/test_alerts.py``): every case drives both packages with the same
scripted clock and series and asserts the same transitions, the same
series and the same validator errors (wall-clock ``t`` excluded by name).
One more case holds the port's live ``/status`` payloads (the router's and
the train ``StatusServer``'s) to every series ``default_rules`` reads: a
missing path would fail silently, as a rule that never fires.
"""

from __future__ import annotations

import fnmatch
import importlib.util
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

import trpo_torch.obs.aggregate as port_aggregate
import trpo_torch.obs.alerts as port_alerts
import trpo_tpu.obs.aggregate as ref_aggregate
import trpo_tpu.obs.alerts as ref_alerts
from trpo_torch.scripts import observatory as port_observatory
from trpo_torch.scripts import validate_events as port_validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = SimpleNamespace(agg=port_aggregate, alerts=port_alerts)
REF = SimpleNamespace(agg=ref_aggregate, alerts=ref_alerts)


def _no_t(x):
    """Drop wall-clock fields by name, recursively."""
    if isinstance(x, dict):
        return {k: _no_t(v) for k, v in x.items() if k not in ("t",)}
    if isinstance(x, (list, tuple)):
        return [_no_t(v) for v in x]
    return x


def _both(scenario):
    """Run ``scenario(pkg)`` for the reference and the port; they must
    agree exactly. Returns the port's result."""
    want, got = scenario(REF), scenario(PORT)
    assert _no_t(got) == _no_t(want)
    return got


class _Bus:
    """Capture emitted batches like an EventBus (no validation)."""

    def __init__(self):
        self.batches = []

    def emit_batch(self, kind, fields):
        self.batches.append((kind, [dict(f) for f in fields]))

    def kinds(self, kind):
        return [f for k, batch in self.batches if k == kind for f in batch]


def _scripted_agg(m, values, rules, bus=None):
    eng = m.alerts.AlertEngine(rules, bus=bus)
    agg = m.agg.MetricsAggregator(
        [m.agg.CallbackTarget("svc", lambda: dict(values))],
        bus=bus, engine=eng, interval=0.5)
    return agg, eng


def _transcript(eng, bus=None):
    return {
        "history": eng.history,
        "active": eng.active(),
        "firing_total": dict(eng.firing_total),
        "resolved_total": dict(eng.resolved_total),
        "bus": bus.batches if bus is not None else None,
    }


T0 = 1.7e9  # a fixed scripted clock: both packages see the same instants


# ---------------------------------------------------------------------------
# series / parsing primitives
# ---------------------------------------------------------------------------


def test_series_delta_is_reset_aware():
    def run(m):
        s = m.agg.Series()
        out = []
        for t, v in [(0, 0.0), (1, 10.0), (2, 25.0)]:
            s.add(t, v)
        out.append(s.delta(2.0, 2.5))
        s.add(3, 5.0)
        s.add(4, 8.0)
        out.append(s.delta(4.0, 4.5))
        out.append(s.delta(100.0, 1.0))
        return out

    got = _both(run)
    assert got[0] == 25.0
    assert got[1] == pytest.approx(25.0 + 8.0)
    assert got[2] is None


def test_flatten_status_and_prometheus():
    def run(m):
        return (
            m.agg.flatten_status(
                {"a": 1, "b": {"c": 2.5, "d": True}, "e": "str", "f": [1, 2]}),
            m.agg.parse_prometheus(
                "# HELP x y\nfoo 1.5\nbar{l=\"v\"} 2\nbad line here\n"),
        )

    flat, prom = _both(run)
    assert flat == {"status.a": 1.0, "status.b.c": 2.5, "status.b.d": 1.0}
    assert prom == {"foo": 1.5, 'bar{l="v"}': 2.0}


# ---------------------------------------------------------------------------
# rule evaluation
# ---------------------------------------------------------------------------


def test_threshold_lifecycle_and_dedupe():
    def run(m):
        values = {"p99": 10.0, "samples": 100.0}
        rule = m.alerts.Rule(
            "slo", "threshold", series="p99", op=">", threshold=500.0,
            window_s=2.0, guard_series="samples", guard_min=8.0,
            for_ticks=2)
        bus = _Bus()
        agg, eng = _scripted_agg(m, values, [rule], bus=bus)
        steps = []
        agg.tick(now=T0)
        steps.append(eng.active())
        values["p99"] = 900.0
        agg.tick(now=T0 + 1)
        steps.append(eng.active())
        agg.tick(now=T0 + 2)
        steps.append(eng.active())
        agg.tick(now=T0 + 3)
        values["p99"] = 20.0
        agg.tick(now=T0 + 4)
        steps.append(eng.active())
        agg.tick(now=T0 + 5)
        return dict(_transcript(eng, bus), steps=steps)

    got = _both(run)
    assert got["steps"] == [[], [], [("slo", "svc")], []]
    assert got["firing_total"] == {"slo": 1}
    assert got["resolved_total"] == {"slo": 1}
    firing = [e for e in got["history"] if e["state"] == "firing"]
    assert len(firing) == 1 and firing[0]["value"] == 900.0
    assert firing[0]["threshold"] == 500.0 and firing[0]["window_s"] == 2.0
    alerts = [f for k, b in got["bus"] if k == "alert" for f in b]
    assert [a["state"] for a in alerts] == ["firing", "resolved"]


def test_threshold_guard_floor_blocks_thin_windows():
    def run(m):
        values = {"p99": 9999.0, "samples": 2.0}
        rule = m.alerts.Rule(
            "slo", "threshold", series="p99", op=">", threshold=500.0,
            guard_series="samples", guard_min=8.0, for_ticks=1)
        agg, eng = _scripted_agg(m, values, [rule])
        agg.tick(now=T0)
        agg.tick(now=T0 + 1)
        return _transcript(eng)

    assert _both(run)["firing_total"] == {}


def test_burn_rate_needs_both_windows():
    def run(m):
        values = {"good_total": 0.0, "bad_total": 0.0}
        rule = m.alerts.Rule(
            "shed", "burn_rate", series="bad_total",
            total_series=("good_total", "bad_total"), objective=0.99,
            threshold=2.0, window_s=2.0, long_window_s=8.0, min_total=8.0,
            for_ticks=1)
        agg, eng = _scripted_agg(m, values, [rule])
        marks = []
        for i in range(11):
            values["good_total"] = 50.0 * i
            agg.tick(now=T0 + i)
        marks.append(dict(eng.firing_total))
        values["good_total"] = 550.0
        values["bad_total"] = 5.0
        agg.tick(now=T0 + 11)
        marks.append(dict(eng.firing_total))  # a one-tick blip: no page
        for i in range(12, 16):
            values["good_total"] = 50.0 * i
            values["bad_total"] = 5.0 * (i - 10)
            agg.tick(now=T0 + i)
        marks.append(dict(eng.firing_total))
        for i in range(16, 20):
            values["good_total"] = 50.0 * i
            agg.tick(now=T0 + i)
        return dict(_transcript(eng), marks=marks)

    got = _both(run)
    assert got["marks"] == [{}, {}, {"shed": 1}]
    fired = [e for e in got["history"] if e["state"] == "firing"][0]
    assert fired["value"] > 2.0
    assert got["resolved_total"] == {"shed": 1} and got["active"] == []


def test_burn_rate_min_total_floor():
    def run(m):
        values = {"good_total": 0.0, "bad_total": 0.0}
        rule = m.alerts.Rule(
            "shed", "burn_rate", series="bad_total",
            total_series=("good_total", "bad_total"), objective=0.99,
            threshold=2.0, window_s=2.0, long_window_s=8.0, min_total=8.0,
            for_ticks=1)
        agg, eng = _scripted_agg(m, values, [rule])
        for i in range(10):
            values["good_total"] = 0.0
            values["bad_total"] = 0.3 * i
            agg.tick(now=T0 + i)
        return _transcript(eng)

    assert _both(run)["firing_total"] == {}


def test_streak_counts_distinct_keys():
    def run(m):
        values = {"kl_rolled_back": 0.0, "iteration": 0.0}
        rule = m.alerts.Rule(
            "kl_streak", "streak", series="kl_rolled_back",
            key_series="iteration", streak_n=3, window_s=60.0, for_ticks=1)
        agg, eng = _scripted_agg(m, values, [rule])
        marks = []
        values.update(iteration=1.0, kl_rolled_back=1.0)
        for i in range(3):
            agg.tick(now=T0 + i)
        marks.append(dict(eng.firing_total))
        values.update(iteration=2.0)
        agg.tick(now=T0 + 3)
        values.update(iteration=3.0)
        agg.tick(now=T0 + 4)
        marks.append(dict(eng.firing_total))
        values.update(iteration=4.0, kl_rolled_back=0.0)
        agg.tick(now=T0 + 5)
        return dict(_transcript(eng), marks=marks)

    got = _both(run)
    assert got["marks"] == [{}, {"kl_streak": 1}]
    fired = [e for e in got["history"] if e["state"] == "firing"][0]
    assert fired["threshold"] == 3.0
    assert got["resolved_total"] == {"kl_streak": 1}


def test_stall_rule_with_unless_suppressor():
    def run(m):
        values = {"iteration": 1.0}
        rule = m.alerts.Rule("stall", "stall", series="iteration",
                             unless_series="finished", window_s=5.0,
                             for_ticks=1)
        agg, eng = _scripted_agg(m, values, [rule])
        for i in range(3):
            values["iteration"] = float(i)
            agg.tick(now=T0 + i)
        for i in range(3, 10):
            agg.tick(now=T0 + i)
        marks = [dict(eng.firing_total)]
        values["finished"] = 1.0
        agg.tick(now=T0 + 10)
        return dict(_transcript(eng), marks=marks)

    got = _both(run)
    assert got["marks"] == [{"stall": 1}]
    assert got["resolved_total"] == {"stall": 1}


def test_default_rules_cover_issue_minimum():
    def run(m):
        return ([vars(r) for r in m.alerts.default_rules()],
                [vars(r) for r in m.alerts.default_rules(
                    slo_p99_ms=250.0, window_s=1.0)],
                {k: list(v) for k, v in m.alerts.FAULT_ALERT_RULES.items()})

    rules, _, fault_rules = _both(run)
    names = {r["name"] for r in rules}
    assert {
        "slo_p99", "shed_rate", "resumed_fraction", "canary_rejected",
        "lease_expired", "dropped_events", "kl_rollback_streak",
        "fleet_stall", "promoter_stuck", "target_stale",
    } <= names
    for fault, want in fault_rules.items():
        assert want and set(want) <= names, (fault, want)


# ---------------------------------------------------------------------------
# stale-target tolerance
# ---------------------------------------------------------------------------


def test_dead_target_goes_stale_and_alerts_without_wedging():
    def run(m):
        values = {"x": 1.0}
        eng = m.alerts.AlertEngine([m.alerts.Rule(
            "target_stale", "stale", threshold=2.0, for_ticks=2)])
        bus = _Bus()
        agg = m.agg.MetricsAggregator(
            [m.agg.HttpTarget("dead", "http://127.0.0.1:9"),
             m.agg.CallbackTarget("live", lambda: dict(values))],
            bus=bus, engine=eng, interval=0.5, stale_after=2.0, timeout=0.2)
        for i in range(4):
            values["x"] = float(i)
            agg.tick(now=T0 + i * 2.0)
        states = agg.target_states(now=T0 + 6.0)
        ups = [s for s in bus.kinds("metric_sample")
               if s["target"] == "dead" and s["series"] == "up"]
        # the dead target's own error text names the OS's refusal: keep
        # the flags that the rules read
        return {
            "stale": {k: (v["stale"], v["up"]) for k, v in states.items()},
            "active": eng.active(),
            "live_points": len(agg.get_series("live", "x")),
            "last_up": (ups[-1]["value"], ups[-1]["stale"]) if ups else None,
            "history": eng.history,
        }

    got = _both(run)
    assert got["stale"]["dead"] == (True, False)
    assert got["stale"]["live"] == (False, True)
    assert got["active"] == [("target_stale", "dead")]
    assert got["live_points"] == 4
    assert got["last_up"] == (0.0, True)


# ---------------------------------------------------------------------------
# validator alert contracts (good + bad synthetic logs)
# ---------------------------------------------------------------------------


def _write_log(tmp_path, name, records):
    path = tmp_path / name
    base = [{
        "v": 1, "t": T0, "kind": "run_manifest",
        "schema": "trpo-tpu-events", "jax_version": "n/a",
        "backend": "cpu", "config_hash": "deadbeefdeadbeef", "config": None,
    }]
    with open(path, "w") as f:
        for rec in base + records:
            rec.setdefault("v", 1)
            rec.setdefault("t", T0)
            f.write(json.dumps(rec) + "\n")
    return str(path)


def _storm_records(t0):
    sample = {"kind": "metric_sample", "target": "router",
              "series": "status.counters.shed_stateless_total",
              "value": 0.0, "t": t0}
    storm = {"kind": "fault_injected", "fault": "overload_storm", "at": 3,
             "spec": "overload_storm@request=3:rps=50:seconds=2",
             "t": t0 + 1}
    shed = {"kind": "autoscale", "event": "shed", "reason": "backpressure",
            "count": 12, "t": t0 + 1.5}
    firing = {"kind": "alert", "rule": "shed_rate", "state": "firing",
              "target": "router", "window_s": 2.0, "value": 8.0,
              "threshold": 2.0, "t": t0 + 2}
    resolved = {"kind": "alert", "rule": "shed_rate", "state": "resolved",
                "target": "router", "window_s": 2.0, "firing_s": 3.0,
                "t": t0 + 5}
    return sample, storm, shed, firing, resolved


def _alert_logs(tmp_path):
    t0 = T0
    sample, storm, shed, firing, resolved = _storm_records(t0)
    bystander_f = {"kind": "alert", "rule": "fleet_stall", "state": "firing",
                   "target": "m0", "window_s": 30.0, "value": 60.0,
                   "threshold": 30.0, "t": t0 + 2}
    bystander_r = {"kind": "alert", "rule": "fleet_stall",
                   "state": "resolved", "target": "m0", "window_s": 30.0,
                   "firing_s": 1.0, "t": t0 + 3}
    fp = {"kind": "alert", "rule": "lease_expired", "state": "firing",
          "target": "router", "window_s": 4.0, "value": 1.0,
          "threshold": 0.0, "t": t0 + 2.5}
    fp_r = {"kind": "alert", "rule": "lease_expired", "state": "resolved",
            "target": "router", "window_s": 4.0, "firing_s": 1.0,
            "t": t0 + 3.5}
    bad = dict(firing)
    del bad["value"]
    logs = {
        "good": [sample, storm, shed, firing, resolved],
        "missed": [sample, storm, shed, bystander_f, bystander_r],
        "unarmed": [storm, shed, {**sample, "t": t0 + 4}, bystander_f,
                    bystander_r],
        "fp": [sample, storm, shed, firing, resolved, fp, fp_r],
        "stuck": [sample, storm, shed, firing],
        "twice": [sample, storm, shed, firing, {**firing, "t": t0 + 3},
                  resolved],
        "orphan": [sample, storm, shed, firing, resolved,
                   {**resolved, "t": t0 + 6}],
        "malformed": [bad],
    }
    return {k: _write_log(tmp_path, f"{k}.jsonl", [dict(r) for r in recs])
            for k, recs in logs.items()}


def test_validator_alert_contracts(tmp_path):
    ref_validate = _load_script("validate_events")
    paths = _alert_logs(tmp_path)
    errs = {}
    for name, path in paths.items():
        errs[name] = port_validate.validate_file(path)
        assert errs[name] == ref_validate.validate_file(path), name
    assert errs["good"] == [] and errs["unarmed"] == []
    assert any("missed a proven incident" in e for e in errs["missed"])
    assert any("false positive" in e for e in errs["fp"])
    assert any("never resolved" in e for e in errs["stuck"])
    assert any("fired again without resolving" in e for e in errs["twice"])
    assert any("resolved without a matching open firing" in e
               for e in errs["orphan"])
    assert errs["malformed"]


# ---------------------------------------------------------------------------
# observatory CLI
# ---------------------------------------------------------------------------


def test_observatory_once_json(tmp_path, capsys):
    sample, storm, shed, firing, resolved = _storm_records(T0)
    p99 = {"kind": "metric_sample", "target": "router",
           "series": "status.latency_recent_ms.0.99", "value": 333.0,
           "t": T0 + 2}
    log = _write_log(tmp_path, "obs.jsonl",
                     [dict(sample), dict(p99), dict(storm), dict(shed),
                      dict(firing), dict(resolved)])
    ref_observatory = _load_script("observatory")
    outs = {}
    for name, mod in (("ref", ref_observatory), ("port", port_observatory)):
        for mode in ("json", "text"):
            argv = ["--events", log, "--once"] + (
                ["--json"] if mode == "json" else [])
            assert mod.main(argv) == 0
            outs[name, mode] = capsys.readouterr().out
    # the frame's header names the render time: compare the rest
    assert _no_age(outs["port", "text"]) == _no_age(outs["ref", "text"])
    state = json.loads(outs["port", "json"])
    assert _no_t(state) == _no_t(json.loads(outs["ref", "json"]))
    rules = state["alerts"]["rules"]
    assert rules["shed_rate"]["fired"] == 1
    assert rules["shed_rate"]["resolved"] == 1
    assert not rules["shed_rate"]["active"]
    assert not state["alerts"]["firing"]
    assert "shed_rate" in outs["port", "text"]


def _no_age(text):
    return [ln for ln in text.splitlines() if "updated" not in ln
            and not ln.startswith("observatory")]


# ---------------------------------------------------------------------------
# the port's live /status payloads carry every series default_rules reads
# ---------------------------------------------------------------------------


def _rule_series(rule):
    out = []
    for attr in ("series", "guard_series", "key_series", "unless_series"):
        v = getattr(rule, attr)
        if v:
            out.extend([v] if isinstance(v, str) else list(v))
    out.extend(rule.total_series or ())
    return out


def test_live_status_flattens_to_every_default_rule_series(tmp_path):
    """The router's ``/status`` (``serve/router.py``) and the train
    ``StatusServer``'s (``obs/server.py``, with the agent's stats) must
    flatten to a series for every glob a default rule reads on them; the
    fleet and promoter rules read targets the port does not have yet
    (ROADMAP.md Queue 1 item 18.6)."""
    from trpo_torch.obs.telemetry import Telemetry
    from trpo_torch.serve import Router

    from test_torch_router import port_agent, post

    from trpo_torch.obs.capture import RequestCapture
    from trpo_torch.obs.events import EventBus
    from trpo_torch.obs.trace import Tracer

    agent, state = port_agent("cartpole")
    flat = {}
    bus = EventBus()
    tracer = Tracer(bus, 1.0, process="router")
    cap = RequestCapture(bus, process="router")
    rs = _ff_replicas(agent, state.policy_params)
    router = Router(rs, port=0, tracer=tracer, capture=cap)
    try:
        for _ in range(3):
            assert post(router.url + "/act", {"obs": [0.0] * 4})[0] == 200
        # what an observatory target scrapes: /status flattened, and the
        # Prometheus text of /metrics
        flat["router"] = port_aggregate.HttpTarget(
            "router", router.url, metrics_path="/metrics").scrape(30.0)
    finally:
        router.close()
        rs.close()
        tracer.close()
        cap.close()
        bus.close()
    tel = Telemetry(status_port=0)
    try:
        agent.learn(1, telemetry=tel)
        flat["train"] = port_aggregate.HttpTarget(
            "train", tel.status_server.url,
            metrics_path="/metrics").scrape(30.0)
    finally:
        tel.close()
    reads = {
        "router": ("slo_p99", "shed_rate", "resumed_fraction",
                   "dropped_events"),
        "train": ("kl_rollback_streak",),
    }
    rules = {r.name: r for r in port_alerts.default_rules()}
    for surface, names in reads.items():
        for name in names:
            for glob in _rule_series(rules[name]):
                assert any(fnmatch.fnmatch(s, glob) for s in flat[surface]), (
                    surface, name, glob, sorted(flat[surface]))
    assert "status.finished" in flat["train"]


def _ff_replicas(agent, params):
    from trpo_torch.serve import (
        InProcessReplica,
        MicroBatcher,
        PolicyServer,
        ReplicaSet,
    )

    def factory():
        engine = agent.serve_engine()
        engine.load(params, None, step=1)
        batcher = MicroBatcher(engine, deadline_ms=1.0)
        return PolicyServer(engine, batcher, port=0), [batcher]

    rs = ReplicaSet(lambda rid: InProcessReplica(factory), 1,
                    health_interval=60.0)
    assert rs.wait_healthy(1, timeout=60.0), rs.snapshot()
    return rs


# ---------------------------------------------------------------------------
# e2e: live threads, real HTTP target, log validates
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_live_plane_end_to_end(tmp_path):
    """Real poller/evaluator threads against a live HTTP /status
    endpoint, one plane per package: breach -> firing, recovery ->
    resolved, target death -> target_stale; both logs pass both
    validators but for the one expected lifecycle error (target_stale
    never resolves: the target is gone for good)."""
    import http.server

    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields

    ref_validate = _load_script("validate_events")

    def run(m, log):
        status = {"latency_recent_ms": {"p99": 10.0},
                  "latency_recent_samples": 100.0}

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                body = json.dumps(status).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        bus = EventBus(JsonlSink(log))
        bus.emit("run_manifest", **manifest_fields(
            None, extra={"driver": "test_alerts"}, device="cpu"))
        eng = m.alerts.AlertEngine([
            m.alerts.Rule("slo_p99", "threshold",
                          series="status.latency_recent_ms.p99", op=">",
                          threshold=500.0, window_s=1.0,
                          guard_series="status.latency_recent_samples",
                          guard_min=8.0, for_ticks=2),
            m.alerts.Rule("target_stale", "stale", threshold=1.0,
                          for_ticks=2),
        ], bus=bus)
        agg = m.agg.MetricsAggregator(
            [m.agg.HttpTarget("svc", url)], bus=bus, engine=eng,
            interval=0.05, timeout=0.5, stale_after=1.0).start()

        def wait(pred, timeout=20.0):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return True
                time.sleep(0.02)
            return False

        try:
            assert wait(lambda: agg.latest(
                "svc", "status.latency_recent_ms.p99") is not None)
            status["latency_recent_ms"]["p99"] = 900.0
            assert wait(lambda: eng.firing_total.get("slo_p99"))
            status["latency_recent_ms"]["p99"] = 15.0
            assert wait(lambda: eng.resolved_total.get("slo_p99"))
            httpd.shutdown()
            httpd.server_close()
            assert wait(lambda: eng.firing_total.get("target_stale"))
        finally:
            agg.close()
            bus.close()
        return [(e["rule"], e["state"]) for e in eng.history]

    logs = {n: str(tmp_path / f"{n}.jsonl") for n in ("ref", "port")}
    assert run(PORT, logs["port"]) == run(REF, logs["ref"]) == [
        ("slo_p99", "firing"), ("slo_p99", "resolved"),
        ("target_stale", "firing")]
    for path in logs.values():
        errs = port_validate.validate_file(path)
        assert errs == ref_validate.validate_file(path)
        assert errs and all("target_stale" in e for e in errs), errs
