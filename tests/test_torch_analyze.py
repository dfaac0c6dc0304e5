"""The port's offline analysis (``trpo_torch/obs/analyze.py`` and
``python -m trpo_torch.scripts.analyze_run``) against the reference's
(``trpo_tpu/obs/analyze.py``, ``scripts/analyze_run.py``): the same
records go through both packages' ``summarize_run``, ``compare_runs``,
``render_summary``, ``assemble_traces``, ``trace_breakdown`` and
``render_waterfall``, on a train log the port's CLI wrote (cartpole, 2
iterations on the CPU), a serve log the port's router wrote with traces
and captures, and hand-built fault, canary, promotion, fleet, autoscale,
lease and alert records. The results are equal, but for the two stated
differences: the port's manifest block adds ``torch_version``,
``cuda_version`` and ``device_name``, and its memory line reads
``compiled=n/a`` (the port has no compiled program to account). The CLI's
exit codes are 0 (clean), 1 (regressed) and 2 (bad input) in both.
"""

import json

import pytest

import trpo_torch.obs.analyze as port_analyze
import trpo_tpu.obs.analyze as ref_analyze
from trpo_torch.scripts import analyze_run as port_analyze_run

from test_torch_alerts import _load_script
PORT_MANIFEST_KEYS = ("torch_version", "cuda_version", "device_name")


@pytest.fixture(scope="module")
def train_log(tmp_path_factory):
    """A 2-iteration cartpole log written by the port's train CLI."""
    from trpo_torch.train import main

    d = tmp_path_factory.mktemp("train")
    path = str(d / "train.jsonl")
    main(["--preset", "cartpole", "--device", "cpu", "--iterations", "2",
          "--n-envs", "4", "--batch-timesteps", "64", "--policy-hidden", "8",
          "--metrics-jsonl", path, "--health-checks"])
    return path


@pytest.fixture(scope="module")
def serve_log(tmp_path_factory):
    """A routed pendulum GRU 8 serve log with spans and captures."""
    from test_torch_replay import _record_window

    log, _, _, _ = _record_window(tmp_path_factory.mktemp("serve"), 4)
    return log


def _hand_records():
    t = 1.7e9
    recs = [
        {"kind": "run_manifest", "schema": "trpo-tpu-events",
         "jax_version": "n/a", "backend": "cuda", "config_hash": "ab" * 8,
         "config": None, "driver": "serve", "torch_version": "2.x",
         "cuda_version": "12.x", "device_name": "H100"},
        {"kind": "fault_injected", "fault": "kill_replica", "at": 200,
         "spec": "kill_replica@request=200:replica=0"},
        {"kind": "router", "scope": "replica", "replica": "r0",
         "state": "died", "reason": "killed"},
        {"kind": "router", "scope": "replica", "replica": "r0",
         "state": "evicted"},
        {"kind": "router", "scope": "replica", "replica": "r0",
         "state": "restarted"},
        {"kind": "router", "scope": "host", "host": "h0", "state": "suspect"},
        {"kind": "router", "scope": "request", "ms": 2.5, "ok": True,
         "retried": True, "replica": "r1", "endpoint": "act"},
        {"kind": "router", "scope": "request", "ms": 1.5, "ok": True,
         "retried": False, "replica": "r1", "endpoint": "act"},
        {"kind": "router", "scope": "request", "ms": 30.0, "ok": False,
         "retried": True, "replica": None, "endpoint": "act"},
        {"kind": "lease", "replica": "r0", "event": "granted", "host": "h0",
         "epoch": 1},
        {"kind": "lease", "replica": "r0", "event": "expired", "host": "h0",
         "lag": 2.5},
        {"kind": "session", "session": "s1", "event": "resumed",
         "replica": "r1", "steps": 5},
        {"kind": "session", "session": "s2", "event": "reestablished",
         "replica": "r1"},
        {"kind": "session", "session": "s1", "event": "episode",
         "replica": "r1", "ep_return": 12.5, "ep_steps": 20},
        {"kind": "canary", "step": 5, "event": "started", "replica": "r1"},
        {"kind": "canary", "step": 5, "event": "rolled_back",
         "replica": "r1", "reason": "non-finite actions"},
        {"kind": "promote", "member": "seed1", "event": "candidate",
         "step": 3},
        {"kind": "promote", "member": "seed1", "event": "promoted",
         "step": 3, "episodes": 8, "mean_return": 40.0},
        {"kind": "promote", "member": "seed2", "event": "rejected",
         "step": 4, "reason": "regressed"},
        {"kind": "fleet", "member": "seed0", "state": "launched",
         "attempt": 1},
        {"kind": "fleet", "member": "seed0", "state": "preempted",
         "attempt": 1},
        {"kind": "fleet", "member": "seed0", "state": "requeued",
         "attempt": 2},
        {"kind": "fleet", "member": "seed0", "state": "finished",
         "attempt": 2},
        {"kind": "autoscale", "event": "shed", "reason": "backpressure",
         "count": 12},
        {"kind": "autoscale", "event": "scale_out", "reason": "slo_p99",
         "replica": "r2"},
        {"kind": "autoscale", "event": "drain_started", "reason": "idle",
         "replica": "r2"},
        {"kind": "autoscale", "event": "drain_completed", "reason": "idle",
         "replica": "r2", "duration_s": 1.5, "sessions_moved": 3},
        {"kind": "fault_injected", "fault": "overload_storm", "at": 3,
         "spec": "overload_storm@request=3:rps=50:seconds=2"},
        {"kind": "metric_sample", "target": "router",
         "series": "status.counters.shed_stateless_total", "value": 0.0},
        {"kind": "alert", "rule": "shed_rate", "state": "firing",
         "target": "router", "window_s": 2.0, "value": 8.0,
         "threshold": 2.0},
        {"kind": "alert", "rule": "shed_rate", "state": "resolved",
         "target": "router", "window_s": 2.0, "firing_s": 3.0},
        {"kind": "recovery", "action": "restore", "reason": "nan",
         "iteration": 2},
    ]
    for i, r in enumerate(recs):
        r.setdefault("v", 1)
        r["t"] = t + 0.5 * i
    return recs


def _records(name, train_log, serve_log):
    if name == "train":
        return port_analyze.load_events(train_log)
    if name == "serve":
        return port_analyze.load_events(serve_log)
    return _hand_records()


def _port_minus_added(summary):
    man = summary.get("manifest")
    if man is None:
        return summary
    for key in PORT_MANIFEST_KEYS:
        assert key in man
    return dict(summary, manifest={k: v for k, v in man.items()
                                   if k not in PORT_MANIFEST_KEYS})


@pytest.mark.parametrize("name", ["train", "serve", "hand"])
def test_summaries_renders_and_comparisons_match_reference(
        name, train_log, serve_log):
    recs = _records(name, train_log, serve_log)
    assert ref_analyze.load_events is not None
    got = port_analyze.summarize_run(recs)
    want = ref_analyze.summarize_run(recs)
    assert _port_minus_added(got) == want
    assert port_analyze.render_summary(got) == ref_analyze.render_summary(
        want)
    # a run against itself, and against a copy 50% slower per iteration
    cmp_got = port_analyze.compare_runs(got, got, threshold_pct=10.0)
    assert cmp_got == ref_analyze.compare_runs(want, want,
                                               threshold_pct=10.0)
    assert port_analyze.render_comparison(cmp_got) == (
        ref_analyze.render_comparison(cmp_got))
    if name == "train":
        assert got["iterations"] == 2 and got["manifest"]["driver"]
        slow = dict(got, steady_iteration_ms=got["steady_iteration_ms"] * 1.5)
        assert port_analyze.compare_runs(got, slow, threshold_pct=10.0) == (
            ref_analyze.compare_runs(got, slow, threshold_pct=10.0))
    if name == "hand":
        assert got["alerts"]["rules"]["shed_rate"]["fired"] == 1
        assert got["fleet"] is not None and got["router"] is not None


def test_traces_assemble_and_render_as_the_reference(serve_log):
    recs = port_analyze.load_events(serve_log)
    dropped_p, dropped_r = [], []
    traces = port_analyze.assemble_traces(recs, dropped=dropped_p)
    assert traces == ref_analyze.assemble_traces(recs, dropped=dropped_r)
    assert dropped_p == dropped_r == []
    assert len(traces) == 4 + 1  # the session create and the 4 acts
    for tid, spans in traces.items():
        assert port_analyze.trace_breakdown(spans) == (
            ref_analyze.trace_breakdown(spans))
        assert port_analyze.render_waterfall(spans) == (
            ref_analyze.render_waterfall(spans))
    assert port_analyze._summarize_traces(recs) == (
        ref_analyze._summarize_traces(recs))


def test_memory_block_reads_na_where_the_reference_lists_programs():
    """The stated difference: live gauges render alike, and where the
    reference would list compiled footprints the port says n/a."""
    recs = _hand_records()[:1] + [
        {"v": 1, "t": 1.7e9 + 1, "kind": "memory", "scope": "live",
         "live_buffer_bytes": 2048, "iteration": 1}]
    got = port_analyze.summarize_run(recs)
    assert _port_minus_added(got) == ref_analyze.summarize_run(recs)
    assert got["memory"] == {"programs": {},
                             "peak_live_buffer_bytes": 2048}
    text = port_analyze.render_summary(got)
    ref_text = ref_analyze.render_summary(ref_analyze.summarize_run(recs))
    assert text.replace(" compiled=n/a", "") == ref_text
    assert "compiled=n/a" in text


def test_analyze_run_exit_codes_match_reference(train_log, serve_log,
                                                tmp_path, capsys):
    """0 summarized / compared clean, 1 regressed, 2 bad input — and the
    same JSON summary and trace output as the reference's script."""
    ref = _load_script("analyze_run")
    rows = [json.loads(ln) for ln in open(train_log)]
    slow = str(tmp_path / "slow.jsonl")
    with open(slow, "w") as f:
        for r in rows:
            if r.get("kind") == "iteration":
                r = dict(r, stats=dict(r["stats"], iteration_ms=r["stats"][
                    "iteration_ms"] * 3.0))
            f.write(json.dumps(r) + "\n")
    tid = next(r["trace"] for r in port_analyze.load_events(serve_log)
               if r.get("kind") == "capture")
    cases = [
        ([train_log], 0),
        ([train_log, "--json"], 0),
        ([train_log, "--compare", train_log], 0),
        ([slow, "--compare", train_log, "--threshold-pct", "20"], 1),
        ([str(tmp_path / "absent.jsonl")], 2),
        ([serve_log, "--trace", tid], 0),
        ([serve_log, "--trace", "0" * 16], 2),
        ([serve_log, "--slowest-traces", "2", "--json"], 0),
    ]
    for argv, code in cases:
        outs = []
        for mod in (ref, port_analyze_run):
            assert mod.main(argv) == code, argv
            outs.append(capsys.readouterr())
        if "--json" in argv and "--slowest-traces" not in argv:
            got, want = (json.loads(o.out) for o in (outs[1], outs[0]))
            assert _port_minus_added(got) == want
        elif code != 2:
            assert outs[1].out == outs[0].out, argv
        assert code != 2 or outs[1].err == outs[0].err
