"""The port's replay bundles (``trpo_torch/obs/replay.py``) and its
``analyze_run --export-bundle`` / ``replay_run`` / ``validate_events``
entry points against the reference's (``tests/test_replay.py``): the
same capture records, spans and carry journals go through both
``build_bundle``s and must give equal bundles (the fenced zombie's frozen
journal as the mid-window seed, every missing piece named), the same
errors, the same version gate and oracle, and the CLI's and validator's
same exit codes and errors. One in-process leg records a pendulum GRU 8
window through the port's router with capture armed, one act at a time,
exports it mid-session and replays it through the port's shadow set:
``REPLAY BIT-EXACT``. The two CLI legs (bit-exact, then a divergence
detected) are slow, as the reference's are.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

import trpo_torch.obs.replay as port_replay
import trpo_tpu.obs.replay as ref_replay
from trpo_torch.obs.analyze import load_events
from trpo_torch.obs.capture import (
    RequestCapture,
    capture_records,
    encode_obs_payload,
)
from trpo_torch.obs.events import (
    SCHEMA_VERSION,
    EventBus,
    JsonlSink,
    manifest_fields,
    validate_event,
)
from trpo_torch.obs.trace import TRACE_HEADER, Tracer, mint_trace_id
from trpo_torch.scripts import analyze_run as port_analyze_run
from trpo_torch.scripts import replay_run as port_replay_run
from trpo_torch.scripts import validate_events as port_validate

from test_torch_alerts import _load_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both_bundles(*args, **kw):
    """``build_bundle`` of both packages on the same input: equal."""
    got = port_replay.build_bundle(*args, **kw)
    assert got == ref_replay.build_bundle(*args, **kw)
    return got


def _both_raise(match, *args, **kw):
    msgs = []
    for mod in (port_replay, ref_replay):
        with pytest.raises(mod.BundleError, match=match) as e:
            mod.build_bundle(*args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _mk_capture(tid, order, t, seq, obs, action, sid="s1", step=1):
    rec = {
        "v": SCHEMA_VERSION, "kind": "capture", "t": t,
        "trace": tid, "order": order, "path": f"/session/{sid}/act",
        "endpoint": "session_act", "status": 200, "session": sid,
        "seq": seq, "step": step, "action": list(action),
        "payload": encode_obs_payload(np.asarray(obs, np.float32), seq=seq),
        "process": "router",
    }
    assert not validate_event(rec), validate_event(rec)
    return rec


def _mk_span(tid, name, t, dur=1.0, **attrs):
    rec = {"v": SCHEMA_VERSION, "kind": "span", "t": t, "trace": tid,
           "span": f"{name}-{t}", "name": name, "start": t, "dur_ms": dur,
           **attrs}
    assert not validate_event(rec), validate_event(rec)
    return rec


def _journal_write(path, entries):
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


# -- bundle reconstruction -------------------------------------------------


def test_bundle_mid_window_seed_from_zombie_journal(tmp_path):
    jdir = tmp_path / "cj"
    jdir.mkdir()

    def mk(seq):
        return {"session": "s1", "steps": seq, "seq": seq,
                "carry": [0.1 * seq] * 3, "t": 100.0 + seq,
                "last_action": [0.5], "last_step": 1}

    _journal_write(jdir / "hostA--r0.carry.jsonl",
                   [mk(s) for s in (1, 2, 3, 4)])
    _journal_write(jdir / "hostB--r1.carry.jsonl", [mk(s) for s in (5, 6)])
    # the zombie's fence sidecar: scan_journals reads fenced files anyway
    (jdir / "hostA--r0.carry.jsonl.fence").write_text(
        json.dumps({"session": "s1", "t": 104.5}) + "\n")
    obs = np.ones(3, np.float32)
    records = []
    for i, seq in enumerate((5, 6)):
        tid = f"{seq:016x}"
        records.append(_mk_capture(tid, i, 200.0 + i, seq, obs, [0.1]))
        records.append(_mk_span(tid, "router.session_act", 200.0 + i))
    bundle = _both_bundles(records, window=(199.0, 203.0),
                           journal_dir=str(jdir))
    assert bundle["replayable"] is True, bundle["completeness"]
    sess = bundle["sessions"]["s1"]
    assert sess["first_seq"] == 5 and sess["seed"]["seq"] == 4
    assert sess["seed"]["journal"] == "hostA--r0.carry.jsonl"
    assert bundle["checkpoint_step"] == 1
    scanned = port_replay.scan_journals(str(jdir))
    assert scanned == ref_replay.scan_journals(str(jdir))
    assert [e["seq"] for e in scanned["s1"]] == [1, 2, 3, 4, 5, 6]


def test_bundle_missing_journal_seed_named(tmp_path):
    jdir = tmp_path / "cj"
    jdir.mkdir()
    _journal_write(jdir / "hostA--r0.carry.jsonl",
                   [{"session": "s1", "steps": 2, "seq": 2, "carry": [0.0],
                     "t": 100.0}])
    obs = np.zeros(2, np.float32)
    records = [_mk_capture("a" * 16, 0, 200.0, 5, obs, [0.1]),
               _mk_span("a" * 16, "router.session_act", 200.0)]
    bundle = _both_bundles(records, trace_id="a" * 16,
                           journal_dir=str(jdir))
    assert bundle["replayable"] is False
    (comp,) = bundle["completeness"]
    assert any("journal snapshot at seq 4" in m for m in comp["missing"])


def test_bundle_payloadless_and_spanless_named():
    rec = {"v": SCHEMA_VERSION, "kind": "capture", "t": 50.0,
           "trace": "b" * 16, "order": 0, "path": "/act", "endpoint": "act",
           "status": 200}
    assert not validate_event(rec)
    (comp,) = _both_bundles([rec], trace_id="b" * 16)["completeness"]
    missing = " | ".join(comp["missing"])
    assert not comp["replayable"]
    for piece in ("capture payload", "recorded action",
                  "assembled trace spans"):
        assert piece in missing


def test_bundle_unknown_trace_and_uncaptured_trace_errors():
    spans_only = [_mk_span("c" * 16, "router.act", 10.0)]
    _both_raise("unknown trace id", spans_only, trace_id="9" * 16)
    _both_raise("NO capture records", spans_only, trace_id="c" * 16)
    _both_raise("no capture records in window", spans_only,
                window=(0.0, 100.0))
    _both_raise("exactly one", spans_only)


def test_bundle_roundtrip_and_version_gate(tmp_path):
    obs = np.ones(1, np.float32)
    records = [_mk_capture("d" * 16, 0, 10.0, 1, obs, [0.3]),
               _mk_span("d" * 16, "router.session_act", 10.0)]
    bundle = _both_bundles(records, trace_id="d" * 16)
    assert bundle["replayable"] is True
    assert port_replay.BUNDLE_VERSION == ref_replay.BUNDLE_VERSION
    path = str(tmp_path / "b.json")
    port_replay.write_bundle(bundle, path)
    assert port_replay.load_bundle(path) == bundle
    assert ref_replay.load_bundle(path) == bundle
    port_replay.write_bundle(dict(bundle, bundle_version=99), path)
    for mod, match, p in (
            (port_replay, "version", path), (ref_replay, "version", path),
            (port_replay, "cannot read", str(tmp_path / "absent.json")),
            (ref_replay, "cannot read", str(tmp_path / "absent.json"))):
        with pytest.raises(mod.BundleError, match=match):
            mod.load_bundle(p)


def test_bundles_equal_on_mixed_sessions_and_stateless(tmp_path):
    """A window with two sessions (one seeded, one born inside), a
    stateless act, duplicate router/replica records, a fault timeline and
    recorded spans: both builders give the same bundle."""
    jdir = tmp_path / "cj"
    jdir.mkdir()
    _journal_write(jdir / "r0.carry.jsonl", [
        {"session": "s1", "steps": s, "seq": s, "carry": [0.5 * s, -s],
         "t": 10.0 + s} for s in (1, 2, 3)])
    _journal_write(jdir / "r1.carry.jsonl",
                   [{"session": "s2", "drop": True, "t": 11.0}])
    rng = np.random.default_rng(0)
    records = []
    for i, (sid, seq) in enumerate([("s1", 4), ("s2", 1), ("s1", 5),
                                    ("s2", 2)]):
        tid = f"{i + 1:016x}"
        obs = rng.standard_normal(2).astype(np.float32)
        rec = _mk_capture(tid, i, 20.0 + i, seq, obs, [float(i)], sid=sid)
        records += [rec, dict(rec, process="r0", order=i + 7, t=20.01 + i),
                    _mk_span(tid, "router.session_act", 20.0 + i),
                    _mk_span(tid, "engine.step_batch", 20.0 + i, dur=0.3,
                             parent="x")]
    stateless = dict(_mk_capture("f" * 16, 9, 25.0, 0, np.zeros(2),
                                 [1.0]), path="/act", endpoint="act")
    del stateless["session"], stateless["seq"]
    records += [stateless, _mk_span("f" * 16, "router.act", 25.0),
                {"v": SCHEMA_VERSION, "kind": "fault_injected", "t": 21.0,
                 "fault": "kill_replica", "at": 2,
                 "spec": "kill_replica@request=2:replica=0"}]
    bundle = _both_bundles(records, window=(19.0, 30.0),
                           journal_dir=str(jdir))
    assert bundle["acts_total"] == 5 and bundle["replayable"] is True
    assert bundle["sessions"]["s1"]["seed"]["seq"] == 3
    assert bundle["sessions"]["s2"]["seed"] is None
    assert len(bundle["stateless"]) == 1 and len(bundle["faults"]) == 1


# -- diff oracle -----------------------------------------------------------


def test_action_match_is_bit_exact_float64():
    a = [0.1234567890123456, -1.0000000000000002]
    cases = [(a, list(a)), (a, [0.1234567890123456, -1.0]), ([0.1], [0.1, 0.2]),
             ([[0.1]], [0.1]), (None, [0.1]), ([1, 2], [1.0, 2.0]),
             (1, 1.0), ([0.1], ["x"])]
    got = [port_replay.action_match(x, y) for x, y in cases]
    assert got == [ref_replay.action_match(x, y) for x, y in cases]
    assert got == [True, False, False, False, False, True, True, False]


# -- export CLI ------------------------------------------------------------


def _write_log(path, records):
    mani = {"v": SCHEMA_VERSION, "kind": "run_manifest", "t": 1.0,
            **manifest_fields(None, extra={"driver": "test"}, device="cpu")}
    with open(path, "w") as f:
        for r in [mani] + records:
            f.write(json.dumps(r) + "\n")


def _cli(mod, argv, capsys):
    """``(exit code, stdout, stderr)`` of one in-process CLI run."""
    code = mod.main(argv)
    out = capsys.readouterr()
    return code, out.out, out.err


def test_export_bundle_cli_contract(tmp_path, capsys):
    """``--export-bundle``: exit 0 and the same bundle on disk for a
    captured trace, exit 2 with the same one-line reason on an unknown
    trace, a missing selector or an empty window, in both packages."""
    ref = _load_script("analyze_run")
    obs = np.ones(2, np.float32)
    log = str(tmp_path / "run.jsonl")
    _write_log(log, [_mk_capture("f" * 16, 0, 10.0, 1, obs, [0.7]),
                     _mk_span("f" * 16, "router.session_act", 10.0)])
    outs = {}
    for name, mod in (("ref", ref), ("port", port_analyze_run)):
        out = str(tmp_path / f"{name}.json")
        code, _, err = _cli(mod, [log, "--export-bundle", "f" * 16,
                                  "--out", out], capsys)
        assert code == 0, err
        outs[name] = port_replay.load_bundle(out)
    assert outs["port"] == outs["ref"] and outs["port"]["acts_total"] == 1
    for argv, match in (
            (["--export-bundle", "0" * 16], "unknown trace id"),
            (["--export-bundle"], "exactly one selector"),
            (["--export-bundle", "--window", "900.0", "901.0"],
             "no capture records in window")):
        errs = []
        for mod in (ref, port_analyze_run):
            code, _, err = _cli(mod, [log] + argv, capsys)
            assert code == 2 and match in err, (argv, err)
            errs.append(err)
        assert errs[0] == errs[1]


# -- validator replay-complete contracts -----------------------------------


def _replay_recs(drop_verdict=False, drop_complete=False, planned=None):
    tid = "a" * 16
    recs = [{"v": SCHEMA_VERSION, "kind": "replay", "t": 2.0,
             "event": "begin", "acts": planned or 1},
            {"v": SCHEMA_VERSION, "kind": "replay", "t": 3.0,
             "event": "act", "trace": tid, "order": 0, "status": 200}]
    if not drop_verdict:
        recs.append({"v": SCHEMA_VERSION, "kind": "replay", "t": 4.0,
                     "event": "verdict", "trace": tid, "order": 0,
                     "match": True})
    if not drop_complete:
        recs.append({"v": SCHEMA_VERSION, "kind": "replay", "t": 5.0,
                     "event": "complete", "acts": planned or 1,
                     "mismatches": 0})
    return recs


def test_validator_replay_contracts(tmp_path):
    ref = _load_script("validate_events")
    cases = {"good": ({}, None), "nv": ({"drop_verdict": True},
                                        "no diff verdict"),
             "nc": ({"drop_complete": True}, "never emitted its complete"),
             "short": ({"planned": 2}, "planned 2")}
    for name, (kw, match) in cases.items():
        path = str(tmp_path / f"{name}.jsonl")
        _write_log(path, _replay_recs(**kw))
        errs = port_validate.validate_file(path)
        assert errs == ref.validate_file(path), name
        if match is None:
            assert errs == []
        else:
            assert any(match in e for e in errs), (name, errs)
        assert port_validate.main([path]) == (0 if match is None else 1)


# -- the capture step is the dispatched snapshot's -------------------------


def test_capture_step_is_the_snapshot_the_act_ran_on(tmp_path):
    """A reload between two acts: each capture record names the step its
    act was answered with (the engine's dispatched snapshot), on the
    replica and on the router."""
    from trpo_torch.serve import Router

    from test_torch_alerts import _ff_replicas
    from test_torch_router import port_agent, post

    agent, state = port_agent("cartpole")
    recs = []
    bus = EventBus(lambda r: recs.append(r))
    tracer = Tracer(bus, 1.0, process="router")
    rcap = RequestCapture(bus, process="router")
    scap = RequestCapture(bus, process="r0")
    rs = _ff_replicas(agent, state.policy_params)
    server = rs.replicas["r0"].handle.server
    server.tracer, server.capture = Tracer(bus, 0.0, process="r0"), scap
    router = Router(rs, port=0, tracer=tracer, capture=rcap)
    try:
        steps = []
        for step in (1, 2):
            server.engine.load(state.policy_params, None, step=step)
            status, body = post(router.url + "/act", {"obs": [0.1] * 4})
            assert status == 200
            steps.append(body["step"])
        for c in (rcap, scap):
            c.drain()
    finally:
        router.close()
        rs.close()
        for c in (rcap, scap, tracer, server.tracer):
            c.close()
        bus.close()
    assert steps == [1, 2]
    caps = capture_records(recs)
    for process in ("router", "r0"):
        assert [c["step"] for c in caps if c["process"] == process] == [1, 2]


# -- live shadow replay ----------------------------------------------------


_E2E_CFG = dict(n_envs=4, batch_timesteps=32, cg_iters=2, vf_train_steps=2,
                policy_hidden=(8,), vf_hidden=(8,), seed=5, policy_gru=8)
_MODEL_FLAGS = ["--preset", "pendulum", "--n-envs", "4", "--policy-hidden",
                "8", "--vf-hidden", "8", "--policy-gru", "8", "--device",
                "cpu"]


def _post(url, payload=None, headers=None, timeout=30.0):
    import urllib.error

    data = b"" if payload is None else json.dumps(payload).encode()
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(url, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _record_window(tmp_path, n_acts, steps=(1,)):
    """Record ``n_acts`` acts of one pendulum GRU 8 session, one at a time,
    through the port's router (capture armed) over two journaled
    in-process replicas; ``(log, journal dir, checkpoint dir, sid)``."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig
    from trpo_torch.serve import (
        InProcessReplica,
        PolicyServer,
        ReplicaSet,
        Router,
    )
    from trpo_torch.utils.checkpoint import Checkpointer

    agent = TRPOAgent("pendulum", TRPOConfig(**_E2E_CFG), device="cpu")
    state = agent.init_state(seed=0)
    ck_dir = str(tmp_path / "ck")
    ck = Checkpointer(ck_dir)
    ck.save(1, state)
    if 2 in steps:  # a DIFFERENT step 2: replaying step 1's actions diverges
        ck.save(2, agent.init_state(seed=123))
    log = str(tmp_path / "recorded.jsonl")
    bus = EventBus(JsonlSink(log))
    bus.emit("run_manifest", **manifest_fields(
        None, extra={"driver": "test_replay"}, device="cpu"))
    tracer = Tracer(bus, 1.0, process="router")
    cap = RequestCapture(bus, process="router")
    jdir = str(tmp_path / "cj")

    def factory(rid):
        def build():
            engine = agent.serve_session_engine()
            engine.load(state.policy_params, state.obs_norm, step=1)
            return PolicyServer(engine, None, port=0, bus=bus, tracer=tracer,
                                replica_name=rid,
                                carry_journal_dir=jdir), []
        return build

    rs = ReplicaSet(lambda rid: InProcessReplica(factory(rid)), 2, bus=bus,
                    health_interval=60.0, backoff=0.05,
                    health_fail_threshold=1, max_restarts=2)
    assert rs.wait_healthy(2, timeout=120.0), rs.snapshot()
    router = Router(rs, port=0, bus=bus, journal_dir=jdir, tracer=tracer,
                    capture=cap)
    try:
        status, out = _post(router.url + "/session")
        assert status == 200, out
        sid = out["session"]
        for i in range(n_acts):
            o = np.random.RandomState(100 + i).randn(
                *agent.obs_shape).astype(np.float32)
            status, out = _post(router.url + f"/session/{sid}/act",
                                {"obs": o.tolist()},
                                headers={TRACE_HEADER: mint_trace_id()})
            assert status == 200, (status, out)
        body = urllib.request.urlopen(router.url + "/metrics",
                                      timeout=30.0).read().decode()
        assert f"trpo_capture_requests_total {n_acts}" in body
        assert "trpo_capture_dropped_total 0" in body
        cap.drain()
    finally:
        router.close()
        tracer.drain()
        tracer.close()
        cap.close()
        rs.close()
        bus.close()
    return log, jdir, ck_dir, sid


def test_in_process_shadow_replay_bit_exact(tmp_path, capsys):
    """Record 6 acts, export the last 3 (seeded from the journal snapshot
    at seq 3 through ``Router.restore_session``), replay them through the
    port's shadow set: every action bit-exact, the log validator-clean."""
    log, jdir, ck_dir, sid = _record_window(tmp_path, 6)
    caps = capture_records(load_events(log))
    assert [c["seq"] for c in caps] == [1, 2, 3, 4, 5, 6]
    bundle_path = str(tmp_path / "win.bundle.json")
    code, _, err = _cli(port_analyze_run, [
        log, "--export-bundle", "--window", str(caps[3]["t"] - 1e-4),
        str(time.time()), "--journal-dir", jdir, "--out", bundle_path],
        capsys)
    assert code == 0, err
    bundle = port_replay.load_bundle(bundle_path)
    assert bundle["replayable"] is True, bundle["completeness"]
    assert bundle["sessions"][sid]["first_seq"] == 4
    assert bundle["sessions"][sid]["seed"]["seq"] == 3
    replay_log = str(tmp_path / "replay.jsonl")
    code, out, err = _cli(port_replay_run, [
        bundle_path, "--checkpoint-dir", ck_dir, "--events", replay_log,
        *_MODEL_FLAGS], capsys)
    assert code == 0, (out, err)
    assert f"seeded session {sid} (seq 3)" in out
    assert "0 mismatch(es)" in out and "REPLAY BIT-EXACT" in out
    assert port_validate.validate_file(replay_log) == []
    verdicts = [r for r in load_events(replay_log)
                if r.get("kind") == "replay" and r.get("event") == "verdict"]
    assert len(verdicts) == 3 and all(v["match"] for v in verdicts)


def test_replay_run_refuses_without_a_card(tmp_path, capsys, monkeypatch):
    """``--device`` defaults to the card: without one the run exits 2
    naming the device, and never goes on on the CPU."""
    import torch

    obs = np.ones(3, np.float32)
    path = str(tmp_path / "b.json")
    port_replay.write_bundle(port_replay.build_bundle(
        [_mk_capture("d" * 16, 0, 10.0, 1, obs, [0.3]),
         _mk_span("d" * 16, "router.session_act", 10.0)],
        trace_id="d" * 16), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _cli(port_replay_run,
                          [path, "--checkpoint-dir", str(tmp_path)], capsys)
    assert code == 2 and "--device cuda" in err and "--device cpu" in err
    code, _, err = _cli(port_replay_run, [
        path, "--checkpoint-dir", str(tmp_path / "absent"),
        "--device", "cpu"], capsys)
    assert code == 2 and "checkpoint dir not found" in err


def _run(*argv):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    return subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=600)


@pytest.mark.slow  # e2e replay leg through the CLI entry points
def test_live_shadow_replay_bit_exact(tmp_path):
    log, jdir, ck_dir, sid = _record_window(tmp_path, 6)
    caps = capture_records(load_events(log))
    bundle_path = str(tmp_path / "win.bundle.json")
    r = _run("trpo_torch.scripts.analyze_run", log, "--export-bundle",
             "--window", str(caps[3]["t"] - 1e-4), str(time.time()),
             "--journal-dir", jdir, "--out", bundle_path)
    assert r.returncode == 0, r.stderr
    r = _run("trpo_torch.scripts.replay_run", bundle_path,
             "--checkpoint-dir", ck_dir, *_MODEL_FLAGS)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "REPLAY BIT-EXACT" in r.stdout and "0 mismatch(es)" in r.stdout
    replay_log = bundle_path + ".replay_events.jsonl"
    r = _run("trpo_torch.scripts.validate_events", replay_log)
    assert r.returncode == 0, r.stderr


@pytest.mark.slow  # a shadow set serving the WRONG weights must fail the
# diff loudly (exit 1 + named mismatches): the oracle's teeth
def test_live_shadow_replay_detects_divergence(tmp_path):
    log, jdir, ck_dir, sid = _record_window(tmp_path, 1, steps=(1, 2))
    bundle = port_replay.build_bundle(load_events(log),
                                      window=(0.0, time.time()),
                                      journal_dir=jdir)
    bundle["checkpoint_step"] = 2  # point the shadow at other weights
    bundle_path = str(tmp_path / "b.json")
    port_replay.write_bundle(bundle, bundle_path)
    r = _run("trpo_torch.scripts.replay_run", bundle_path,
             "--checkpoint-dir", ck_dir, *_MODEL_FLAGS)
    assert r.returncode == 1, (r.returncode, r.stdout, r.stderr)
    assert "MISMATCH" in r.stdout and "REPLAY DIVERGED" in r.stdout
