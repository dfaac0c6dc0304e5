"""The port's request capture (``trpo_torch/obs/capture.py``) against the
reference's (``trpo_tpu/obs/capture.py``, ``tests/test_replay.py``): the
same bodies, responses and trace contexts go through both recorders, and
the records, drop counters and decoded observations must be equal
(wall-clock ``t`` excluded by name). The payload is the wire frame, byte
for byte the reference's, so each package decodes the other's bundles.
The serving classes' ``trpo_capture_*`` families are held to the
reference's names and values.
"""

import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import trpo_torch.obs.capture as port_capture
import trpo_torch.obs.events as port_events
import trpo_torch.obs.trace as port_trace
import trpo_tpu.obs.capture as ref_capture
import trpo_tpu.obs.events as ref_events
import trpo_tpu.obs.trace as ref_trace
from trpo_torch.serve import wire as port_wire
from trpo_tpu.serve import wire as ref_wire

PORT = SimpleNamespace(cap=port_capture, events=port_events,
                       trace=port_trace, wire=port_wire)
REF = SimpleNamespace(cap=ref_capture, events=ref_events, trace=ref_trace,
                      wire=ref_wire)


def _no_t(x):
    if isinstance(x, dict):
        return {k: _no_t(v) for k, v in x.items() if k != "t"}
    if isinstance(x, (list, tuple)):
        return [_no_t(v) for v in x]
    return x


def _both(scenario):
    want, got = scenario(REF), scenario(PORT)
    assert _no_t(got) == _no_t(want)
    return got


def _collect_bus(m):
    recs = []
    return recs, m.events.EventBus(lambda r: recs.append(r))


def _decoded(m, rec):
    out = m.cap.decode_payload(rec)
    if out is None:
        return None
    scalars, obs = out
    return scalars, str(obs.dtype), obs.tolist()


# -- capture round-trip ----------------------------------------------------


def test_capture_roundtrip_json_body_bit_exact():
    obs = (np.arange(5, dtype=np.float32) - 2.1) / 3.0

    def run(m):
        recs, bus = _collect_bus(m)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus, process="router")
        body = json.dumps({"obs": obs.tolist(), "seq": 7}).encode()
        resp = json.dumps(
            {"action": [0.1234567890123456, -1.5], "step": 42}).encode()
        ctx = tracer.begin("a" * 16, sampled=True)
        assert cap.record(ctx, path="/session/s1/act",
                          endpoint="session_act", body=body, status=200,
                          session="s1", replica="r0", response=resp,
                          response_ctype="application/json")
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        (rec,) = m.cap.capture_records(recs)
        assert not m.events.validate_event(rec)
        return rec, _decoded(m, rec)

    rec, (scalars, dtype, decoded) = _both(run)
    assert rec["seq"] == 7 and rec["step"] == 42
    assert rec["action"] == [0.1234567890123456, -1.5]
    assert scalars == {"seq": 7} and dtype == "float32"
    assert np.array_equal(np.asarray(decoded, np.float32), obs)


def test_capture_roundtrip_wire_body_bit_exact():
    obs = np.random.RandomState(3).randn(4).astype(np.float32)
    action = np.array([0.5, -0.25], np.float64)

    def run(m):
        recs, bus = _collect_bus(m)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus, process="router")
        body = m.wire.encode_frame(scalars={"seq": 9}, arrays={"obs": obs})
        resp = m.wire.encode_frame(scalars={"step": 6},
                                   arrays={"action": action})
        ctx = tracer.begin("b" * 16, sampled=True)
        assert cap.record(ctx, path="/session/s2/act",
                          endpoint="session_act", body=body, binary=True,
                          status=200, session="s2", response=resp,
                          response_ctype=m.wire.WIRE_CONTENT_TYPE)
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        (rec,) = m.cap.capture_records(recs)
        return rec, _decoded(m, rec)

    rec, (_, _, decoded) = _both(run)
    assert rec["seq"] == 9 and rec["step"] == 6
    assert rec["action"] == action.tolist()
    assert np.array_equal(np.asarray(decoded, np.float32), obs)


def test_capture_unparseable_body_still_emits_payloadless():
    def run(m):
        recs, bus = _collect_bus(m)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus)
        ctx = tracer.begin("c" * 16, sampled=True)
        assert cap.record(ctx, path="/act", endpoint="act",
                          body=b"\x00not json", status=200)
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        (rec,) = m.cap.capture_records(recs)
        return rec, _decoded(m, rec)

    rec, decoded = _both(run)
    assert "payload" not in rec and decoded is None


# -- sampling agreement ----------------------------------------------------


def test_capture_agrees_with_head_sampling_verdict():
    def run(m):
        recs, bus = _collect_bus(m)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus)
        body = json.dumps({"obs": [0.0]}).encode()
        sampled = tracer.begin("d" * 16, sampled=True)
        unsampled = tracer.begin("e" * 16, sampled=False)
        forced = tracer.begin("f" * 16, sampled=False)
        forced.force()
        accepted = [
            cap.record(sampled, path="/act", endpoint="act", body=body,
                       status=200),
            cap.record(unsampled, path="/act", endpoint="act", body=body,
                       status=200),
            cap.record(forced, path="/act", endpoint="act", body=body,
                       status=500),
            cap.record(None, path="/act", endpoint="act", body=body,
                       status=200),
        ]
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        return accepted, m.cap.capture_records(recs)

    accepted, recs = _both(run)
    assert accepted == [True, False, True, False]
    assert {r["trace"] for r in recs} == {"d" * 16, "f" * 16}
    assert [r for r in recs if r["trace"] == "f" * 16][0]["forced"] is True


# -- drop accounting -------------------------------------------------------


def test_capture_backpressure_drops_counted_forced_overshoots():
    def run(m):
        gate = threading.Event()
        emitted = []

        def blocking_sink(rec):
            gate.wait(10.0)
            emitted.append(rec)

        bus = m.events.EventBus(blocking_sink)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus, max_pending=2, poll_interval=0.01)
        body = json.dumps({"obs": [1.0]}).encode()

        def rec_one(tid, force=False):
            ctx = tracer.begin(tid, sampled=not force)
            if force:
                ctx.force()
            return cap.record(ctx, path="/act", endpoint="act", body=body,
                              status=200)

        marks = [rec_one("1" * 16)]
        deadline = time.monotonic() + 5.0
        while cap._pending and time.monotonic() < deadline:
            time.sleep(0.01)  # the writer took it and blocks in the sink
        marks += [rec_one("2" * 16), rec_one("3" * 16), rec_one("4" * 16),
                  cap.dropped_total, rec_one("5" * 16, force=True),
                  cap.dropped_total]
        gate.set()
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        got = sorted({r["trace"] for r in emitted
                      if r.get("kind") == "capture"})
        return marks, got, cap.requests_total

    marks, got, requests = _both(run)
    assert marks == [True, True, True, False, 1, True, 1]
    assert "4" * 16 not in got
    assert {"1" * 16, "2" * 16, "3" * 16, "5" * 16} <= set(got)
    assert requests == 4


def test_capture_writer_failure_counts_drops_and_survives():
    def run(m):
        state = {"fail": True}
        emitted = []

        def flaky_sink(rec):
            if state["fail"]:
                raise RuntimeError("sink down")
            emitted.append(rec)

        bus = m.events.EventBus(flaky_sink)
        tracer = m.trace.Tracer(bus, 1.0)
        cap = m.cap.RequestCapture(bus, poll_interval=0.01)
        body = json.dumps({"obs": [1.0]}).encode()
        cap.record(tracer.begin("a" * 16, sampled=True), path="/act",
                   endpoint="act", body=body, status=200)
        deadline = time.monotonic() + 5.0
        while cap.dropped_total == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        first = cap.dropped_total
        state["fail"] = False
        cap.record(tracer.begin("b" * 16, sampled=True), path="/act",
                   endpoint="act", body=body, status=200)
        cap.drain()
        cap.close()
        tracer.close()
        bus.close()
        return first, [r["trace"] for r in emitted], cap.dropped_total

    assert _both(run) == (1, ["b" * 16], 1)


# -- the payload frame is shared -------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8", "int64"])
def test_payload_frames_byte_identical_and_cross_decode(dtype):
    """The same obs and seq give the same base64 wire frame in both
    packages, and each package's ``decode_payload`` reads the other's."""
    rng = np.random.default_rng(5)
    obs = (rng.standard_normal((3, 4)) * 50).astype(dtype)
    for seq in (None, 0, 12345):
        port = port_capture.encode_obs_payload(obs, seq=seq)
        ref = ref_capture.encode_obs_payload(obs, seq=seq)
        assert port == ref
        for dec in (port_capture.decode_payload, ref_capture.decode_payload):
            scalars, got = dec({"payload": port})
            assert got.dtype == obs.dtype and np.array_equal(got, obs)
            assert scalars == ({} if seq is None else {"seq": seq})


# -- /metrics families -----------------------------------------------------


def _capture_lines(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith("trpo_capture_"))


def _reference_fams(cap):
    from trpo_tpu.serve.server import PolicyServer as RefServer

    rows = []
    RefServer._capture_fams(
        SimpleNamespace(capture=cap),
        lambda name, mtype, help_, samples: rows.append(
            f"{name} {samples[0][1]}"))
    return sorted(rows)


def test_server_capture_fams_emit_counters():
    """Both serving front ends name the reference's three capture
    counters with its values (and none when capture is off)."""
    from trpo_torch.serve import Router

    from test_torch_alerts import _ff_replicas
    from test_torch_router import port_agent

    agent, state = port_agent("cartpole")
    recs, bus = _collect_bus(PORT)
    cap = port_capture.RequestCapture(bus)
    cap.requests_total, cap.dropped_total, cap.bytes_total = 3, 1, 99
    ref_recs, ref_bus = _collect_bus(REF)
    ref_cap = ref_capture.RequestCapture(ref_bus)
    ref_cap.requests_total, ref_cap.dropped_total, ref_cap.bytes_total = (
        3, 1, 99)
    want = _reference_fams(ref_cap)
    rs = _ff_replicas(agent, state.policy_params)
    router = Router(rs, port=0)
    try:
        server = rs.replicas["r0"].handle.server
        for front in (server, router):
            get = lambda: urllib.request.urlopen(
                front.url + "/metrics", timeout=30).read().decode()
            assert _capture_lines(get()) == []
            front.capture = cap
            assert _capture_lines(get()) == want
            front.capture = None
    finally:
        router.close()
        rs.close()
        for c, b in ((cap, bus), (ref_cap, ref_bus)):
            c.close()
            b.close()
    assert want == ["trpo_capture_bytes_total 99",
                    "trpo_capture_dropped_total 1",
                    "trpo_capture_requests_total 3"]
