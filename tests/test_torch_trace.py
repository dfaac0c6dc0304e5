"""The port's request tracing (``trpo_torch/obs/trace.py``) against the
reference's (``trpo_tpu/obs/trace.py``, ``tests/test_trace.py``): ids,
head sampling (the same verdict as the reference's for the same id and
rate, so a mixed fleet samples the same requests), the write-behind
writer's whole-context drops, header propagation, the batchers' shared
epoch span and forced engine failures, and the routed serving stack: every
stage emits its span, every record passes the reference's
``validate_event`` and its whole-file contracts
(``scripts/validate_events.py``), and a failover is traced at rate 0.
"""

import importlib.util
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

from trpo_torch.obs.events import EventBus, validate_event
from trpo_torch.obs.trace import (
    PARENT_HEADER,
    SAMPLED_HEADER,
    TRACE_HEADER,
    Tracer,
    head_sampled,
    mint_span_id,
    mint_trace_id,
    valid_trace_id,
)
from trpo_torch.serve import (
    InProcessReplica,
    MicroBatcher,
    PolicyServer,
    ReplicaSet,
    Router,
)
from trpo_torch.serve.batcher import SessionBatcher
from trpo_tpu.obs import events as ref_events
from trpo_tpu.obs import trace as ref_trace

from test_torch_router import port_agent, post

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_validate_file(path):
    spec = importlib.util.spec_from_file_location(
        "validate_events", os.path.join(REPO, "scripts", "validate_events.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.validate_file(path)


def test_mint_ids_well_formed():
    tid, sid = mint_trace_id(), mint_span_id()
    assert len(tid) == 32 and int(tid, 16) >= 0
    assert len(sid) == 16 and int(sid, 16) >= 0
    assert mint_trace_id() != tid
    assert valid_trace_id(tid) and valid_trace_id("deadbeef")
    for bad in ("xyz", "abc", "a" * 65, None, "0xDEADBEEF", "dead_beef",
                "+deadbeef", " deadbeef"):
        assert not valid_trace_id(bad), bad


def test_head_sampling_agrees_with_the_reference():
    rng = np.random.default_rng(0)
    ids = [rng.bytes(16).hex() for _ in range(10_000)]
    rates = (0.0, 0.01, 0.25, 0.5, 1.0)
    for rate in rates:
        port = [head_sampled(t, rate) for t in ids]
        assert port == [ref_trace.head_sampled(t, rate) for t in ids], rate
        if 0 < rate < 1:
            assert abs(sum(port) / len(ids) - rate) < 0.02
    # monotone in the rate, and a pure function of the id
    for t in ids[:500]:
        verdicts = [head_sampled(t, r) for r in rates]
        assert verdicts == sorted(verdicts)
        assert head_sampled(t, 0.25) == head_sampled(t, 0.25)


def test_tracer_emits_valid_spans_and_drops_unsampled_unforced():
    recs = []
    bus = EventBus(recs.append)
    tracer = Tracer(bus, 0.0, process="p0", host="h0")
    dropped = tracer.begin()
    dropped.span("router.act").end()
    assert tracer.finish(dropped) is False
    forced = tracer.begin()
    root = forced.span("router.act")
    forced.span("router.dispatch", parent=root, replica="r0").end(
        status=200)
    root.end(status=200)
    forced.force()
    assert tracer.finish(forced) is True
    tracer.close()
    spans = [r for r in recs if r["kind"] == "span"]
    assert [s["name"] for s in spans] == ["router.dispatch", "router.act"]
    assert spans[0]["parent"] == spans[1]["span"]
    assert all(s["process"] == "p0" and s["host"] == "h0" for s in spans)
    for s in spans:
        assert not validate_event(s) and not ref_events.validate_event(s)
    assert (tracer.sampled_total, tracer.spans_total,
            tracer.dropped_total) == (1, 2, 0)
    with pytest.raises(ValueError, match="sample_rate"):
        Tracer(bus, 1.5)


def test_writer_backpressure_drops_whole_contexts_counted():
    gate = threading.Event()
    emitted = []

    def blocking_sink(rec):
        gate.wait(10.0)
        emitted.append(rec)

    bus = EventBus(blocking_sink)
    tracer = Tracer(bus, 1.0, max_pending=3, poll_interval=0.01)
    first = tracer.begin()
    first.span("x").end()
    tracer.finish(first)
    time.sleep(0.1)  # the writer is now blocked inside the sink
    big = tracer.begin()
    for i in range(6):
        big.span(f"s{i}").end()
    assert tracer.finish(big) is False  # the WHOLE context drops
    assert tracer.dropped_total == 6
    forced = tracer.begin()
    for i in range(5):
        forced.span(f"f{i}").end()
    forced.force()
    assert tracer.finish(forced) is True  # an anomaly overshoots the bound
    assert tracer.dropped_total == 6
    gate.set()
    tracer.drain()
    tracer.close()
    assert len(emitted) == 6
    assert not any(r["trace"] == big.trace_id for r in emitted)


def test_headers_propagate_verdict_and_parent():
    tracer = Tracer(EventBus(), 0.0)
    ctx = tracer.begin()
    root = ctx.span("router.act")
    headers = Tracer.headers_for(ctx, root)
    assert headers == {TRACE_HEADER: ctx.trace_id,
                       PARENT_HEADER: root.span_id}
    ctx.force()
    assert Tracer.headers_for(ctx, root)[SAMPLED_HEADER] == "1"
    joined = tracer.join({TRACE_HEADER: ctx.trace_id, SAMPLED_HEADER: "1",
                          PARENT_HEADER: root.span_id})
    assert joined.trace_id == ctx.trace_id and joined.sampled
    assert tracer.parent_from({PARENT_HEADER: "abc"}) == "abc"
    assert tracer.join(None) is not None  # no headers: this is the edge
    unsampled = tracer.join({TRACE_HEADER: mint_trace_id()})
    assert not unsampled.sampled
    # a malformed client id is re-minted, never logged as a key
    assert tracer.begin("not hex!").trace_id != "not hex!"
    tracer.close()


class _FakeSessionEngine:
    state_size = 4
    obs_shape = (3,)
    obs_dtype = np.dtype(np.float32)
    max_batch = 8

    def __init__(self, fail=False):
        self.fail = fail

    def padded_shape(self, n):
        return self.max_batch

    def step_batch(self, carries, obs, return_step=False):
        if self.fail:
            raise RuntimeError("boom")
        n = obs.shape[0]
        out = (np.zeros((n, 1)), np.asarray(carries) + 1.0)
        return out + (7,) if return_step else out


@pytest.mark.parametrize("fail", [False, True])
def test_shared_epoch_span_and_engine_failure_forces(fail):
    """Coalesced sessions share ONE ``engine.step_batch`` span id; an
    engine failure forces every participant's trace at rate 0."""
    recs = []
    bus = EventBus(recs.append)
    tracer = Tracer(bus, 0.0 if fail else 1.0)
    batcher = SessionBatcher(_FakeSessionEngine(fail), deadline_ms=200.0,
                             bus=bus)
    n = 5
    ctxs = [tracer.begin() for _ in range(n)]
    parents = [c.span("replica.session_act") for c in ctxs]
    futures = [batcher.submit(f"s{i}", np.zeros(4, np.float32),
                              np.zeros(3, np.float32),
                              trace=(ctxs[i], parents[i].span_id))
               for i in range(n)]
    for f in futures:
        if fail:
            with pytest.raises(RuntimeError):
                f.result(timeout=10)
        else:
            f.result(timeout=10)
    batcher.close()
    for c, p in zip(ctxs, parents):
        p.end()
        assert tracer.finish(c)
    tracer.close()
    spans = [r for r in recs if r["kind"] == "span"]
    assert all(not ref_events.validate_event(r) for r in recs)
    if fail:
        assert {s["name"] for s in spans} == {"replica.session_act"}
        assert len(spans) == n
        return
    epochs = [s for s in spans if s["name"] == "engine.step_batch"]
    waits = [s for s in spans if s["name"] == "batch.queue_wait"]
    assert len(epochs) == n and len(waits) == n
    assert len({s["span"] for s in epochs}) == 1
    assert all(s["width"] == n and s["rung"] == 8 for s in epochs)
    by_trace = {s["trace"]: s for s in epochs}
    assert all(by_trace[w["trace"]]["parent"] == w["span"] for w in waits)
    assert [r["requests"] for r in recs if r["kind"] == "serve"] == [n]


# ---------------------------------------------------------------------------
# the routed stack
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rec():
    return port_agent("cartpole-po", policy_gru=8,
                      serve_session_batch_shapes=(1, 4))


def _routed(agent, state, tmp_path, bus, tracer, n=2):
    jdir = str(tmp_path / "cj")

    def factory(rid):
        def build():
            engine = agent.serve_session_engine()
            engine.load(state.policy_params, None, step=1)
            return PolicyServer(engine, None, port=0, bus=bus, tracer=tracer,
                                replica_name=rid, carry_journal_dir=jdir), []
        return build

    rs = ReplicaSet(lambda rid: InProcessReplica(factory(rid)), n, bus=bus,
                    health_interval=60.0, backoff=0.05,
                    health_fail_threshold=1, max_restarts=2)
    assert rs.wait_healthy(n, timeout=60.0), rs.snapshot()
    return rs, Router(rs, port=0, bus=bus, journal_dir=jdir, tracer=tracer)


def test_every_serving_stage_emits_its_span(rec, tmp_path):
    """One traced session act through the routed stack shows every stage,
    parentage across the hop intact, and the whole log passes the
    reference's validator, whole-file contracts included."""
    agent, state = rec
    path = str(tmp_path / "ev.jsonl")
    from trpo_torch.obs.events import JsonlSink, manifest_fields

    bus = EventBus(JsonlSink(path))
    bus.emit("run_manifest", **manifest_fields(None, device="cpu"))
    tracer = Tracer(bus, 1.0, process="test")
    rs, router = _routed(agent, state, tmp_path, bus, tracer)
    tid = mint_trace_id()
    try:
        status, out = post(router.url + "/session")
        assert status == 200, out
        obs = np.zeros(agent.obs_shape, np.float32).tolist()
        status, out = post(f"{router.url}/session/{out['session']}/act",
                           {"obs": obs}, headers={TRACE_HEADER: tid})
        assert status == 200, out
    finally:
        router.close()
        rs.close()
        tracer.close()
        bus.close()
    recs = [json.loads(line) for line in open(path)]
    spans = [r for r in recs if r["kind"] == "span" and r["trace"] == tid]
    by_name = {s["name"]: s for s in spans}
    assert set(by_name) == {
        "router.session_act", "router.dispatch", "replica.session_act",
        "batch.queue_wait", "engine.step_batch", "journal.sync"}
    assert by_name["replica.session_act"]["remote"] is True
    assert by_name["replica.session_act"]["parent"] == (
        by_name["router.dispatch"]["span"])
    req = [r for r in recs if r["kind"] == "router"
           and r.get("scope") == "request"
           and r.get("endpoint") == "session_act"]
    assert req[-1]["trace"] == tid
    kinds = {r["kind"] for r in recs}
    assert {"router", "session", "serve", "span"} <= kinds
    assert _reference_validate_file(path) == []


def test_failover_is_always_traced_at_rate_zero(rec, tmp_path):
    agent, state = rec
    recs = []
    bus = EventBus(recs.append)
    tracer = Tracer(bus, 0.0, process="test")  # head sample: never
    rs, router = _routed(agent, state, tmp_path, bus, tracer)
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        obs = np.zeros(agent.obs_shape, np.float32).tolist()
        assert post(f"{router.url}/session/{sid}/act", {"obs": obs})[0] \
            == 200
        rs.get(pinned).handle.server.sessions.sync_all()
        rs.replicas[pinned].handle.kill()
        status, out = post(f"{router.url}/session/{sid}/act", {"obs": obs})
        assert status == 200 and out.get("resumed") is True, out
        tracer.drain()
    finally:
        router.close()
        rs.close()
        tracer.close()
    spans = [r for r in recs if r["kind"] == "span"]
    names = {s["name"] for s in spans}
    assert {"router.takeover", "router.fence"} <= names, names
    takeover = [s for s in spans if s["name"] == "router.takeover"][-1]
    assert takeover["from_replica"] == pinned and takeover["landed"]
    assert takeover["resumed"] is True and takeover["journal_backed"]
    # only the failover act was traced
    assert len({s["trace"] for s in spans}) == 1
    assert any(r["kind"] == "session" and r["event"] == "resumed"
               for r in recs)
    assert all(not ref_events.validate_event(r) for r in recs)


def test_stateless_act_spans_through_the_async_router():
    """A stateless act at rate 1.0: router root, dispatch (with its
    transport), the replica's handler, queue wait and ``engine.infer``;
    /metrics counts the spans."""
    agent, state = port_agent()
    recs = []
    bus = EventBus(recs.append)
    tracer = Tracer(bus, 1.0, process="test")

    def factory(rid):
        def build():
            engine = agent.serve_engine()
            engine.load(state.policy_params, None, step=1)
            batcher = MicroBatcher(engine, deadline_ms=5.0, bus=bus)
            return PolicyServer(engine, batcher, port=0, tracer=tracer,
                                replica_name=rid), [batcher]
        return build

    rs = ReplicaSet(lambda rid: InProcessReplica(factory(rid)), 1,
                    health_interval=60.0)
    assert rs.wait_healthy(1, timeout=60.0)
    router = Router(rs, port=0, bus=bus, tracer=tracer)
    try:
        status, _ = post(router.url + "/act", {
            "obs": np.zeros(agent.obs_shape).tolist()})
        assert status == 200
        tracer.drain()
        with urllib.request.urlopen(router.url + "/metrics") as r:
            assert b"trpo_trace_spans_total" in r.read()
    finally:
        router.close()
        rs.close()
        tracer.close()
    names = [s["name"] for s in recs if s["kind"] == "span"]
    assert sorted(names) == sorted([
        "router.act", "router.dispatch", "replica.act", "batch.queue_wait",
        "engine.infer"])
    hop = [s for s in recs if s.get("name") == "router.dispatch"][0]
    assert hop["transport"] in ("tcp", "uds") and hop["status"] == 200
    assert all(not ref_events.validate_event(r) for r in recs)
