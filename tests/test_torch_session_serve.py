"""The port's recurrent serving plane (``trpo_torch/serve/session.py``,
``SessionBatcher``, the session routes of ``PolicyServer``) against
``trpo_tpu``'s, plus the reference's single-replica tests of
``tests/test_session_batch.py`` carried over to the port.

Tolerances: carries and Gaussian actions within 1e-5 of the reference;
categorical actions identical. The reference promises that a session
stepped inside any batched epoch is bit-exact with stepping it alone;
torch's CPU matmul rounds the cell's products per batch width (measured
on this CPU between epochs and batch-1 stepping, an 8-wide GRU over 6
steps across a hot reload: carries 8.9e-8, Gaussian actions 9.3e-10
apart), so those checks hold within ``ROW_ATOL`` (1e-6, five times the
largest drift measured anywhere, 1.8e-7 for a 64-wide GRU's carry on the
H100), and bit for bit where the rung is the same (padding rows and
companions change nothing). ROADMAP.md Queue 3 has the finding.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import TimeoutError as FutTimeout

import jax
import numpy as np
import pytest
import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import TRPOConfig
from trpo_torch.convert import policy_params_from_numpy
from trpo_torch.serve import (
    CarryJournal,
    MicroBatcher,
    PolicyServer,
    SessionBatcher,
    SessionStore,
    SimulatedCostSessionEngine,
    fence_session,
    journal_path,
    read_carry_journal,
    read_fences,
)
from trpo_tpu.agent import TRPOAgent as TpuAgent
from trpo_tpu.config import TRPOConfig as TpuConfig
from trpo_tpu.serve import session as tpu_session

ATOL = 1e-5
ROW_ATOL = 1e-6

_CFG = dict(
    n_envs=4, batch_timesteps=32, cg_iters=2, vf_train_steps=2,
    policy_hidden=(8,), vf_hidden=(8,), seed=11, policy_gru=8,
    serve_session_batch_shapes=(1, 4),
)


@pytest.fixture(scope="module")
def rec():
    agent = TRPOAgent("pendulum", TRPOConfig(**_CFG), device="cpu")
    return agent, agent.init_state(seed=0)


def _post(url, payload=None, timeout=30.0):
    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sequential(engine, obs_per_session):
    """Each session stepped alone at batch 1 through the same engine."""
    out = []
    for obs_seq in obs_per_session:
        carry = engine.initial_carry()
        acts = []
        for o in obs_seq:
            a, carry = engine.step(carry, o)
            acts.append(np.asarray(a))
        out.append((acts, carry))
    return out


# ---------------------------------------------------------------------------
# parity against trpo_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env, cell", [("pendulum", "gru"),
                                       ("pendulum", "lstm"),
                                       ("cartpole-po", "gru"),
                                       ("cartpole-po", "lstm")])
def test_step_batch_matches_reference_at_mixed_widths(env, cell):
    kw = {**_CFG, "env": env, "policy_cell": cell,
          "serve_session_batch_shapes": (1, 2, 4)}
    ref = TpuAgent(env, TpuConfig(**kw))
    port = TRPOAgent(env, TRPOConfig(**kw), device="cpu")
    ref_state = ref.init_state(seed=0)
    ref_engine = ref.serve_session_engine()
    ref_engine.load(ref_state.policy_params, None, step=2)
    engine = port.serve_session_engine()
    engine.load(policy_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, ref_state.policy_params)), None, step=2)
    assert engine.state_size == ref_engine.state_size
    S, T = 8, 10
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(T, S) + port.obs_shape).astype(np.float32)
    carries = np.zeros((S, engine.state_size), np.float32)
    ref_carries = carries.copy()
    splits = ([8], [3, 5], [1, 7], [4, 4], [2, 2, 4], [5, 3], [8],
              [1, 1, 6], [6, 2], [7, 1])
    for t, widths in enumerate(splits):
        i = 0
        for w in widths:  # width 5+ chunks at the top rung (4)
            sl = slice(i, i + w)
            want_a, want_c, want_step = ref_engine.step_batch(
                ref_carries[sl], obs[t, sl], return_step=True)
            got_a, got_c, step = engine.step_batch(
                carries[sl], obs[t, sl], return_step=True)
            assert step == want_step == 2
            want_a = np.asarray(want_a)
            assert got_a.dtype == want_a.dtype
            if np.issubdtype(want_a.dtype, np.integer):
                np.testing.assert_array_equal(got_a, want_a)
            else:
                np.testing.assert_allclose(got_a, want_a, atol=ATOL,
                                           rtol=ATOL)
            np.testing.assert_allclose(got_c, np.asarray(want_c),
                                       atol=ATOL, rtol=ATOL)
            ref_carries[sl] = np.asarray(want_c)
            carries[sl] = got_c
            i += w
    assert dict(engine.shape_counts) == dict(ref_engine.shape_counts)


def test_carry_journals_cross_read_between_packages(tmp_path):
    state = 16
    rng = np.random.default_rng(4)
    carries = {f"s{i}": rng.normal(size=state).astype(np.float32)
               for i in range(3)}
    port_path = journal_path(str(tmp_path), "r0", host="hostA")
    assert port_path == tpu_session.journal_path(str(tmp_path), "r0",
                                                 host="hostA")
    journal = CarryJournal(port_path)
    for i, (sid, c) in enumerate(carries.items()):
        carry = torch.as_tensor(c) if i == 0 else c  # tensor or array
        journal.record({"session": sid, "steps": i + 1, "carry": carry,
                        "seq": i, "last_action": np.float32([0.5]),
                        "last_step": 3, "t": 1.0})
    journal.forget("s2")
    assert journal.drain(10.0)
    journal.close()
    ref_entries = tpu_session.read_carry_journal(port_path)
    assert set(ref_entries) == {"s0", "s1"}
    for sid in ref_entries:
        np.testing.assert_array_equal(
            np.asarray(ref_entries[sid]["carry"], np.float32), carries[sid])
        assert ref_entries[sid]["steps"] == int(sid[1]) + 1
    # the reverse: the reference writes, the port reads
    ref_path = str(tmp_path / "ref.carry.jsonl")
    ref_journal = tpu_session.CarryJournal(ref_path)
    for sid, c in carries.items():
        ref_journal.record({"session": sid, "steps": 5, "carry": c})
    assert ref_journal.drain(10.0)
    ref_journal.close()
    with open(ref_path, "a") as f:
        f.write('{"session": "torn", "carry": [0.1, ')  # a kill -9 tail
    entries = read_carry_journal(ref_path)
    assert set(entries) == set(carries)
    for sid, c in carries.items():
        np.testing.assert_array_equal(
            np.asarray(entries[sid]["carry"], np.float32), c)
    # fences cross too
    fence_session(ref_path, "s1")
    tpu_session.fence_session(ref_path, "s0")
    assert read_fences(ref_path) == tpu_session.read_fences(ref_path) == \
        {"s0", "s1"}


# ---------------------------------------------------------------------------
# the reference's engine tests (tests/test_session_batch.py), on the port
# ---------------------------------------------------------------------------


def test_batched_epochs_match_sequential_with_hot_reload(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    state2 = agent.init_state(seed=7)
    rng = np.random.RandomState(0)
    S, T, swap_at = 5, 6, 3
    obs = [[rng.randn(*agent.obs_shape).astype(np.float32)
            for _ in range(T)] for _ in range(S)]
    carries = np.stack([engine.initial_carry() for _ in range(S)])
    batched = [[] for _ in range(S)]
    for t in range(T):
        if t == swap_at:
            engine.load(state2.policy_params, state2.obs_norm, step=1)
        acts, carries, step = engine.step_batch(
            carries, np.stack([obs[i][t] for i in range(S)]),
            return_step=True)
        assert step == (0 if t < swap_at else 1)
        for i in range(S):
            batched[i].append(np.asarray(acts[i]))
    for i in range(S):
        engine.load(state.policy_params, state.obs_norm, step=0)
        carry = engine.initial_carry()
        for t in range(T):
            if t == swap_at:
                engine.load(state2.policy_params, state2.obs_norm, step=1)
            a, carry = engine.step(carry, obs[i][t])
            np.testing.assert_allclose(batched[i][t], np.asarray(a),
                                       rtol=0, atol=ROW_ATOL)
        np.testing.assert_allclose(carries[i], carry, rtol=0, atol=ROW_ATOL)
    assert engine.shape_counts[4] > 0 and engine.shape_counts[1] > 0


def test_padding_rows_and_companions_change_nothing(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    rng = np.random.RandomState(1)
    c = rng.randn(4, engine.state_size).astype(np.float32)
    o = rng.randn(4, *agent.obs_shape).astype(np.float32)
    a_pad, c_pad = engine.step_batch(c[:2], o[:2])  # rung 4, 2 padded
    a_full, c_full = engine.step_batch(c, o)
    np.testing.assert_array_equal(a_pad, a_full[:2])
    np.testing.assert_array_equal(c_pad, c_full[:2])


def test_step_batch_rejects_bad_shapes(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    good_c = np.zeros((2, engine.state_size), np.float32)
    good_o = np.zeros((2,) + engine.obs_shape, np.float32)
    with pytest.raises(ValueError, match="carries must be"):
        engine.step_batch(np.zeros((2, 99), np.float32), good_o)
    with pytest.raises(ValueError, match="obs must be"):
        engine.step_batch(good_c, np.zeros((2, 99), np.float32))
    with pytest.raises(ValueError, match="disagree"):
        engine.step_batch(good_c, np.zeros((3,) + engine.obs_shape,
                                           np.float32))
    with pytest.raises(ValueError, match="at least one session"):
        engine.step_batch(np.zeros((0, engine.state_size), np.float32),
                          np.zeros((0,) + engine.obs_shape, np.float32))
    with pytest.raises(ValueError, match="carry must have shape"):
        engine.step(np.zeros(3, np.float32), good_o[0])
    with pytest.raises(ValueError, match="batch_shapes"):
        agent.serve_session_engine(batch_shapes=(0, 4))


def test_no_capture_across_epoch_widths_and_hot_swap(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    captures = engine.captures_total
    rng = np.random.RandomState(3)
    for n in (1, 2, 3, 4, 5, 9):
        engine.step_batch(
            rng.randn(n, engine.state_size).astype(np.float32),
            rng.randn(n, *agent.obs_shape).astype(np.float32))
    assert engine.captures_total == captures
    engine.load(agent.init_state(seed=2).policy_params, None, step=1)
    assert engine.loaded_step == 1 and engine.steps_total == 24


# ---------------------------------------------------------------------------
# SessionBatcher (no HTTP)
# ---------------------------------------------------------------------------


def test_session_batcher_gathers_and_scatters(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    # a deadline far past the test: only the full rung dispatches
    batcher = SessionBatcher(engine, deadline_ms=60_000.0)
    try:
        rng = np.random.RandomState(5)
        obs = [rng.randn(*agent.obs_shape).astype(np.float32)
               for _ in range(4)]
        futures = [batcher.submit(f"s{i}", engine.initial_carry(), obs[i])
                   for i in range(4)]
        results = [f.result(timeout=30.0) for f in futures]
        # one full epoch at rung 4: the same program as a rung-4 call
        want_a, want_c = engine.step_batch(
            np.stack([engine.initial_carry()] * 4), np.stack(obs))
        for i, (action, carry, step) in enumerate(results):
            assert step == 0
            np.testing.assert_array_equal(action, want_a[i])
            np.testing.assert_array_equal(carry, want_c[i])
        assert batcher.epochs_total == 1 and batcher.epoch_width_last == 4
        assert batcher.requests_total == 4
        assert batcher.epoch_width_mean == 4.0
    finally:
        batcher.close()


def test_session_batcher_same_sid_never_shares_an_epoch(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    batcher = SessionBatcher(engine, deadline_ms=500.0)
    try:
        rng = np.random.RandomState(6)
        o1, o2 = (rng.randn(*agent.obs_shape).astype(np.float32)
                  for _ in range(2))
        c0 = engine.initial_carry()
        f1 = batcher.submit("dup", c0, o1)
        f2 = batcher.submit("dup", c0, o2)
        fillers = [batcher.submit(f"f{i}", engine.initial_carry(), o1)
                   for i in range(3)]
        a1, _, _ = f1.result(timeout=30.0)
        a2, _, _ = f2.result(timeout=30.0)
        for f in fillers:
            f.result(timeout=30.0)
        ref1, ref2 = _sequential(engine, [[o1], [o2]])
        np.testing.assert_allclose(a1, ref1[0][0], rtol=0, atol=ROW_ATOL)
        np.testing.assert_allclose(a2, ref2[0][0], rtol=0, atol=ROW_ATOL)
        assert batcher.holdbacks_total >= 1 and batcher.epochs_total >= 2
    finally:
        batcher.close()


def test_session_batcher_error_fails_only_that_epoch(rec):
    agent, state = rec
    engine = agent.serve_session_engine()  # nothing loaded: step raises
    batcher = SessionBatcher(engine, deadline_ms=5.0)
    try:
        f = batcher.submit("s0", np.zeros(engine.state_size, np.float32),
                           np.zeros((3,), np.float32))
        with pytest.raises(RuntimeError, match="no params snapshot"):
            f.result(timeout=30.0)
        assert batcher.errors_total == 1
        engine.load(state.policy_params, state.obs_norm, step=0)
        _, carry, step = batcher.submit(
            "s0", engine.initial_carry(),
            np.zeros((3,), np.float32)).result(timeout=30.0)
        assert step == 0 and carry.shape == (engine.state_size,)
    finally:
        batcher.close()


def test_submit_queue_wait_times_out_on_wedged_engine(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    entered, release = threading.Event(), threading.Event()

    class _Wedged:
        def __getattr__(self, name):
            return getattr(engine, name)

        def step_batch(self, carries, obs, return_step=False):
            entered.set()
            release.wait(30.0)
            return engine.step_batch(carries, obs, return_step=return_step)

    batcher = SessionBatcher(_Wedged(), deadline_ms=1.0, max_queue=2)
    try:
        o, c = np.zeros((3,), np.float32), engine.initial_carry()
        f0 = batcher.submit("s0", c, o)
        assert entered.wait(10.0)
        fills = [batcher.submit(f"s{i + 1}", c, o) for i in range(2)]
        with pytest.raises(FutTimeout, match="queue full"):
            batcher.submit("late", c, o, timeout=0.3)
        release.set()
        for f in [f0] + fills:
            f.result(timeout=30.0)
    finally:
        release.set()
        batcher.close()


def test_latency_window_is_bounded_not_request_proportional(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    batcher = SessionBatcher(engine, deadline_ms=1.0, latency_window=8)
    try:
        o = np.zeros((3,), np.float32)
        for i in range(30):
            batcher.submit(f"s{i % 3}", engine.initial_carry(), o).result(
                timeout=30.0)
        assert batcher.requests_total == 30
        assert batcher.latency_samples <= 8
        assert batcher.latency_quantiles_ms((0.5,))
    finally:
        batcher.close()
    ff = TRPOAgent("pendulum", TRPOConfig(**{
        k: v for k, v in _CFG.items() if k != "policy_gru"}), device="cpu")
    ff_engine = ff.serve_engine(batch_shapes=(1, 2))
    ff_engine.load(ff.init_state(seed=0).policy_params, None, step=0)
    mb = MicroBatcher(ff_engine, deadline_ms=1.0, latency_window=8)
    try:
        for _ in range(20):
            mb.submit(np.zeros(ff.obs_shape, np.float32)).result(
                timeout=30.0)
        assert mb.requests_total == 20 and mb.latency_samples <= 8
    finally:
        mb.close()


def test_simulated_cost_engine_serializes_dispatches(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    slow = SimulatedCostSessionEngine(engine, cost_ms=1.0)
    a, c = slow.step(engine.initial_carry(), np.zeros(3, np.float32))
    assert c.shape == (engine.state_size,) and slow.state_size == 8
    with pytest.raises(ValueError, match="cost_ms"):
        SimulatedCostSessionEngine(engine, cost_ms=-1)


# ---------------------------------------------------------------------------
# the store and the journal
# ---------------------------------------------------------------------------


def test_store_ttl_lru_and_refuses_a_bus(tmp_path):
    # the bus is ported: a store's lifecycle records are schema-valid
    from trpo_torch.obs.events import EventBus, validate_event

    recs = []
    bus_store = SessionStore(max_sessions=1, sweep_interval=60.0,
                             bus=EventBus(recs.append), replica="r0")
    bus_store.create(np.zeros(2, np.float32), session_id="a")
    bus_store.create(np.zeros(2, np.float32), session_id="b")
    bus_store.close()
    assert [(r["session"], r["event"]) for r in recs] == [
        ("a", "created"), ("a", "evicted"), ("b", "created")]
    assert not any(validate_event(r) for r in recs)
    CarryJournal(str(tmp_path / "j.jsonl"), bus=EventBus()).close()
    store = SessionStore(ttl_s=60.0, max_sessions=2, sweep_interval=60.0)
    try:
        a = store.create(np.zeros(4, np.float32))
        b = store.create(np.zeros(4, np.float32), session_id="b")
        assert b == "b" and len(store) == 2
        store.get(a)  # a is now the most recently used
        store.create(np.zeros(4, np.float32), session_id="c")
        assert store.get("b") is None and store.evicted_total == 1
        sess = store.get(a)
        sess.last_used -= 120.0  # idle past the TTL
        assert store.get(a) is None and store.expired_total == 1
    finally:
        store.close()


def test_journal_compacts_and_fences_refuse_until_reclaimed(tmp_path):
    path = str(tmp_path / "r0.carry.jsonl")
    journal = CarryJournal(path, compact_factor=2, min_compact=4)
    store = SessionStore(journal=journal, sweep_interval=60.0)
    try:
        sid = store.create(np.zeros(2, np.float32), session_id="s")
        sess = store.get(sid)
        for k in range(12):
            with sess.lock:
                sess.carry = np.full(2, k, np.float32)
                store.touch_steps(sess)
                store.journal_step(sid, sess)
            assert journal.drain(10.0)
        assert journal.compactions_total >= 1
        with open(path) as f:
            assert sum(1 for _ in f) <= 4
        assert read_carry_journal(path)["s"]["steps"] == 12
        fence_session(path, "s")
        with sess.lock:
            sess.carry = np.full(2, 99, np.float32)
            store.touch_steps(sess)
            store.journal_session(sid, sess)
        assert journal.drain(10.0)
        assert journal.fenced_writes_total == 1
        assert read_carry_journal(path)["s"]["steps"] == 12  # refused
        store.create(np.zeros(2, np.float32), session_id="s", steps=20)
        assert journal.drain(10.0)
        assert read_carry_journal(path)["s"]["steps"] == 20  # reclaimed
    finally:
        store.close()


# ---------------------------------------------------------------------------
# the session routes of PolicyServer
# ---------------------------------------------------------------------------


def test_server_session_protocol_and_refusals(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    server = PolicyServer(engine, None, port=0, session_deadline_ms=2.0)
    try:
        assert _post(server.url + "/session")[0] == 503  # nothing loaded
        engine.load(state.policy_params, state.obs_norm, step=4)
        status, body = _post(server.url + "/act", {"obs": [0, 0, 0]})
        assert status == 409 and body["code"] == "wrong_protocol"
        assert body["endpoint"] == "/session"
        status, body = _post(server.url + "/session/nope/act",
                             {"obs": [0, 0, 0]})
        assert status == 404 and body["code"] == "session_unknown"
        assert _post(server.url + "/session", [1, 2])[0] == 400
        carry = np.linspace(-1, 1, engine.state_size).tolist()
        status, body = _post(server.url + "/session", {
            "session_id": "mine", "carry": carry, "steps": 3, "seq": 2,
            "last_action": [0.25], "last_step": 4})
        assert status == 200 and body == {"session": "mine", "step": 4,
                                          "resumed_steps": 3}
        status, body = _post(server.url + "/session/mine/act",
                             {"obs": [0.1, 0.2, 0.3], "seq": 2})
        assert status == 200 and body["deduped"] is True
        assert body["action"] == [0.25]
        status, body = _post(server.url + "/session/mine/act",
                             {"obs": [0.1, 0.2, 0.3], "seq": 3})
        a, _ = engine.step(np.asarray(carry, np.float32),
                           np.array([0.1, 0.2, 0.3], np.float32))
        assert status == 200 and body["session_steps"] == 4
        np.testing.assert_array_equal(np.float32(body["action"]), a)
        assert _post(server.url + "/session/mine/act", {"obs": [1]})[0] == 400
    finally:
        server.close()
    ff = TRPOAgent("pendulum", TRPOConfig(**{
        k: v for k, v in _CFG.items() if k != "policy_gru"}), device="cpu")
    ff_engine = ff.serve_engine()
    ff_engine.load(ff.init_state(seed=0).policy_params, None, step=0)
    mb = MicroBatcher(ff_engine, deadline_ms=2.0)
    srv = PolicyServer(ff_engine, mb, port=0)
    try:
        status, body = _post(srv.url + "/session")
        assert status == 409 and body["endpoint"] == "/act"
    finally:
        srv.close()
        mb.close()
    with pytest.raises(ValueError, match="no micro-batcher"):
        PolicyServer(engine, mb, port=0)


def test_server_concurrent_sessions_match_act_and_gauges(rec):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    server = PolicyServer(engine, None, port=0, session_deadline_ms=2.0)
    try:
        S, T = 6, 5
        sids = [_post(server.url + "/session")[1]["session"]
                for _ in range(S)]
        results, errors = {}, []

        def client(k):
            r = np.random.RandomState(50 + k)
            mine = []
            try:
                for t in range(T):
                    o = r.randn(*agent.obs_shape).astype(np.float32)
                    status, out = _post(
                        f"{server.url}/session/{sids[k]}/act",
                        {"obs": o.tolist(), "seq": t})
                    assert status == 200, out
                    mine.append((o, out["action"]))
            except Exception as e:  # surfaced below, never swallowed
                errors.append(repr(e))
            results[k] = mine

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(S)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
            assert not th.is_alive()
        assert not errors, errors
        for k in range(S):
            carry = None
            for o, a in results[k]:
                a_d, _, carry = agent.act(state, o, eval_mode=True,
                                          policy_carry=carry)
                np.testing.assert_allclose(np.float32(a).ravel(),
                                           a_d.numpy().ravel(), rtol=0,
                                           atol=ROW_ATOL)
            np.testing.assert_allclose(
                server.sessions.get(sids[k]).carry, carry.numpy(), rtol=0,
                atol=ROW_ATOL)
        sb = server.session_batcher
        assert sb.requests_total == S * T and sb.epochs_total <= S * T
        epochs = sb.epochs_total
        status, out = _post(f"{server.url}/session/{sids[0]}/act",
                            {"obs": results[0][-1][0].tolist(),
                             "seq": T - 1})
        assert status == 200 and out.get("deduped") is True
        assert sb.epochs_total == epochs
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=10) as r:
            metrics = r.read().decode()
        for gauge in ("trpo_serve_session_queue_depth",
                      "trpo_serve_session_epochs_total",
                      "trpo_serve_session_epoch_width",
                      "trpo_serve_session_epoch_width_mean",
                      "trpo_serve_batch_shape_total",
                      "trpo_serve_session_latency_ms",
                      "trpo_serve_session_acts_deduped_total"):
            assert gauge in metrics, gauge
    finally:
        server.close()


def test_mid_epoch_kill_journals_pre_epoch_state(rec, tmp_path):
    agent, state = rec

    class _WedgeEngine:
        def __init__(self, inner):
            self._inner = inner
            self.wedge = threading.Event()
            self.entered = threading.Event()
            self.release = threading.Event()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def step_batch(self, carries, obs, return_step=False):
            if self.wedge.is_set():
                self.entered.set()
                assert self.release.wait(30.0)
            return self._inner.step_batch(carries, obs,
                                          return_step=return_step)

    inner = agent.serve_session_engine()
    inner.load(state.policy_params, state.obs_norm, step=0)
    engine = _WedgeEngine(inner)
    jdir = str(tmp_path / "carry")
    server = PolicyServer(engine, None, port=0, session_deadline_ms=2.0,
                          carry_journal_dir=jdir, replica_name="victim",
                          act_timeout_s=3.0)
    jpath = journal_path(jdir, "victim")
    th = None
    try:
        sid = _post(server.url + "/session")[1]["session"]
        rng = np.random.RandomState(9)
        obs = [rng.randn(*agent.obs_shape).astype(np.float32)
               for _ in range(5)]
        for t in range(3):
            assert _post(f"{server.url}/session/{sid}/act",
                         {"obs": obs[t].tolist(), "seq": t})[0] == 200
        assert server.sessions.journal.drain(10.0)
        engine.wedge.set()
        inflight = {}

        def fire():
            inflight["resp"] = _post(f"{server.url}/session/{sid}/act",
                                     {"obs": obs[3].tolist(), "seq": 3},
                                     timeout=30.0)

        th = threading.Thread(target=fire, daemon=True)
        th.start()
        assert engine.entered.wait(10.0)
        entry = read_carry_journal(jpath)[sid]
        assert entry["steps"] == 3  # only APPLIED steps are journaled
        carry, ref = None, []
        for o in obs:
            a, _, carry = agent.act(state, o, eval_mode=True,
                                    policy_carry=carry)
            ref.append(a.numpy())
        resumed = np.asarray(entry["carry"], np.float32)
        a3, c4 = inner.step(resumed, obs[3])
        np.testing.assert_allclose(a3, ref[3], rtol=0, atol=ROW_ATOL)
        a4, _ = inner.step(c4, obs[4])
        np.testing.assert_allclose(a4, ref[4], rtol=0, atol=ROW_ATOL)
        engine.release.set()
        th.join(timeout=30.0)
        assert not th.is_alive()
        assert inflight["resp"][0] in (200, 504)
    finally:
        engine.release.set()
        server.close()


def test_drain_sync_all_current_under_concurrent_batched_load(rec,
                                                               tmp_path):
    agent, state = rec
    engine = agent.serve_session_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    jdir = str(tmp_path / "carry")
    server = PolicyServer(engine, None, port=0, session_deadline_ms=2.0,
                          carry_journal_dir=jdir, replica_name="drainee",
                          carry_sync_every=10_000)
    try:
        S, T = 4, 6
        sids = [_post(server.url + "/session")[1]["session"]
                for _ in range(S)]
        counts, errors = [0] * S, []

        def client(k):
            r = np.random.RandomState(70 + k)
            while counts[k] < T:
                o = r.randn(*agent.obs_shape).astype(np.float32)
                status, out = _post(f"{server.url}/session/{sids[k]}/act",
                                    {"obs": o.tolist()})
                if status != 200:
                    errors.append(out)
                    return
                counts[k] += 1

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(S)]
        for th in threads:
            th.start()
        status, out = _post(server.url + "/drain", {})
        assert status == 200 and out["ok"] is True
        for th in threads:
            th.join(timeout=60.0)
            assert not th.is_alive()
        assert not errors, errors
        assert _post(server.url + "/drain", {}) == \
            (200, {"ok": True, "sessions": S})
        entries = read_carry_journal(journal_path(jdir, "drainee"))
        for k, sid in enumerate(sids):
            assert entries[sid]["steps"] == counts[k]
            np.testing.assert_array_equal(
                np.asarray(entries[sid]["carry"], np.float32),
                server.sessions.get(sid).carry)
        status, out = _post(server.url + "/drain", {"forget": sids[:1]})
        assert status == 200 and out["forgotten"] == 1
        assert _post(server.url + "/drain", {"forget": "x"})[0] == 400
    finally:
        server.close()
