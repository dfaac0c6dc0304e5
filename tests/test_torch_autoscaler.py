"""The port's autoscaler (``trpo_torch/serve/autoscaler.py``) and the
router's admission control against ``trpo_tpu``'s, and the contracts of
the reference's ``tests/test_autoscaler.py`` carried over to the port.

The decisions (``_classify``, the victim, the hysteresis) are fed the same
metric streams in both packages and must agree exactly. The reference
reads its decisions off the event bus (ROADMAP.md Queue 1 item 18); these
tests read ``scale_outs_total``, ``drains_completed_total``,
``drains_aborted_total``, ``last_action`` and ``last_reason``.

A session drained onto a survivor is held within ``ROW_ATOL`` (1e-6) of
the uninterrupted session, categorical actions identical: torch rounds a
GEMM row differently at another batch width (ROADMAP.md Queue 3), where
the reference claims bit-exactness.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_router import make_set, port_agent, post, rec_factory
from test_torch_replicaset import _direct, _ff_make
from trpo_torch.serve import Autoscaler, Router
from trpo_tpu.serve import Autoscaler as TpuAutoscaler

ROW_ATOL = 1e-6


class _FakeRec:
    def __init__(self, rid, sessions=0, canary=False, state="healthy"):
        self.id = rid
        self.state = state
        self.inflight = 0
        self.sessions = sessions
        self.canary = canary
        self.handle = None
        self.url = None


class _FakeSet:
    def __init__(self, n):
        self.lock = threading.Lock()
        self.replicas = {f"r{i}": _FakeRec(f"r{i}") for i in range(n)}
        self._next = n
        self.added, self.finished, self.aborted = [], [], []

    def active_size(self):
        with self.lock:
            return sum(1 for r in self.replicas.values()
                       if r.state != "failed")

    def add_replica(self):
        rid = f"r{self._next}"
        self._next += 1
        with self.lock:
            self.replicas[rid] = _FakeRec(rid, state="starting")
        self.added.append(rid)
        return rid

    def begin_drain(self, rid):
        with self.lock:
            rec = self.replicas.get(rid)
            if rec is None or rec.state != "healthy" or rec.canary:
                return False
            rec.state = "draining"
        return True

    def abort_drain(self, rid):
        with self.lock:
            rec = self.replicas.get(rid)
            if rec is not None and rec.state == "draining":
                rec.state = "healthy"
        self.aborted.append(rid)

    def finish_drain(self, rid):
        with self.lock:
            rec = self.replicas.pop(rid, None)
        self.finished.append(rid)
        return rec is not None

    def get(self, rid):
        return self.replicas.get(rid)


class _FakeRouter:
    max_inflight = 64
    journal_dir = "/tmp/nowhere"
    backpressure_total = 0
    retries_skipped_total = 0
    shed_deadline_total = 0
    shed_stateless_total = 0

    def __init__(self, pinned=(), migrate=None):
        self._pinned = dict(pinned)
        self._migrate = migrate
        self.forgotten = []

    def take_fresh_latencies(self):
        return []

    def sessions_pinned_to(self, rid):
        return list(self._pinned.get(rid, []))

    def migrate_session(self, sid, rid):
        if self._migrate is not None:
            return self._migrate(sid, rid)
        self._pinned.get(rid, []).remove(sid)
        return True

    def forget_drained_sessions(self, rid, sids):
        self.forgotten.append((rid, list(sids)))


def _metrics(p99=None, samples=0, inflight=0.0, pressure=0.0):
    return {"p99_ms": p99, "p99_samples": samples,
            "inflight_per_replica": inflight, "pressure_rate": pressure,
            "healthy": 2}


def _autoscaler(rs, router, feed, cls=Autoscaler, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("slo_p99_ms", 100.0)
    kw.setdefault("min_samples", 8)
    kw.setdefault("breach_ticks", 3)
    kw.setdefault("clear_ticks", 3)
    kw.setdefault("cooldown_s", 0.0)
    return cls(rs, router, metrics_fn=feed, **kw)


_CLASSIFY = [
    _metrics(), _metrics(p99=500.0, samples=64),
    _metrics(p99=500.0, samples=3), _metrics(p99=100.0, samples=8),
    _metrics(p99=100.5, samples=8), _metrics(p99=20.0, samples=64,
                                             inflight=10.0),
    _metrics(inflight=48.0), _metrics(inflight=48.5),
    _metrics(inflight=16.0), _metrics(inflight=15.9),
    _metrics(pressure=0.1), _metrics(p99=500.0, samples=3, inflight=30.0),
    {"p99_ms": None, "p99_samples": None}, {},
]


def test_classify_and_victim_match_reference():
    verdicts = [[_autoscaler(_FakeSet(2), _FakeRouter(), None,
                             cls=cls)._classify(m) for m in _CLASSIFY]
                for cls in (TpuAutoscaler, Autoscaler)]
    assert verdicts[1] == verdicts[0]
    assert set(verdicts[1]) == {"breach", "clear", "hold"}
    victims = []
    for cls in (TpuAutoscaler, Autoscaler):
        rs = _FakeSet(4)
        for rid, sessions, canary in (("r0", 2, False), ("r1", 0, True),
                                      ("r2", 1, False), ("r3", 1, False)):
            rs.replicas[rid].sessions = sessions
            rs.replicas[rid].canary = canary
        asc = _autoscaler(rs, _FakeRouter(), None, cls=cls)
        got = [asc._pick_victim()]
        rs.replicas["r2"].state = "reloading"
        got.append(asc._pick_victim())
        for rec in rs.replicas.values():
            rec.state = "evicted"
        got.append(asc._pick_victim())
        victims.append(got)
    assert victims[1] == victims[0] == ["r2", "r3", None]


@pytest.mark.parametrize("stream", ["oscillating", "breach", "starved",
                                    "clear", "mixed"])
def test_decisions_over_a_metric_stream_match_reference(stream):
    def feed_for(i):
        return {
            "oscillating": _metrics(p99=200.0 if i % 2 == 0 else 20.0,
                                    samples=64),
            "breach": _metrics(p99=500.0, samples=64),
            "starved": _metrics(p99=10_000.0, samples=3, inflight=30.0),
            "clear": _metrics(p99=10.0, samples=64, inflight=0.0),
            "mixed": [_metrics(p99=500.0, samples=64), _metrics(),
                      _metrics(inflight=40.0)][(i // 4) % 3],
        }[stream]

    trails = []
    for cls in (TpuAutoscaler, Autoscaler):
        rs, router = _FakeSet(3), _FakeRouter()
        rs.replicas["r0"].sessions = 2
        ticks = iter(range(10_000))
        asc = _autoscaler(rs, router, lambda: feed_for(next(ticks)),
                          cls=cls, min_replicas=2, max_replicas=5)
        trail = []
        for i in range(24):
            asc.tick()
            if i == 8:  # the scaled-out replicas land
                for rec in rs.replicas.values():
                    if rec.state == "starting":
                        rec.state = "healthy"
            trail.append((list(rs.added), list(rs.finished),
                          asc.scale_outs_total, asc.drains_completed_total))
        trails.append(trail)
    assert trails[1] == trails[0]


def test_sustained_breach_scales_out_within_bounds():
    rs, router = _FakeSet(2), _FakeRouter()
    asc = _autoscaler(rs, router, lambda: _metrics(p99=500.0, samples=64),
                      max_replicas=4)
    for _ in range(3):
        asc.tick()
    assert rs.added == ["r2"] and asc.last_action == "scale_out"
    assert asc.last_reason.startswith("breach: p99=500.0ms")
    for _ in range(10):  # warming: no further action
        asc.tick()
    assert rs.added == ["r2"]
    rs.replicas["r2"].state = "healthy"
    for _ in range(3):
        asc.tick()
    assert rs.added == ["r2", "r3"]
    rs.replicas["r3"].state = "healthy"
    for _ in range(10):  # at max_replicas
        asc.tick()
    assert rs.added == ["r2", "r3"] and asc.scale_outs_total == 2
    with pytest.raises(RuntimeError, match="max_replicas=4"):
        asc.scale_out()


def test_sustained_clear_drains_fewest_sessions_never_canary():
    rs, router = _FakeSet(3), _FakeRouter()
    rs.replicas["r0"].sessions = 2
    rs.replicas["r1"].canary = True
    rs.replicas["r2"].sessions = 1
    asc = _autoscaler(rs, router,
                      lambda: _metrics(p99=10.0, samples=64, inflight=0.0),
                      min_replicas=2)
    for _ in range(3):
        asc.tick()
    assert rs.finished == ["r2"] and asc.drains_completed_total == 1
    assert (asc.last_action, asc.last_replica) == ("drain_completed", "r2")
    for _ in range(10):  # at min_replicas
        asc.tick()
    assert rs.finished == ["r2"]


def test_drains_abort_back_to_rotation():
    rs = _FakeSet(2)
    router = _FakeRouter(pinned={"r0": ["s1"]})
    router.journal_dir = None
    asc = _autoscaler(rs, router, lambda: _metrics())
    assert asc.scale_in(victim="r0") is False
    assert rs.aborted == ["r0"] and rs.replicas["r0"].state == "healthy"
    assert asc.drains_aborted_total == 1
    assert "no carry journal" in asc.last_reason

    def slow_migrate(sid, rid):
        time.sleep(0.05)
        return True

    rs = _FakeSet(2)
    router = _FakeRouter(pinned={"r0": ["s1", "s2"]}, migrate=slow_migrate)
    asc = _autoscaler(rs, router, lambda: _metrics(), drain_timeout_s=0.04)
    assert asc.scale_in(victim="r0") is False
    assert rs.replicas["r0"].state == "healthy"
    assert asc.last_action == "drain_aborted" and "timeout" in asc.last_reason
    assert router.forgotten == [("r0", ["s1"])]


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(slo_p99_ms=0), dict(interval=0), dict(min_samples=0),
    dict(breach_ticks=0), dict(drain_timeout_s=0),
    dict(inflight_low_frac=0.8, inflight_high_frac=0.5)])
def test_bounds_validate_like_the_reference(kw):
    kw = {"min_replicas": 1, "max_replicas": 2, **kw}
    for cls in (TpuAutoscaler, Autoscaler):
        with pytest.raises(ValueError):
            cls(_FakeSet(1), _FakeRouter(), **kw)
    with pytest.raises(NotImplementedError, match="item 18"):
        Autoscaler(_FakeSet(1), _FakeRouter(), 1, 2, bus=object())


# ---------------------------------------------------------------------------
# real replicas
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ff():
    return port_agent()


def test_slo_breach_scales_out_and_capacity_joins_after_healthz(ff):
    rs = make_set(_ff_make(*ff), 1)
    router = Router(rs, port=0)
    asc = Autoscaler(rs, router, min_replicas=1, max_replicas=2,
                     slo_p99_ms=50.0, min_samples=8, breach_ticks=2,
                     cooldown_s=0.0)
    try:
        for _ in range(2):
            with router._lat_lock:  # a window of slow answers
                router._fresh_lats.extend([80.0] * 8)
            asc.tick()
        assert asc.scale_outs_total == 1 and asc.last_replica == "r1"
        assert rs.snapshot()["replicas"]["r1"]["state"] == "starting"
        picked = {router._pick() for _ in range(4)}
        for p in picked:
            router._release(p)
        assert picked == {"r0"}
        rs.tick()
        assert rs.snapshot()["replicas"]["r1"]["state"] == "healthy"
        with rs.lock:
            rs.replicas["r0"].inflight = 1
        assert router._pick() == "r1"
        router._release("r1")
        with rs.lock:
            rs.replicas["r0"].inflight = 0
        asc.tick()  # at max_replicas: a breach adds nothing
        assert asc.scale_outs_total == 1
    finally:
        asc.close()
        router.close()
        rs.close()


def test_drain_e2e_live_session_resumed(tmp_path):
    agent, state = port_agent("cartpole-po", policy_gru=8,
                              serve_session_batch_shapes=(1, 4))
    jdir = str(tmp_path / "journal")
    rs = make_set(lambda rid: rec_factory(
        agent, state.policy_params, replica_name=rid,
        carry_journal_dir=jdir, carry_sync_every=1), 2)
    router = Router(rs, port=0, journal_dir=jdir)
    asc = Autoscaler(rs, router, min_replicas=1, max_replicas=2)
    try:
        status, out = post(router.url + "/session")
        sid, pinned = out["session"], out["replica"]
        obs = np.random.default_rng(40).standard_normal(
            (6,) + agent.obs_shape).astype(np.float32)
        acts, carries = _direct(agent, state, obs)
        for t in range(3):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and out["action"] == acts[t]
        assert asc.scale_in(victim=pinned) is True
        snap = rs.snapshot()
        assert snap["size"] == 1 and pinned not in snap["replicas"]
        assert (router.sessions_drained_total,
                router.sessions_resumed_total) == (1, 0)
        assert asc.last_drain_moved == 1 and asc.last_drain_s > 0
        status, out = post(router.url + f"/session/{sid}/act",
                           {"obs": obs[3].tolist()})
        assert status == 200 and out["resumed"] is True
        assert out["resumed_steps"] == 3 and out["action"] == acts[3]
        for t in (4, 5):
            status, out = post(router.url + f"/session/{sid}/act",
                               {"obs": obs[t].tolist()})
            assert status == 200 and "resumed" not in out
            assert out["action"] == acts[t]
        survivor = next(iter(rs.replicas.values()))
        live = survivor.handle.server.sessions.get(sid).carry
        np.testing.assert_allclose(np.asarray(live), carries[5],
                                   atol=ROW_ATOL, rtol=0)
    finally:
        asc.close()
        router.close()
        rs.close()


def test_retry_budget_exhaustion_sheds_instead_of_amplifying(ff):
    rs = make_set(_ff_make(*ff), 2)
    router = Router(rs, port=0, retry_budget=0.0, retry_refill_per_sec=0.0)
    try:
        rs.replicas["r0"].handle.kill()
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 502, out
        assert (router.retries_skipped_total, router.retried_total) == (1, 0)
        assert post(router.url + "/act", {"obs": [0, 0, 0, 0]})[0] == 200
    finally:
        router.close()
        rs.close()


def test_deadline_admission_and_shed_order(ff):
    rs = make_set(_ff_make(*ff), 1)
    router = Router(rs, port=0, min_latency_samples=8, max_inflight=8)
    try:
        status, out = post(router.url + "/act",
                           {"obs": [0, 0, 0, 0], "deadline_ms": 0.001})
        assert status == 200, out  # below min samples: admitted
        now = time.monotonic()
        with router._lat_lock:
            router._adm_lats.extend([(now, 50.0)] * 8)
        status, out = post(router.url + "/act",
                           {"obs": [0, 0, 0, 0], "deadline_ms": 1})
        assert status == 503 and out["code"] == "deadline_unmeetable"
        with router._lat_lock:
            router._adm_lats.clear()
            router._adm_lats.extend(
                [(now - Router._ADMISSION_STALE_S - 1.0, 900.0)] * 8)
        assert post(router.url + "/act",
                    {"obs": [0, 0, 0, 0], "deadline_ms": 1})[0] == 200
        assert router.shed_deadline_total == 1
        # the shed order: stateless traffic stops one slot early
        with rs.lock:
            rs.replicas["r0"].inflight = 7
        router._last_pressure = time.monotonic()
        assert router._pick(stateless=True) is None
        assert router._pick(stateless=False) == "r0"
        router._release("r0")
        router._last_pressure = time.monotonic()
        status, out = post(router.url + "/act", {"obs": [0, 0, 0, 0]})
        assert status == 503 and out["code"] == "shed_stateless"
        assert router.shed_stateless_total == 1
        with rs.lock:
            rs.replicas["r0"].inflight = 0
        q, samples = router.latency_window()
        assert samples == router.routed_total and 0.5 in q
    finally:
        router.close()
        rs.close()
