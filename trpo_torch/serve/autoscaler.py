"""Elastic serving autoscaler: metric-driven scale-out, lossless drain
(counterpart: ``trpo_tpu/serve/autoscaler.py``).

* **Signals** — the router's own metrics, polled every ``interval``
  seconds: mean router-outstanding requests per healthy replica, the
  windowed p99 against ``slo_p99_ms`` (judged ONLY past
  ``min_samples``), and the pressure rate (backpressure 503s and sheds
  per second).
* **Hysteresis** — a breach must persist ``breach_ticks`` consecutive
  observations before scale-OUT, and calm ``clear_ticks`` before
  scale-IN; every action opens a ``cooldown_s`` window, and no decision
  is taken while a launched replica is still ``starting``.
* **Scale-OUT** — ``ReplicaSet.add_replica()``: a NEW replica id through
  the launcher every restart uses; it enters rotation once ``/healthz``
  answers ok. Bounded by ``max_replicas``.
* **Scale-IN = lossless drain** — the victim (fewest sessions, never the
  canary) leaves stateless rotation (``draining``; pinned session
  traffic still reaches it), every pinned session is resumed onto a
  survivor from the victim's carry journal (``Router.migrate_session``,
  ``resumed: true`` on its next act), the victim forgets the moved
  sessions, and only a session-empty, inflight-empty replica is
  terminated. A drain that stalls past ``drain_timeout_s`` or meets a
  session it cannot move losslessly ABORTS back to rotation. Bounded by
  ``min_replicas``.

The reference reports each decision on its run-event bus (ROADMAP.md
Queue 1 item 18; ``bus=`` is refused). Here ``scale_outs_total``,
``drains_completed_total``, ``drains_aborted_total``, ``last_action``
and ``last_reason`` record them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from trpo_torch.config import refuse_unported
from trpo_torch.utils.metrics import quantile_nearest_rank

__all__ = ["Autoscaler"]


class Autoscaler:
    """Grow/shrink a :class:`~trpo_torch.serve.replicaset.ReplicaSet`
    from its :class:`~trpo_torch.serve.router.Router`'s own metrics.

    ``metrics_fn`` overrides the observation source (tests feed
    synthetic metric streams through it); the default reads the live
    router/replica set. ``tick()`` is synchronous — a drain runs to
    its terminal inside the call (the CanaryController pattern: tests
    drive ticks by hand, the thread just repeats them).
    """

    def __init__(
        self,
        replicaset,
        router,
        min_replicas: int,
        max_replicas: int,
        slo_p99_ms: float = 250.0,
        interval: float = 0.5,
        min_samples: int = 16,
        breach_ticks: int = 3,
        clear_ticks: int = 6,
        cooldown_s: float = 5.0,
        inflight_high_frac: float = 0.75,
        inflight_low_frac: float = 0.25,
        latency_window_s: float = 10.0,
        drain_timeout_s: float = 30.0,
        bus=None,
        metrics_fn: Optional[Callable[[], dict]] = None,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas, got "
                f"({min_replicas}, {max_replicas})"
            )
        if slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms must be > 0, got {slo_p99_ms}")
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {min_samples}"
            )
        if breach_ticks < 1 or clear_ticks < 1:
            raise ValueError(
                "breach_ticks and clear_ticks must be >= 1, got "
                f"{breach_ticks}/{clear_ticks}"
            )
        if drain_timeout_s <= 0:
            raise ValueError(
                f"drain_timeout_s must be > 0, got {drain_timeout_s}"
            )
        if not 0.0 < inflight_low_frac < inflight_high_frac <= 1.0:
            raise ValueError(
                "need 0 < inflight_low_frac < inflight_high_frac <= 1, "
                f"got ({inflight_low_frac}, {inflight_high_frac})"
            )
        refuse_unported("the run-event bus (bus=)", bus, "item 18")
        self.replicaset = replicaset
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_p99_ms = float(slo_p99_ms)
        self.interval = float(interval)
        self.min_samples = int(min_samples)
        self.breach_ticks = int(breach_ticks)
        self.clear_ticks = int(clear_ticks)
        self.cooldown_s = float(cooldown_s)
        self.inflight_high_frac = float(inflight_high_frac)
        self.inflight_low_frac = float(inflight_low_frac)
        self.latency_window_s = float(latency_window_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._metrics_fn = metrics_fn

        self.scale_outs_total = 0
        self.drains_completed_total = 0
        self.drains_aborted_total = 0
        # the latest decision: scale_out / drain_completed /
        # drain_aborted, its replica, its reason and when (monotonic)
        self.last_action: Optional[str] = None
        self.last_replica: Optional[str] = None
        self.last_reason: Optional[str] = None
        self.last_action_t: Optional[float] = None
        self.last_drain_s: Optional[float] = None
        self.last_drain_moved = 0
        self._breach_streak = 0
        self._clear_streak = 0
        self._cooldown_until = 0.0
        # the autoscaler's OWN p99 window: (monotonic t, ms) pairs fed
        # by the router's fresh-sample drain, expired by wall time so a
        # storm's tail ages out even when traffic stops entirely
        self._lat_window: deque = deque()
        self._counter_stamp: Optional[tuple] = None
        # one action at a time: a manual scale_in() (smoke/operator)
        # must not interleave with the control thread's own decision
        self._action_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- plumbing ----------------------------------------------------------

    def _record(self, action: str, replica: str, reason: str) -> None:
        self.last_action, self.last_replica = action, replica
        self.last_reason = reason
        self.last_action_t = time.monotonic()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serve-autoscaler", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # pragma: no cover — must never die
                pass

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- observation -------------------------------------------------------

    def _observe(self) -> dict:
        """One metrics sample: ``p99_ms``/``p99_samples`` over the
        time-expiring window, mean inflight per healthy replica, and
        the pressure-event rate (backpressure + sheds) since the last
        tick."""
        if self._metrics_fn is not None:
            return self._metrics_fn()
        now = time.monotonic()
        for ms in self.router.take_fresh_latencies():
            self._lat_window.append((now, ms))
        horizon = now - self.latency_window_s
        while self._lat_window and self._lat_window[0][0] < horizon:
            self._lat_window.popleft()
        lats = [ms for _, ms in self._lat_window]

        with self.replicaset.lock:
            healthy = [
                r for r in self.replicaset.replicas.values()
                if r.state == "healthy"
            ]
            inflight = (
                sum(r.inflight for r in healthy) / len(healthy)
                if healthy else 0.0
            )
        # deadline_unmeetable sheds are deliberately EXCLUDED: a client
        # declaring a deadline below the service-time floor sheds on
        # every request no matter how much capacity exists — counting
        # it as pressure would pin an idle set at max_replicas forever
        # (capacity can't fix a client problem; if real load backs the
        # deadline misses, the p99/inflight/backpressure signals carry
        # the breach on their own)
        pressure = (
            self.router.backpressure_total
            + self.router.retries_skipped_total
            + self.router.shed_stateless_total
        )
        rate = 0.0
        if self._counter_stamp is not None:
            t0, p0 = self._counter_stamp
            dt = max(now - t0, 1e-6)
            rate = max(0.0, (pressure - p0) / dt)
        self._counter_stamp = (now, pressure)
        return {
            "p99_ms": quantile_nearest_rank(lats, 0.99),
            "p99_samples": len(lats),
            "inflight_per_replica": inflight,
            "pressure_rate": rate,
            "healthy": len(healthy),
        }

    def _classify(self, m: dict) -> str:
        """``"breach"`` / ``"clear"`` / ``"hold"`` for one observation.
        The p99 signal is honored ONLY past ``min_samples`` — the
        autoscaler never acts on a 3-request "p99"; inflight and pressure are router-local truths and
        always count."""
        p99 = m.get("p99_ms")
        samples = int(m.get("p99_samples") or 0)
        p99_known = p99 is not None and samples >= self.min_samples
        high_water = self.inflight_high_frac * self.router.max_inflight
        low_water = self.inflight_low_frac * self.router.max_inflight
        inflight = float(m.get("inflight_per_replica") or 0.0)
        pressure = float(m.get("pressure_rate") or 0.0)
        if (
            (p99_known and p99 > self.slo_p99_ms)
            or inflight > high_water
            or pressure > 0.0
        ):
            return "breach"
        if inflight < low_water and (
            not p99_known or p99 <= self.slo_p99_ms
        ):
            return "clear"
        return "hold"

    # -- the control loop --------------------------------------------------

    def tick(self) -> None:
        """One control pass: observe, update the hysteresis streaks,
        and take at most one action."""
        m = self._observe()
        verdict = self._classify(m)
        if verdict == "breach":
            self._breach_streak += 1
            self._clear_streak = 0
        elif verdict == "clear":
            self._clear_streak += 1
            self._breach_streak = 0
        else:
            self._breach_streak = 0
            self._clear_streak = 0
        now = time.monotonic()
        if now < self._cooldown_until:
            return
        with self.replicaset.lock:
            warming = any(
                r.state == "starting"
                for r in self.replicaset.replicas.values()
            )
        if warming:
            return  # capacity already in flight: judge it once it lands
        size = self.replicaset.active_size()
        if self._breach_streak >= self.breach_ticks:
            if size < self.max_replicas:
                self.scale_out(self._reason("breach", m))
            self._breach_streak = 0
        elif self._clear_streak >= self.clear_ticks:
            if size > self.min_replicas:
                self.scale_in(reason=self._reason("clear", m))
            self._clear_streak = 0

    @staticmethod
    def _reason(kind: str, m: dict) -> str:
        # every field None-tolerant, like _classify: a partial
        # metrics_fn dict must never crash the tick that finally acts
        def num(key, nd=2):
            v = m.get(key)
            return f"{v:.{nd}f}" if isinstance(v, (int, float)) else "n/a"

        return (
            f"{kind}: p99={num('p99_ms', 1)}ms"
            f" samples={m.get('p99_samples')}"
            f" inflight/replica={num('inflight_per_replica')}"
            f" pressure/s={num('pressure_rate')}"
        )

    # -- actions (public: the smoke and operators drive them directly) ----

    def scale_out(self, reason: str = "manual") -> str:
        """Launch one replica (bounded by ``max_replicas``); it joins
        rotation when its ``/healthz`` goes healthy."""
        with self._action_lock:
            if self.replicaset.active_size() >= self.max_replicas:
                raise RuntimeError(
                    f"already at max_replicas={self.max_replicas}"
                )
            rid = self.replicaset.add_replica()
            self.scale_outs_total += 1
            self._cooldown_until = time.monotonic() + self.cooldown_s
            self._record("scale_out", rid, reason)
        return rid

    def _pick_victim(self) -> Optional[str]:
        """Fewest sessions, never the canary, only healthy replicas —
        and never below ``min_replicas``."""
        with self.replicaset.lock:
            healthy = [
                r for r in self.replicaset.replicas.values()
                if r.state == "healthy" and not r.canary
            ]
            if not healthy:
                return None
            return min(healthy, key=lambda r: (r.sessions, r.id)).id

    def scale_in(self, victim: Optional[str] = None,
                 reason: str = "manual") -> bool:
        """Drain one replica out of the set, losslessly. ``victim``
        overrides the fewest-sessions choice (operator/smoke control).
        True = drained and terminated; False = no drainable victim, or
        the drain aborted back to rotation."""
        with self._action_lock:
            if self.replicaset.active_size() <= self.min_replicas:
                return False
            with self.replicaset.lock:
                healthy = sum(
                    1 for r in self.replicaset.replicas.values()
                    if r.state == "healthy"
                )
            if healthy <= self.min_replicas:
                # active_size counts evicted (down, relaunching)
                # replicas as capacity-in-flight; draining a HEALTHY
                # replica while they are down would take actual serving
                # capacity below the floor — and if a crash budget
                # later burns out, leave it there with no breach to
                # ever grow it back
                return False
            rid = victim or self._pick_victim()
            if rid is None or not self.replicaset.begin_drain(rid):
                return False
            self._cooldown_until = time.monotonic() + self.cooldown_s
            t0 = time.monotonic()
            try:
                ok, detail, moved = self._drain(rid)
            except Exception as e:
                # a drain bug must still resolve: an exception escaping
                # here would strand the victim in `draining` forever
                # (out of rotation, still counted as capacity)
                ok, moved = False, 0
                detail = f"drain error: {type(e).__name__}: {e}"
            if not ok:
                self.replicaset.abort_drain(rid)
                self.drains_aborted_total += 1
                self._record("drain_aborted", rid,
                             f"{detail} ({moved} sessions moved)")
                return False
            if not self.replicaset.finish_drain(rid):
                # the victim left `draining` between the last check and
                # termination (died — the evict/restart path owns it
                # now): the set did NOT shrink, so this is an aborted
                # drain, not a completed one
                self.drains_aborted_total += 1
                self._record("drain_aborted", rid,
                             "victim died before termination "
                             f"({moved} sessions moved)")
                return False
            self.drains_completed_total += 1
            self.last_drain_s = time.monotonic() - t0
            self.last_drain_moved = moved
            self._record("drain_completed", rid, reason)
            return True

    def _drain(self, rid: str):
        """The lossless-drain body: migrate every pinned session, then
        wait for the victim's in-flight requests to wind down.
        ``(ok, detail, sessions_moved)`` — any un-movable session or a
        blown ``drain_timeout_s`` fails the WHOLE drain (the already-
        moved sessions stay moved: they are on healthy survivors,
        nothing is lost either way)."""
        deadline = time.monotonic() + self.drain_timeout_s
        moved = []
        try:
            sids = self.router.sessions_pinned_to(rid)
            if sids and self.router.journal_dir is None:
                return (
                    False,
                    "no carry journal: pinned sessions cannot move "
                    "losslessly",
                    0,
                )
            for sid in sids:
                if time.monotonic() > deadline:
                    return (
                        False,
                        f"drain timeout after {self.drain_timeout_s:g}s "
                        f"({len(moved)}/{len(sids)} sessions moved)",
                        len(moved),
                    )
                outcome = self.router.migrate_session(sid, rid)
                if outcome is False:
                    return (
                        False,
                        f"session {sid} could not be resumed losslessly",
                        len(moved),
                    )
                if outcome is True:
                    moved.append(sid)
            # in-flight wind-down: stateless requests admitted before
            # the drain began still hold reservations — only an idle
            # replica is terminated
            rec = self.replicaset.get(rid)
            while rec is not None:
                with self.replicaset.lock:
                    if rec.state != "draining":
                        return False, "victim died mid-drain", len(moved)
                    inflight = rec.inflight
                if inflight == 0:
                    break
                if time.monotonic() > deadline:
                    return (
                        False,
                        f"drain timeout: {inflight} requests still in "
                        "flight",
                        len(moved),
                    )
                time.sleep(0.01)
            # late arrivals: a session re-pinned here between the
            # migration sweep and now (shouldn't happen — draining
            # replicas take no new pins — but a failover racing the
            # sweep could)
            leftover = self.router.sessions_pinned_to(rid)
            if leftover:
                return (
                    False,
                    f"{len(leftover)} sessions re-pinned mid-drain",
                    len(moved),
                )
            return True, "", len(moved)
        finally:
            # moved sessions live on the survivors WHICHEVER way the
            # drain resolves: the victim must drop its stale copies
            # (store slots + journal tombstones) even on an abort that
            # returns it to rotation — a stale duplicate could LRU-
            # evict a genuinely live session later (best-effort: a
            # dead victim simply misses the POST)
            if moved:
                self.router.forget_drained_sessions(rid, moved)
