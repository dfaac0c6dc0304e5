"""The fleet-wide aggregation plane
(counterpart: ``trpo_tpu/obs/aggregate.py``).

Every process in the system already exposes its own observability
surface — the router's ``/status`` + ``/metrics``, each member's
``obs/server.StatusServer``, the fleet view's ``FleetStatusServer``,
the promoter's on-disk journal — but nothing *watches* them together
live. This module is that watcher:

* :class:`MetricsAggregator` — polls every registered target on an
  interval into bounded in-memory ring-buffer time series. One poller
  thread PER TARGET, so a dead or wedged endpoint makes exactly its
  own series stale and never blocks the others — staleness is itself
  an alertable condition (:mod:`trpo_torch.obs.alerts`' ``target_stale``
  rule reads :meth:`MetricsAggregator.target_states`), never a silent
  gap. A synchronous :meth:`MetricsAggregator.tick` drives the same
  scrape+evaluate cycle deterministically for tests and ``--once``
  dashboards.
* Scrape targets (all duck-typed on ``.name`` + ``.scrape(timeout)``):

  - :class:`HttpTarget` — one ``/status`` endpoint (router, replica,
    member StatusServer, fleet view): the JSON tree is flattened to
    dotted numeric series (``status.counters.routed_total``,
    ``status.latency_recent_ms.0.99``, ...); pass ``metrics_path`` to
    also parse the Prometheus text exposition into per-sample series.
  - :class:`JournalTarget` — the promotion controller's durable
    journal (``fleet/promote.py``): derives ``promote.inflight`` (non-
    terminal entries) and ``promote.unconverged_s`` (seconds since the
    journal's last atomic write while anything is inflight) — the
    mtime-based age that makes "promoter stuck in publishing"
    *observable from the outside*, exactly the wedge ``kill_promoter``
    injects.
  - :class:`CallbackTarget` — in-process values (e.g. a
    ``CanaryController``'s ``rolled_back_total``) without an HTTP hop.

* Emission: each evaluation tick batches one ``metric_sample`` event
  per target ``up`` series plus the latest point of every WATCHED
  series (the ones alert rules read, or an explicit ``emit_series``
  glob list) through ``EventBus.emit_batch`` — one lock hold, one
  write, the same ≤2%-overhead discipline the tracer set. The
  store keeps everything; the log carries the bounded, alert-relevant
  subset plus proof the plane was armed (the validator's alert
  contracts key off ``metric_sample`` proximity to decide whether a
  fault was injected while anyone was watching).
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Series",
    "HttpTarget",
    "JournalTarget",
    "CallbackTarget",
    "MetricsAggregator",
    "flatten_status",
    "parse_prometheus",
]


def _num(v):
    """The numeric leaves a series can hold (bool counts as 0/1 —
    ``finished: true`` should chart)."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def flatten_status(obj, prefix: str = "status") -> Dict[str, float]:
    """A ``/status`` JSON tree as dotted numeric series. Non-numeric
    leaves and lists are skipped (series are time-value charts, not
    documents); dict recursion keeps the path, so the router's
    ``counters.routed_total`` becomes ``status.counters.routed_total``
    and a nested replica row keeps its replica id in the key."""
    out: Dict[str, float] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
            return
        v = _num(node)
        if v is not None:
            out[path] = v

    walk(obj, prefix)
    return out


def parse_prometheus(text: str) -> Dict[str, float]:
    """Prometheus text exposition (version 0.0.4) as a series dict —
    the sample name WITH its label block is the series key (labels are
    what make ``trpo_iteration_stat{stat="kl"}`` distinct rows). Bad
    lines are skipped, not fatal: a scraper must survive whatever an
    endpoint mid-restart serves."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # "name{labels} value" or "name value" (timestamps unused here)
        try:
            key, rest = line.rsplit(" ", 1)
            value = float(rest)
        except ValueError:
            continue
        key = key.strip()
        if key:
            out[key] = value
    return out


class Series:
    """One bounded ring-buffer time series of ``(t, value)`` points.
    Window queries are linear in the window, not the buffer — the
    buffer is small (``maxlen``) by construction."""

    __slots__ = ("_buf",)

    def __init__(self, maxlen: int = 600):
        self._buf: deque = deque(maxlen=maxlen)

    def add(self, t: float, value: float) -> None:
        self._buf.append((float(t), float(value)))

    def __len__(self) -> int:
        return len(self._buf)

    def last(self) -> Optional[Tuple[float, float]]:
        return self._buf[-1] if self._buf else None

    def window(self, now: float, seconds: float) -> List[Tuple[float, float]]:
        lo = now - seconds
        return [(t, v) for t, v in self._buf if t >= lo]

    def span(self) -> float:
        """Seconds between the oldest and newest point (0 if < 2)."""
        if len(self._buf) < 2:
            return 0.0
        return self._buf[-1][0] - self._buf[0][0]

    def delta(self, now: float, seconds: float) -> Optional[float]:
        """Increase of a counter over the window, reset-aware: a drop
        (process restart zeroed the counter) contributes the new
        absolute value, the standard Prometheus ``increase`` rule.
        None when the window holds < 2 points (no rate computable)."""
        win = self.window(now, seconds)
        if len(win) < 2:
            return None
        total, prev = 0.0, win[0][1]
        for _, v in win[1:]:
            total += (v - prev) if v >= prev else v
            prev = v
        return total

    def last_increase_t(self) -> Optional[float]:
        """Timestamp of the most recent strict increase (stall
        detection); the FIRST point's time when the series never
        moved — "has not increased since we started watching"."""
        pts = list(self._buf)
        if not pts:
            return None
        for i in range(len(pts) - 1, 0, -1):
            if pts[i][1] > pts[i - 1][1]:
                return pts[i][0]
        return pts[0][0]


# ---------------------------------------------------------------------------
# scrape targets
# ---------------------------------------------------------------------------


class HttpTarget:
    """One HTTP observability endpoint. ``url`` is the server base
    (``http://host:port``); ``status_path`` is fetched and flattened,
    ``metrics_path`` (optional) is fetched and parsed as Prometheus
    text. Any failure raises — the aggregator owns the stale
    bookkeeping (the ``scrape_member`` tolerance pattern, but the
    *caller* records the miss so it can alert on it)."""

    def __init__(
        self,
        name: str,
        url: str,
        status_path: str = "/status",
        metrics_path: Optional[str] = None,
    ):
        self.name = name
        self.url = url.rstrip("/")
        self.status_path = status_path
        self.metrics_path = metrics_path

    def scrape(self, timeout: float) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.status_path:
            with urllib.request.urlopen(
                self.url + self.status_path, timeout=timeout
            ) as r:
                out.update(flatten_status(json.load(r)))
        if self.metrics_path:
            with urllib.request.urlopen(
                self.url + self.metrics_path, timeout=timeout
            ) as r:
                out.update(parse_prometheus(r.read().decode()))
        return out


class JournalTarget:
    """The promotion journal as a scrape target. ``path`` may be the
    journal file or the directory that will contain it. A MISSING
    journal is a successful scrape of "no promotions yet" (inflight
    0), not a failure — the promoter writes it lazily; an unreadable
    one raises (stale), because a journal that exists but cannot be
    parsed is exactly the wedge worth alerting on."""

    JOURNAL_NAME = "promote_journal.json"

    def __init__(self, name: str, path: str):
        self.name = name
        if os.path.isdir(path) or not path.endswith(".json"):
            path = os.path.join(path, self.JOURNAL_NAME)
        self.path = path

    def scrape(self, timeout: float) -> Dict[str, float]:
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            return {"promote.entries": 0.0, "promote.inflight": 0.0,
                    "promote.unconverged_s": 0.0}
        with open(self.path) as f:
            entries = json.load(f)
        if not isinstance(entries, dict):
            raise ValueError("journal is not an object")
        inflight = sum(
            1 for e in entries.values()
            if isinstance(e, dict) and e.get("outcome") is None
        )
        # the journal is written atomically on every phase transition,
        # so mtime = the moment of the LAST transition: while anything
        # is inflight, its age is "how long the promoter has been
        # stuck" — observable even when the promoter process is gone
        age = max(0.0, time.time() - st.st_mtime) if inflight else 0.0
        return {
            "promote.entries": float(len(entries)),
            "promote.inflight": float(inflight),
            "promote.unconverged_s": age,
        }


class CallbackTarget:
    """In-process values without an HTTP hop: ``fn`` returns a flat
    ``{series: number}`` dict (non-numeric values are dropped)."""

    def __init__(self, name: str, fn: Callable[[], dict]):
        self.name = name
        self._fn = fn

    def scrape(self, timeout: float) -> Dict[str, float]:
        raw = self._fn()
        if not isinstance(raw, dict):
            raise ValueError("callback did not return a dict")
        out = {}
        for k, v in raw.items():
            n = _num(v)
            if n is not None:
                out[str(k)] = n
        return out


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------


class _TargetState:
    __slots__ = (
        "target", "first_attempt_t", "last_ok_t", "failures_total",
        "scrapes_total", "stale",
    )

    def __init__(self, target):
        self.target = target
        self.first_attempt_t: Optional[float] = None
        self.last_ok_t: Optional[float] = None
        self.failures_total = 0
        self.scrapes_total = 0
        self.stale = False


class MetricsAggregator:
    """Poll every registered target into ring-buffer series; evaluate
    alert rules; emit ``metric_sample`` batches.

    Live mode (:meth:`start`): one daemon poller thread per target plus
    one evaluator thread — a slow target saturates its own thread's
    timeout, nothing else. Test/CI mode (:meth:`tick`): one synchronous
    scrape-all + evaluate + emit pass with an injectable clock.

    ``engine`` (an :class:`trpo_torch.obs.alerts.AlertEngine`) is
    optional; when present its rules also define the default WATCHED
    series set (what gets emitted as ``metric_sample`` events) —
    override with ``emit_series`` globs.
    """

    def __init__(
        self,
        targets: Iterable = (),
        bus=None,
        engine=None,
        interval: float = 0.5,
        timeout: float = 0.75,
        stale_after: Optional[float] = None,
        maxlen: int = 600,
        emit_series: Optional[Iterable[str]] = None,
    ):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.bus = bus
        self.engine = engine
        self.interval = float(interval)
        self.timeout = float(timeout)
        # a target is stale once it has gone this long without a good
        # scrape — generous vs the interval so one slow poll is not a
        # flap, tight enough that a partitioned host alerts in seconds
        self.stale_after = (
            float(stale_after) if stale_after is not None
            else max(3.0 * self.interval, 2.0)
        )
        self.maxlen = int(maxlen)
        self._emit_patterns = (
            tuple(emit_series) if emit_series is not None else None
        )
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str], Series] = {}
        self._states: Dict[str, _TargetState] = {}
        self._last_emit_t: Dict[Tuple[str, str], float] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        for t in targets:
            self.add_target(t)

    # -- registration / store access --------------------------------------

    def add_target(self, target) -> None:
        name = getattr(target, "name", None)
        if not name or not callable(getattr(target, "scrape", None)):
            raise TypeError(
                "target must have .name and .scrape(timeout)"
            )
        with self._lock:
            if name in self._states:
                raise ValueError(f"duplicate target name {name!r}")
            self._states[name] = _TargetState(target)
        if self._started:
            self._spawn_poller(name)

    def target_names(self) -> List[str]:
        with self._lock:
            return sorted(self._states)

    def target_states(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-target scrape health: ``up`` (scraped OK within the
        stale budget), ``stale_for_s`` (seconds since the last good
        scrape — since first attempt when none ever succeeded), and
        the raw counters. The ``target_stale`` alert rule reads this."""
        now = time.time() if now is None else now
        out = {}
        with self._lock:
            for name, st in self._states.items():
                ref = st.last_ok_t or st.first_attempt_t
                stale_for = (now - ref) if ref is not None else 0.0
                stale = (
                    st.last_ok_t is None or
                    (now - st.last_ok_t) > self.stale_after
                ) and stale_for > self.stale_after
                st.stale = stale
                out[name] = {
                    "up": not stale and st.last_ok_t is not None,
                    "stale": stale,
                    "stale_for_s": stale_for if stale else 0.0,
                    "last_ok_t": st.last_ok_t,
                    "failures_total": st.failures_total,
                    "scrapes_total": st.scrapes_total,
                }
        return out

    def series_names(self, target: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(
                s for (tg, s) in self._series
                if target is None or tg == target
            )

    def get_series(self, target: str, series: str) -> Optional[Series]:
        with self._lock:
            return self._series.get((target, series))

    def match_series(
        self, target: str, patterns
    ) -> Dict[str, Series]:
        """All of one target's series whose name matches ANY of the
        fnmatch globs (str or iterable of str)."""
        if isinstance(patterns, str):
            patterns = (patterns,)
        with self._lock:
            return {
                s: ser for (tg, s), ser in self._series.items()
                if tg == target
                and any(fnmatch.fnmatch(s, p) for p in patterns)
            }

    def latest(self, target: str, series: str) -> Optional[float]:
        ser = self.get_series(target, series)
        last = ser.last() if ser else None
        return last[1] if last else None

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Dashboard view: per-target health + the latest point of
        every stored series (the observatory's data source)."""
        now = time.time() if now is None else now
        states = self.target_states(now)
        with self._lock:
            latest: Dict[str, Dict[str, float]] = {}
            for (tg, s), ser in self._series.items():
                last = ser.last()
                if last is not None:
                    latest.setdefault(tg, {})[s] = last[1]
        return {"targets": states, "latest": latest, "t": now}

    # -- scraping ----------------------------------------------------------

    def _record(self, name: str, samples: Optional[dict], t: float) -> None:
        with self._lock:
            st = self._states.get(name)
            if st is None:
                return
            if st.first_attempt_t is None:
                st.first_attempt_t = t
            st.scrapes_total += 1
            if samples is None:
                st.failures_total += 1
                return
            st.last_ok_t = t
            for s, v in samples.items():
                key = (name, s)
                ser = self._series.get(key)
                if ser is None:
                    ser = self._series[key] = Series(self.maxlen)
                ser.add(t, v)

    def scrape_target(self, name: str, now: Optional[float] = None) -> bool:
        """One scrape of one target, recorded; True on success. Never
        raises — a failed scrape IS data (the target goes stale)."""
        with self._lock:
            st = self._states.get(name)
            target = st.target if st else None
        if target is None:
            return False
        try:
            samples = target.scrape(self.timeout)
        except Exception:
            samples = None
        self._record(
            name, samples, time.time() if now is None else now
        )
        return samples is not None

    def tick(self, now: Optional[float] = None) -> dict:
        """One synchronous scrape-all + evaluate + emit pass (tests,
        ``--once`` dashboards). Returns :meth:`snapshot`."""
        for name in self.target_names():
            self.scrape_target(name, now=now)
        return self._evaluate_and_emit(now)

    def _watched_patterns(self):
        if self._emit_patterns is not None:
            return self._emit_patterns
        if self.engine is not None:
            pats = []
            for rule in self.engine.rules:
                for attr in ("series", "total_series", "guard_series",
                             "key_series", "unless_series"):
                    p = getattr(rule, attr, None)
                    if not p:
                        continue
                    pats.extend((p,) if isinstance(p, str) else p)
            return tuple(dict.fromkeys(pats))
        return ("*",)

    def _evaluate_and_emit(self, now: Optional[float] = None) -> dict:
        now = time.time() if now is None else now
        states = self.target_states(now)
        if self.engine is not None:
            self.engine.evaluate(self, now=now)
        if self.bus is not None:
            patterns = self._watched_patterns()
            fields: List[dict] = []
            with self._lock:
                for name, st in states.items():
                    fields.append({
                        "target": name, "series": "up",
                        "value": 1.0 if st["up"] else 0.0,
                        "stale": bool(st["stale"]),
                    })
                for (tg, s), ser in self._series.items():
                    if not any(fnmatch.fnmatch(s, p) for p in patterns):
                        continue
                    last = ser.last()
                    if last is None:
                        continue
                    key = (tg, s)
                    # emit each stored point at most once: dashboards
                    # replaying the log see the true series, not one
                    # inflated by the evaluator outpacing the scraper
                    if self._last_emit_t.get(key) == last[0]:
                        continue
                    self._last_emit_t[key] = last[0]
                    fields.append({
                        "target": tg, "series": s, "value": last[1],
                        "stale": bool(states.get(tg, {}).get("stale")),
                    })
            if fields:
                self.bus.emit_batch("metric_sample", fields)
        return self.snapshot(now)

    # -- live mode ---------------------------------------------------------

    def _spawn_poller(self, name: str) -> None:
        th = threading.Thread(
            target=self._poll_loop, args=(name,),
            name=f"obs-agg-{name}", daemon=True,
        )
        self._threads.append(th)
        th.start()

    def _poll_loop(self, name: str) -> None:
        while not self._stop.is_set():
            self.scrape_target(name)
            self._stop.wait(self.interval)

    def _eval_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._evaluate_and_emit()
            except Exception:
                # the watcher must never take the watched down with it
                pass
            self._stop.wait(self.interval)

    def start(self) -> "MetricsAggregator":
        if self._started:
            return self
        self._started = True
        self._stop.clear()
        for name in self.target_names():
            self._spawn_poller(name)
        th = threading.Thread(
            target=self._eval_loop, name="obs-agg-eval", daemon=True
        )
        self._threads.append(th)
        th.start()
        return self

    def close(self) -> None:
        self._stop.set()
        for th in self._threads:
            th.join(timeout=max(2.0, self.timeout + 1.0))
        self._threads = []
        self._started = False
