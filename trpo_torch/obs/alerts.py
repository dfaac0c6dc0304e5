"""Declarative SLO alerting over the aggregation plane
(counterpart: ``trpo_tpu/obs/alerts.py``).

Rules are data (:class:`Rule`), not code: each names a series glob on
a target glob and one of six evaluation kinds —

* ``threshold`` — the summed latest value of the matched series,
  compared with ``op`` against ``threshold`` (optionally gated by a
  ``guard_series`` sample floor: a 3-request "p99" must never fire an
  SLO alert — the ``latency_samples`` doctrine).
* ``rate`` — reset-aware counter increase over ``window_s`` (any
  ``*_dropped_total`` moving AT ALL is a firing condition: the
  tracer/capture/journal write-behinds are contractually lossless).
* ``burn_rate`` — the SRE two-window burn rule (Beyer et al., SRE
  ch. 5, scaled from 5m/1h to test timescales): error fraction =
  Δ``series`` / Δ``total_series`` per window, burn = fraction /
  (1 - ``objective``); fires only when BOTH the short (``window_s``)
  and long (``long_window_s``, default 4×) windows burn above
  ``threshold`` — the short window makes it resolve fast, the long
  window keeps a blip from paging.
* ``streak`` — consecutive truthy samples of ``series`` counted once
  per change of ``key_series`` (the KL-rollback streak from
  ``obs/health.py``, lifted into a rule over the scraped
  ``status.stats.kl_rolled_back`` / ``status.iteration`` pair instead
  of a parallel monitor).
* ``stall`` — ``series`` has not increased for ``window_s`` despite
  being watched at least that long (fleet round stall), suppressed
  while ``unless_series`` is truthy (a FINISHED member is not
  stalled).
* ``stale`` — the target itself missed its scrape budget for longer
  than ``threshold`` seconds (reads the aggregator's target states,
  not a series: a dead endpoint produces no series).

:class:`AlertEngine` evaluates every rule against every matching
target each tick and owns the firing/resolved lifecycle: ``for_ticks``
consecutive breaches arm a FIRING ``alert`` event (exactly once — the
dedupe the validator's pairing contract relies on), the first clean
evaluation emits its RESOLVED. A rule whose series simply is not
present on a target does not evaluate — absent data is never a breach,
which is half of the zero-false-positive contract; the other half is
``scripts/validate_events`` refusing any firing alert without a
matching cause in its window.

``FAULT_ALERT_RULES`` is the shared fault→expected-rules map: the
validator uses it to demand a firing alert per armed chaos fault, and
``obs/analyze.py`` uses it to report time-to-detect.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Rule",
    "AlertEngine",
    "default_rules",
    "FAULT_ALERT_RULES",
]

# chaos fault kind -> alert rule names that count as DETECTING it.
# Shared by scripts/validate_events (fault→alert contract: an armed
# fault of these kinds must be matched by a firing alert among its
# rules) and obs/analyze.py (time-to-detect). Faults not listed here
# (kill_replica, drop_carry_journal, ...) are covered by the original
# recovery contracts; listing here ADDS the detection requirement.
FAULT_ALERT_RULES = {
    "overload_storm": ("slo_p99", "shed_rate"),
    "slow_replica": ("slo_p99", "shed_rate", "target_stale"),
    "slow_network": (
        "slo_p99", "shed_rate", "lease_expired", "target_stale",
    ),
    "partition_host": ("target_stale", "lease_expired"),
    "wedge_reload": ("canary_rejected",),
    "corrupt_checkpoint": ("canary_rejected",),
    "regress_checkpoint": ("canary_rejected",),
    "kill_promoter": ("promoter_stuck",),
}

_KINDS = ("threshold", "rate", "burn_rate", "streak", "stall", "stale")
_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def _pats(p) -> Tuple[str, ...]:
    if not p:
        return ()
    return (p,) if isinstance(p, str) else tuple(p)


@dataclass(frozen=True)
class Rule:
    """One declarative alert rule (see module docstring for kinds)."""

    name: str
    kind: str
    series: Tuple[str, ...] = ()        # fnmatch globs; matches SUMMED
    target: str = "*"                   # glob over target names
    op: str = ">"
    threshold: float = 0.0
    window_s: float = 2.0
    long_window_s: Optional[float] = None   # burn_rate; default 4x
    total_series: Tuple[str, ...] = ()      # burn_rate denominator
    objective: float = 0.99                 # burn_rate SLO objective
    min_total: float = 1.0                  # burn_rate denominator floor
    for_ticks: int = 2
    guard_series: Tuple[str, ...] = ()
    guard_min: float = 0.0
    key_series: Tuple[str, ...] = ()        # streak dedupe key
    streak_n: int = 3
    unless_series: Tuple[str, ...] = ()     # stall suppressor

    def __post_init__(self):
        if not self.name:
            raise ValueError("rule needs a name")
        if self.kind not in _KINDS:
            raise ValueError(
                f"rule {self.name}: kind must be one of {_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name}: op must be one of "
                f"{tuple(_OPS)}, got {self.op!r}"
            )
        if self.for_ticks < 1:
            raise ValueError(
                f"rule {self.name}: for_ticks must be >= 1"
            )
        # normalize the glob fields so callers may pass plain strings
        for f in ("series", "total_series", "guard_series",
                  "key_series", "unless_series"):
            object.__setattr__(self, f, _pats(getattr(self, f)))
        if self.kind != "stale" and not self.series:
            raise ValueError(
                f"rule {self.name}: kind {self.kind!r} needs a series"
            )
        if self.kind == "burn_rate" and not self.total_series:
            raise ValueError(
                f"rule {self.name}: burn_rate needs total_series"
            )
        if not (0.0 < self.objective < 1.0) and self.kind == "burn_rate":
            raise ValueError(
                f"rule {self.name}: objective must be in (0, 1)"
            )

    @property
    def long_window(self) -> float:
        return (
            self.long_window_s if self.long_window_s is not None
            else 4.0 * self.window_s
        )


def default_rules(
    slo_p99_ms: float = 500.0,
    window_s: float = 2.0,
    burn_threshold: float = 2.0,
    stale_after_s: float = 3.0,
    rollback_streak: int = 3,
    stall_window_s: float = 30.0,
    promoter_stuck_s: float = 15.0,
    min_latency_samples: int = 8,
) -> Tuple[Rule, ...]:
    """The minimum rule set, windows scaled for test
    timescales (production would use the same shapes with 5m/1h
    burn windows and minutes-long stalls)."""
    w = float(window_s)
    shed_series = (
        "status.counters.shed_*_total",
        "status.counters.backpressure_total",
    )
    return (
        # serve p99 vs the SLO — over the router's TIME-expiring
        # recent window so the alert resolves when the system does,
        # guarded by its sample count (thin windows never fire)
        Rule(
            "slo_p99", "threshold",
            series="status.latency_recent_ms.0.99",
            op=">", threshold=float(slo_p99_ms), window_s=w,
            guard_series="status.latency_recent_samples",
            guard_min=float(min_latency_samples), for_ticks=2,
        ),
        # shed/backpressure burn vs admitted traffic: two-window so a
        # single shed blip is not a page but a storm is
        Rule(
            "shed_rate", "burn_rate",
            series=shed_series,
            total_series=("status.counters.routed_total",) + shed_series,
            objective=0.99, threshold=float(burn_threshold),
            window_s=w, long_window_s=4.0 * w, min_total=8.0,
            for_ticks=1,
        ),
        # failover quality: reestablished (lossy fallback) burning
        # against all session recoveries — objective 0.5 = "at least
        # half of recoveries must be lossless resumes"
        Rule(
            "resumed_fraction", "burn_rate",
            series="status.counters.sessions_reestablished_total",
            total_series=(
                "status.counters.sessions_resumed_total",
                "status.counters.sessions_reestablished_total",
            ),
            objective=0.5, threshold=1.0,
            window_s=2.0 * w, long_window_s=8.0 * w, min_total=2.0,
            for_ticks=1,
        ),
        # any canary rejection/rollback is an event worth a page
        Rule(
            "canary_rejected", "rate",
            series=("*rolled_back_total*", "*canary_rejected*"),
            op=">", threshold=0.0, window_s=2.0 * w, for_ticks=1,
        ),
        Rule(
            "lease_expired", "rate",
            series=("*lease*expired*",),
            op=">", threshold=0.0, window_s=2.0 * w, for_ticks=1,
        ),
        # the write-behinds are contractually lossless: ANY drop fires
        Rule(
            "dropped_events", "rate",
            series=("*dropped_total*",),
            op=">", threshold=0.0, window_s=2.0 * w, for_ticks=1,
        ),
        # obs/health.py's KL-rollback streak, lifted into a rule over
        # the scraped iteration stats (counted once per iteration)
        Rule(
            "kl_rollback_streak", "streak",
            series="status.stats.kl_rolled_back",
            key_series="status.iteration",
            streak_n=int(rollback_streak),
            window_s=max(30.0 * w, 60.0), for_ticks=1,
        ),
        # a member whose iteration counter stops moving (and is not
        # finished) has stalled its round
        Rule(
            "fleet_stall", "stall",
            series="status.iteration",
            unless_series="status.finished",
            window_s=float(stall_window_s), for_ticks=1,
        ),
        # the promoter's journal has carried a non-terminal entry with
        # no transition for too long — stuck in publishing
        Rule(
            "promoter_stuck", "threshold",
            series="promote.unconverged_s",
            op=">", threshold=float(promoter_stuck_s), window_s=w,
            for_ticks=1,
        ),
        # the watcher's own failure mode: a target that stopped
        # answering is an alert, never a silent gap
        Rule(
            "target_stale", "stale",
            threshold=float(stale_after_s), for_ticks=2,
        ),
    )


class _Activation:
    __slots__ = ("breaches", "firing", "fired_t", "value")

    def __init__(self):
        self.breaches = 0
        self.firing = False
        self.fired_t = 0.0
        self.value = None


class AlertEngine:
    """Evaluate rules over a :class:`MetricsAggregator`'s store and
    own the firing/resolved lifecycle. ``history`` keeps every emitted
    alert dict (smoke assertions read it); ``active()`` lists
    currently-firing (rule, target) pairs."""

    def __init__(self, rules, bus=None):
        self.rules: Tuple[Rule, ...] = tuple(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.bus = bus
        self._lock = threading.Lock()
        self._act: Dict[Tuple[str, str], _Activation] = {}
        self.history: List[dict] = []
        self.firing_total: Dict[str, int] = {}
        self.resolved_total: Dict[str, int] = {}

    def active(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(
                k for k, a in self._act.items() if a.firing
            )

    # -- evaluation --------------------------------------------------------

    def evaluate(self, agg, now: Optional[float] = None) -> List[dict]:
        """One tick: every rule against every matching target. Returns
        the alert events emitted THIS tick."""
        now = time.time() if now is None else now
        states = agg.target_states(now)
        emitted: List[dict] = []
        for rule in self.rules:
            for target in sorted(states):
                if not fnmatch(target, rule.target):
                    continue
                res = self._eval_rule(rule, agg, target, states, now)
                if res is None:
                    breach, value = False, None
                else:
                    breach, value = res
                evs = self._transition(rule, target, breach, value, now)
                emitted.extend(evs)
        if emitted and self.bus is not None:
            self.bus.emit_batch("alert", emitted)
        with self._lock:
            self.history.extend(emitted)
        return emitted

    def _sum_latest(self, agg, target, patterns, now, max_age):
        """Summed latest value of the matched series; None when no
        matched series has a point young enough."""
        vals = []
        for _, ser in agg.match_series(target, patterns).items():
            last = ser.last()
            if last is not None and now - last[0] <= max_age:
                vals.append(last[1])
        return sum(vals) if vals else None

    def _sum_delta(self, agg, target, patterns, now, window):
        """Summed reset-aware increase over the window across matched
        series; None when NO matched series has a computable delta."""
        deltas = [
            d for _, ser in agg.match_series(target, patterns).items()
            if (d := ser.delta(now, window)) is not None
        ]
        return sum(deltas) if deltas else None

    def _eval_rule(self, rule, agg, target, states, now):
        """(breach, observed value) or None = not evaluable (no data /
        guard floor unmet) — never a breach, never a resolve-blocker."""
        stale_age = max(3.0 * rule.window_s, 10.0)
        if rule.kind == "stale":
            st = states.get(target) or {}
            stale_for = float(st.get("stale_for_s") or 0.0)
            return stale_for > rule.threshold, stale_for
        if rule.guard_series:
            g = self._sum_latest(
                agg, target, rule.guard_series, now, stale_age
            )
            if g is None or g < rule.guard_min:
                return None
        if rule.kind == "threshold":
            v = self._sum_latest(
                agg, target, rule.series, now, stale_age
            )
            if v is None:
                return None
            return _OPS[rule.op](v, rule.threshold), v
        if rule.kind == "rate":
            d = self._sum_delta(
                agg, target, rule.series, now, rule.window_s
            )
            if d is None:
                return None
            return _OPS[rule.op](d, rule.threshold), d
        if rule.kind == "burn_rate":
            burns = []
            for win in (rule.window_s, rule.long_window):
                bad = self._sum_delta(
                    agg, target, rule.series, now, win
                )
                tot_own = self._sum_delta(
                    agg, target, rule.total_series, now, win
                )
                if bad is None or tot_own is None:
                    return None
                if tot_own < rule.min_total:
                    return None
                err = (bad / tot_own) if tot_own > 0 else 0.0
                burns.append(err / (1.0 - rule.objective))
            # both windows must burn: report the SMALLER (the binding
            # one) as the observed value
            return min(burns) > rule.threshold, min(burns)
        if rule.kind == "streak":
            return self._eval_streak(rule, agg, target, now)
        if rule.kind == "stall":
            return self._eval_stall(rule, agg, target, now)
        return None

    def _eval_streak(self, rule, agg, target, now):
        matched = agg.match_series(target, rule.series)
        keys = agg.match_series(target, rule.key_series)
        if not matched or not keys:
            return None
        ser = matched[sorted(matched)[0]]
        key = keys[sorted(keys)[0]]
        pts = ser.window(now, rule.window_s)
        kpts = {t: v for t, v in key.window(now, rule.window_s)}
        if not pts:
            return None
        # scrapes record all of a target's series at the SAME t, so
        # pair by timestamp; count the trailing run of truthy values
        # over DISTINCT key values (one iteration = one vote, however
        # many times it was scraped)
        streak, last_key = 0, None
        for t, v in reversed(pts):
            k = kpts.get(t)
            if k is not None and k == last_key:
                continue
            if v <= 0:
                break
            streak += 1
            last_key = k
        return streak >= rule.streak_n, float(streak)

    def _eval_stall(self, rule, agg, target, now):
        if rule.unless_series:
            u = self._sum_latest(
                agg, target, rule.unless_series, now,
                max(3.0 * rule.window_s, 10.0),
            )
            if u is not None and u > 0:
                return None
        matched = agg.match_series(target, rule.series)
        if not matched:
            return None
        ser = matched[sorted(matched)[0]]
        last_inc = ser.last_increase_t()
        if last_inc is None or ser.span() < rule.window_s:
            # not watched long enough to call anything a stall
            return None
        stalled_for = now - last_inc
        return stalled_for > rule.window_s, stalled_for

    # -- lifecycle ---------------------------------------------------------

    def _transition(self, rule, target, breach, value, now):
        events = []
        with self._lock:
            key = (rule.name, target)
            act = self._act.get(key)
            if act is None:
                act = self._act[key] = _Activation()
            if breach:
                act.breaches += 1
                act.value = value
                if not act.firing and act.breaches >= rule.for_ticks:
                    act.firing = True
                    act.fired_t = now
                    self.firing_total[rule.name] = (
                        self.firing_total.get(rule.name, 0) + 1
                    )
                    events.append({
                        "rule": rule.name, "state": "firing",
                        "target": target,
                        "window_s": float(rule.window_s),
                        "value": float(value),
                        "threshold": float(
                            rule.streak_n if rule.kind == "streak"
                            else rule.threshold
                        ),
                    })
            else:
                act.breaches = 0
                if act.firing:
                    act.firing = False
                    self.resolved_total[rule.name] = (
                        self.resolved_total.get(rule.name, 0) + 1
                    )
                    ev = {
                        "rule": rule.name, "state": "resolved",
                        "target": target,
                        "window_s": float(rule.window_s),
                        "firing_s": max(0.0, now - act.fired_t),
                    }
                    if value is not None:
                        ev["value"] = float(value)
                    events.append(ev)
        return events
