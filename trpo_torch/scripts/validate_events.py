#!/usr/bin/env python
"""Schema-check JSONL run-event files (``trpo_torch.obs.events`` schema).

    python -m trpo_torch.scripts.validate_events FILE [FILE ...]

For each file: every line must parse as JSON and pass
``trpo_torch.obs.events.validate_event`` — including the record
types (``memory`` scope=program/live accounting, the ``status`` endpoint
announcement) and the ``serve`` records (the serving tier's
per-micro-batch requests/padded/queue_depth/latency_ms rows — a
malformed serve record FAILS here, while readers stay warn-and-
tolerate); the first record must be a ``run_manifest`` (files are
self-describing); when per-iteration records are present, each must
carry the device-accumulated solver counters (``cg_iters_total``,
``linesearch_trials_total``) — the acceptance contract; and
every ``fault_injected`` record must be FOLLOWED by a matching
detection/recovery record (the chaos contract: worker kill/hang
→ a ``worker_*`` health event, NaN poison → a ``recovery`` event or nan
health finding, SIGTERM → a ``preempted`` health event — an injected
fault nothing reacted to means the detect→recover loop is broken); and
— — in a fleet log every ``fleet`` record with
``state="preempted"`` must be FOLLOWED by the same member's
``requeued`` or ``failed`` record (a preemption the scheduler never
resolved means the requeue loop is broken; malformed fleet records FAIL
outright via the shared ``validate_event``); and — — in a
router log every ``router`` ``scope="replica"`` record with
``state="died"`` must be FOLLOWED by the same replica's ``restarted``
or ``evicted`` record (a death the replica supervisor never resolved
means the restart-with-backoff loop is broken; malformed
router/session records FAIL outright via the shared
``validate_event``); and — — every ``canary`` record with
``event="started"`` must be FOLLOWED by the same step's ``promoted``
or ``rolled_back`` terminal (an unresolved canary means the gate loop
is broken), and the serving-plane faults (``kill_replica``,
``stall_replica``, ``wedge_reload``, ``drop_carry_journal``) must each
be matched by their detection record (died/evicted for the targeted
replica or a routed retry; ``health:canary_rejected``;
``session:reestablished``); and — — every ``autoscale``
record with ``event="drain_started"`` must be FOLLOWED by the same
replica's ``drain_completed`` or ``drain_aborted`` terminal (a drain
that neither finished nor aborted may have stranded sessions on a
half-retired replica), and the storm faults must each be matched:
``overload_storm`` by a scale/shed reaction (``autoscale``
``scale_out``/``shed``), ``slow_replica`` by a scale/shed reaction OR
the targeted replica's eviction, ``flap_replica`` by the targeted
replica's died/evicted records; and — — every ``lease``
record with ``event="expired"`` must be FOLLOWED by the same
replica's ``died``/``evicted`` resolution or a re-granted lease (an
expiry nothing acted on means the lease-liveness loop is broken),
and the partition faults must each be matched:
``partition_host`` by a lease EXPIRY on the partitioned host AND a
session resumed on a survivor (detection must come from the lease,
and the takeover must be journal-backed), ``slow_network`` by a
scale/shed reaction, the slow host's lease expiry, or an eviction of
one of ITS replicas (host-filtered — unrelated churn must not
satisfy it), ``lost_descriptor`` by a replica death/failure whose
reason names the descriptor (the launch failed LOUDLY — a phantom
``starting`` record is exactly what this matcher would miss); and —
— the request-trace contracts: an ORPHAN span (a non-remote
``parent`` id never emitted in the same file — cross-process parents
are marked ``remote`` and skipped) FAILS, an UNTERMINATED root span
(no parent, not remote, ``dur_ms`` null) FAILS, a ``router``
request record with ``retried=true`` that names its ``trace`` must
have a ``router.retry`` span somewhere in the file (a retried
request whose trace hides the retry defeats the always-trace-
anomalies policy), and — in a log that carries spans at all — a
``partition_host`` fault must be matched by a ``router.takeover``
span (the trace must SHOW the detour the partition forced, not just
the lease bookkeeping); and — — in a log whose dispatch
spans carry wire attrs at all, EVERY ``router.dispatch``/
``router.retry`` span must name ``codec`` (json|binary) and
``transport`` (tcp|uds), so the per-format p99 breakdown attributes
every hop; and — — the replay-complete contracts, in a log
carrying ``replay`` records at all: every act the replayer planned
(``begin.acts``) must be driven, every driven act must have its diff
``verdict`` (same trace + order — an uncompared act cannot be called
bit-exact), and a replay that began must terminate in a ``complete``
record whose act count matches the plan; and — — the
train→serve flywheel contracts: every ``promote`` record with
``event="candidate"`` must be FOLLOWED by the same step's
``promoted``/``rejected``/``rolled_back`` terminal (a stranded
promotion means the controller's crash-convergence loop is broken —
whole-log, so a killed-and-restarted controller that converges
satisfies it), and the boundary faults must each be matched:
``corrupt_checkpoint`` by the torn step's canary/promote rejection
(the failed reload is the detector), ``regress_checkpoint`` by a
rejection whose reason names the *realized return* (only the reward
gate can catch a checkpoint that is fast, finite, and worse at the
task — a p99 or parity rejection does NOT satisfy it),
``kill_promoter`` by a later ``promote`` terminal for the killed step
(the restarted controller re-read journal + markers and converged);
and — — the alert contracts, in a log carrying ``alert``
records at all: (1) every ``fault_injected`` whose kind appears in
``trpo_torch.obs.alerts.FAULT_ALERT_RULES`` and that was injected while
the aggregation plane was ARMED (a ``metric_sample`` within a few
seconds of the fault — faults injected before/without the watcher are
covered by the original recovery contracts, not the alerting one) must
be FOLLOWED by a FIRING ``alert`` of one of that fault's expected
rules; (2) every firing alert must be FOLLOWED by its ``resolved``
record for the same (rule, target) — an alert that never resolves
after the fault window means the rule cannot distinguish recovery, and
a ``resolved`` with no open firing means the lifecycle dedupe is
broken; (3) ZERO FALSE POSITIVES: every firing alert of a known rule
must have a matching cause inside its evaluation window — an injected
fault (extended by the fault's own duration), the reacting control
records (sheds, canary rollbacks, lease expiries, session
reestablishes, unresolved promotions), or ``metric_sample`` evidence
of the breach itself (the series the rule reads, breaching/moving, in
window — the cross-file-safe form of the same cause). A firing alert
with none of these FAILS the run: zero-false-positive is a gated
property, not a hope.
Exits non-zero with per-line diagnostics on any failure; prints a
per-kind count summary on success. Reads a training run's ``--metrics-jsonl`` output and a serving
run's alike (one validator, one schema).

Strictness contract: this validator FAILS on unknown event
kinds and on records stamped with a NEWER schema version — with a
distinct "upgrade the validator" diagnostic for the latter, since a
future writer's log is not corrupt, just unreadable here. READERS go
the other way and warn-and-tolerate (``obs/analyze.load_events`` skips
corrupt records, ``obs/server.StatusSink`` counts unknown kinds): a
pipeline that wants both guarantees runs the validator first.
"""

from __future__ import annotations

import json
import sys
from collections import Counter

_REQUIRED_ITERATION_COUNTERS = ("cg_iters_total", "linesearch_trials_total")


def _fault_matcher(fault_rec: dict):
    """Predicate over later records that counts as the detection/recovery
    response to one injected fault — or None when the fault is a pure
    perturbation (``delay_step``) that nothing is required to react to.
    Takes the whole ``fault_injected`` record: the serving-plane faults
    must be matched by the response to THEIR replica, not
    any replica's."""
    fault_kind = fault_rec.get("fault")
    replica = fault_rec.get("replica")
    if fault_kind in ("kill_worker", "hang_worker"):
        return lambda rec: rec.get("kind") == "health" and str(
            rec.get("check", "")
        ).startswith("worker")
    if fault_kind == "nan_update":
        return lambda rec: rec.get("kind") == "recovery" or (
            rec.get("kind") == "health"
            and rec.get("check") in ("nan_guard", "nan_entropy")
        )
    if fault_kind == "sigterm":
        return lambda rec: (
            rec.get("kind") == "health" and rec.get("check") == "preempted"
        )
    if fault_kind in (
        "kill_replica", "stall_replica", "flap_replica", "slow_replica",
        "overload_storm",
    ):
        # the supervisor (or the router's report_failure) must have
        # declared the targeted replica dead/evicted; a stall shorter
        # than the request timeout may instead surface as the router's
        # transparent retry — either is a detection
        def _replica_dead(rec):
            return (
                rec.get("kind") == "router"
                and rec.get("scope") == "replica"
                and (replica is None or rec.get("replica") == replica)
                and rec.get("state") in ("died", "evicted")
            )

        def _scaled_or_shed(rec):
            # the elastic loop reacted: capacity grew, or
            # the admission layers shed load instead of amplifying
            return rec.get("kind") == "autoscale" and rec.get(
                "event"
            ) in ("scale_out", "shed")

        if fault_kind in ("kill_replica", "flap_replica"):
            return _replica_dead
        if fault_kind == "overload_storm":
            return _scaled_or_shed
        if fault_kind == "slow_replica":
            # a degraded-latency replica is caught either by the
            # metrics (scale/shed) or by the request path (eviction)
            return lambda rec: _scaled_or_shed(rec) or _replica_dead(rec)
        return lambda rec: _replica_dead(rec) or (
            rec.get("kind") == "router"
            and rec.get("scope") == "request"
            and rec.get("retried") is True
        )
    if fault_kind == "wedge_reload":
        # the canary gate is the REQUIRED detector for a checkpoint
        # that loads but answers garbage — for the WEDGED step, not
        # some other step's rejection
        at = fault_rec.get("at")
        return lambda rec: (
            rec.get("kind") == "health"
            and rec.get("check") == "canary_rejected"
            and (rec.get("data") or {}).get("step") == at
        ) or (
            rec.get("kind") == "canary"
            and rec.get("event") == "rolled_back"
            and rec.get("step") == at
        )
    if fault_kind == "corrupt_checkpoint":
        # a checkpoint torn AFTER its completion marker landed: the
        # marker protocol cannot see it, so the REQUIRED detector is
        # the canary's failed reload — a canary/health rejection for
        # the torn step, or the promotion controller's own terminal
        # rejection of it
        at = fault_rec.get("at")
        return lambda rec: (
            rec.get("kind") == "health"
            and rec.get("check") == "canary_rejected"
            and (rec.get("data") or {}).get("step") == at
        ) or (
            rec.get("kind") == "canary"
            and rec.get("event") == "rolled_back"
            and rec.get("step") == at
        ) or (
            rec.get("kind") == "promote"
            and rec.get("event") in ("rejected", "rolled_back")
            and rec.get("step") == at
        )
    if fault_kind == "regress_checkpoint":
        # loads cleanly, answers fast and finite, scores WORSE: only
        # the reward gate can catch it, so the rejection reason must
        # name the realized return — a p99 or parity rejection of the
        # same step would mean some other gate fired on noise while
        # the regression itself went undetected
        at = fault_rec.get("at")
        return lambda rec: (
            rec.get("kind") == "canary"
            and rec.get("event") == "rolled_back"
            and rec.get("step") == at
            and "realized return" in str(rec.get("reason", ""))
        ) or (
            rec.get("kind") == "health"
            and rec.get("check") == "canary_rejected"
            and (rec.get("data") or {}).get("step") == at
            and "realized return" in str(rec.get("message", ""))
        )
    if fault_kind == "kill_promoter":
        # the controller died after publish, before the gate: the
        # detection is CONVERGENCE — a later promote terminal for the
        # killed step proves a restarted controller re-read the
        # journal + markers and finished the promotion either way
        at = fault_rec.get("at")
        return lambda rec: (
            rec.get("kind") == "promote"
            and rec.get("event") in ("promoted", "rejected", "rolled_back")
            and rec.get("step") == at
        )
    if fault_kind in ("partition_host", "slow_network"):
        host = fault_rec.get("host")

        def _lease_expired(rec):
            return (
                rec.get("kind") == "lease"
                and rec.get("event") == "expired"
                and (host is None or rec.get("host") == host)
            )

        if fault_kind == "partition_host":
            # detection MUST come from lease expiry on the partitioned
            # host (a failed poll proves nothing across a partition);
            # the session-resumed half of the pairing is enforced by a
            # dedicated check in validate_file (a single-predicate
            # matcher cannot require two distinct records)
            return _lease_expired
        # slow_network: the metrics reacted (scale/shed), the slow
        # host's lease starved out, or one of ITS replicas was
        # evicted — host-filtered, or any chaos run's unrelated churn
        # (a retried request, some other replica's death) would
        # satisfy the matcher vacuously
        return lambda rec: (
            _lease_expired(rec)
            or (
                rec.get("kind") == "autoscale"
                and rec.get("event") in ("scale_out", "shed")
            )
            or (
                rec.get("kind") == "router"
                and rec.get("scope") == "replica"
                and rec.get("state") in ("died", "evicted")
                and (host is None or rec.get("host") == host)
            )
        )
    if fault_kind == "lost_descriptor":
        # the launch must fail LOUDLY: a died/failed record naming the
        # descriptor — never a phantom `starting` record
        return lambda rec: (
            rec.get("kind") == "router"
            and rec.get("scope") == "replica"
            and rec.get("state") in ("died", "failed")
            and "descriptor" in str(rec.get("reason", ""))
        )
    if fault_kind == "drop_carry_journal":
        # losing the journal must surface as the loud fresh-carry
        # fallback, never as a silent wrong resume. (The reestablished
        # record names the SURVIVOR replica, not the dropped journal's
        # owner, so no replica-level pairing is possible here.)
        return lambda rec: (
            rec.get("kind") == "session"
            and rec.get("event") == "reestablished"
        )
    return None


# alert-contract tolerances. An aggregation plane counts as
# ARMED at an instant when a metric_sample landed AT OR BEFORE it,
# within this many seconds (the fault→alert contract only binds faults
# injected while someone was ALREADY watching — a plane that starts
# scraping moments after an earlier leg's fault never saw the
# incident's onset and must not be held to have paged on it; such
# faults are covered by the recovery contracts above).
_ALERT_ARMED_SLACK_S = 5.0
# a firing alert's cause may land slightly AFTER the alert record (the
# engine reads live counters; the aggregated event describing the same
# thing can flush a beat later) ...
_ALERT_FWD_SLACK_S = 5.0
# ... and may precede it by the evaluation window plus this much: the
# slo_p99 series is a ~10s time-expiring window, so the latency that
# fired it can be that much older than the firing record.
_ALERT_LOOKBACK_EXTRA_S = 15.0

# fault kinds whose injection plausibly explains each rule firing
# (beyond FAULT_ALERT_RULES, which is the DETECTION requirement; this
# is the EXCUSE direction, so it is broader — e.g. a kill_replica may
# legitimately spike p99 without being required to page)
_ALERT_CAUSE_FAULTS = {
    "slo_p99": (
        "overload_storm", "slow_replica", "slow_network",
        "stall_replica", "flap_replica", "kill_replica",
        "partition_host",
    ),
    "shed_rate": (
        "overload_storm", "slow_replica", "slow_network",
        "stall_replica",
    ),
    "canary_rejected": (
        "wedge_reload", "corrupt_checkpoint", "regress_checkpoint",
    ),
    "lease_expired": ("partition_host", "slow_network"),
    "target_stale": (
        "partition_host", "slow_network", "kill_replica",
        "flap_replica", "stall_replica", "slow_replica",
        "kill_promoter", "overload_storm", "sigterm",
    ),
}


def _alert_cause_ok(firing: dict, records: list) -> bool:
    """True when a firing alert has a matching cause in its window —
    the zero-false-positive contract. ``records`` is the whole file's
    ``(line, rec)`` list. Unknown rule names return True (custom rules
    carry no cause contract here; the lifecycle pairing still binds
    them)."""
    import fnmatch as _fn

    rule = firing.get("rule")
    t0 = float(firing.get("t") or 0.0)
    win = float(firing.get("window_s") or 0.0)
    thr = float(firing.get("threshold") or 0.0)
    target = firing.get("target")
    lo = t0 - win - _ALERT_LOOKBACK_EXTRA_S
    hi = t0 + _ALERT_FWD_SLACK_S

    def in_win(rec):
        return lo <= float(rec.get("t") or 0.0) <= hi

    def fault_cause():
        for _, rec in records:
            if (
                rec.get("kind") != "fault_injected"
                or rec.get("fault") not in _ALERT_CAUSE_FAULTS.get(
                    rule, ()
                )
            ):
                continue
            t = float(rec.get("t") or 0.0)
            dur = rec.get("seconds")
            dur = float(dur) if isinstance(dur, (int, float)) else 0.0
            # the fault's EFFECT persists for its duration plus the
            # rule's lookback — a 15s storm legitimately explains a
            # p99 alert firing near its end
            if t <= hi and t0 <= t + dur + win + _ALERT_LOOKBACK_EXTRA_S:
                return True
        return False

    def sample_pts(series_pats):
        """(t, series, value) metric_samples for THIS alert's target
        matching the rule's series globs, inside the cause window."""
        out = []
        for _, rec in records:
            if rec.get("kind") != "metric_sample" or not in_win(rec):
                continue
            if target and rec.get("target") != target:
                continue
            s = rec.get("series") or ""
            v = rec.get("value")
            if v is None or not any(
                _fn.fnmatch(s, p) for p in series_pats
            ):
                continue
            out.append((float(rec.get("t") or 0.0), s, float(v)))
        return out

    def sample_breach(series_pats, pred):
        return any(pred(v) for _, _, v in sample_pts(series_pats))

    def counter_moved(series_pats):
        per = {}
        for t, s, v in sample_pts(series_pats):
            per.setdefault(s, []).append((t, v))
        for pts in per.values():
            pts.sort()
            if any(b > a for (_, a), (_, b) in zip(pts, pts[1:])):
                return True
        return False

    def any_rec(pred):
        return any(pred(rec) for _, rec in records if in_win(rec))

    if rule == "slo_p99":
        return (
            fault_cause()
            or any_rec(
                lambda r: r.get("kind") == "router"
                and r.get("scope") == "request"
                and isinstance(r.get("ms"), (int, float))
                and r.get("ms") >= thr
            )
            or any_rec(lambda r: r.get("kind") == "autoscale")
            or sample_breach(
                ("status.latency_recent_ms*",), lambda v: v > thr
            )
        )
    if rule == "shed_rate":
        return (
            fault_cause()
            or any_rec(
                lambda r: r.get("kind") == "autoscale"
                and r.get("event") == "shed"
            )
            or counter_moved(
                (
                    "status.counters.shed_*_total",
                    "status.counters.backpressure_total",
                )
            )
        )
    if rule == "resumed_fraction":
        return (
            any_rec(
                lambda r: r.get("kind") == "session"
                and r.get("event") == "reestablished"
            )
            or counter_moved(
                ("status.counters.sessions_reestablished_total",)
            )
        )
    if rule == "canary_rejected":
        return (
            fault_cause()
            or any_rec(
                lambda r: (
                    r.get("kind") == "canary"
                    and r.get("event") == "rolled_back"
                )
                or (
                    r.get("kind") == "promote"
                    and r.get("event") in ("rejected", "rolled_back")
                )
                or (
                    r.get("kind") == "health"
                    and r.get("check") == "canary_rejected"
                )
            )
            or counter_moved(
                ("*rolled_back_total*", "*canary_rejected*")
            )
        )
    if rule == "lease_expired":
        return (
            fault_cause()
            or any_rec(
                lambda r: r.get("kind") == "lease"
                and r.get("event") == "expired"
            )
            or counter_moved(("*lease*expired*",))
        )
    if rule == "dropped_events":
        # the cause IS the drop: the watched *_dropped_total series
        # must show movement (or a nonzero level) in window
        return counter_moved(("*dropped_total*",)) or sample_breach(
            ("*dropped_total*",), lambda v: v > 0
        )
    if rule == "kl_rollback_streak":
        return (
            any_rec(
                lambda r: r.get("kind") == "health"
                and r.get("check") == "kl_rollback_streak"
            )
            or any_rec(
                lambda r: r.get("kind") == "iteration"
                and (r.get("stats") or {}).get("kl_rolled_back")
            )
            or sample_breach(
                ("status.stats.kl_rolled_back",), lambda v: v > 0
            )
        )
    if rule == "promoter_stuck":
        # cause = a promotion genuinely unresolved AT FIRING TIME: a
        # candidate/canary promote record before the firing whose
        # same-(member, step) terminal had not yet landed
        def _unresolved_promotion():
            for _, rec in records:
                if (
                    rec.get("kind") != "promote"
                    or rec.get("event") not in ("candidate", "canary")
                    or float(rec.get("t") or 0.0) > hi
                ):
                    continue
                member, step = rec.get("member"), rec.get("step")
                settled = any(
                    r.get("kind") == "promote"
                    and r.get("member") == member
                    and r.get("step") == step
                    and r.get("event")
                    in ("promoted", "rejected", "rolled_back")
                    and float(r.get("t") or 0.0)
                    <= t0 + _ALERT_FWD_SLACK_S
                    for _, r in records
                )
                if not settled:
                    return True
            return False

        return _unresolved_promotion() or sample_breach(
            ("promote.unconverged_s",), lambda v: v > thr
        )
    if rule == "target_stale":
        return (
            fault_cause()
            or any_rec(
                lambda r: r.get("kind") == "router"
                and r.get("scope") == "replica"
                and r.get("state") in ("died", "evicted", "failed")
            )
            or any_rec(
                lambda r: r.get("kind") == "fleet"
                and r.get("state")
                in ("preempted", "failed", "culled", "finished")
            )
            or sample_breach(("up",), lambda v: v < 1)
        )
    if rule == "fleet_stall":
        # absence-of-progress is its own evidence: the firing record
        # carries how long the iteration series sat still; there is no
        # event a NON-progressing member would have written
        return True
    return True


def validate_file(path: str) -> list:
    """Returns a list of error strings (empty = valid)."""
    from trpo_torch.obs.events import SCHEMA_VERSION, validate_event

    errs = []
    records = []
    try:
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if not line.strip():
                    errs.append(f"{path}:{n}: blank line")
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    errs.append(f"{path}:{n}: not JSON ({e})")
                    continue
                v = rec.get("v") if isinstance(rec, dict) else None
                if (
                    isinstance(v, int)
                    and not isinstance(v, bool)
                    and v > SCHEMA_VERSION
                ):
                    # a future writer's log: distinct diagnostic (not
                    # corrupt data — THIS validator is too old), and no
                    # per-field pile-on from a schema we cannot know
                    errs.append(
                        f"{path}:{n}: newer schema version v={v} (this "
                        f"validator knows v{SCHEMA_VERSION}) — upgrade "
                        "the validator, do not trust partial checks"
                    )
                    continue
                for e in validate_event(rec):
                    errs.append(f"{path}:{n}: {e}")
                records.append((n, rec))
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    if not records:
        errs.append(f"{path}: no records")
        return errs
    if records[0][1].get("kind") != "run_manifest":
        errs.append(
            f"{path}:1: first record must be a run_manifest "
            f"(got {records[0][1].get('kind')!r})"
        )
    for n, rec in records:
        if rec.get("kind") != "iteration":
            continue
        stats = rec.get("stats") or {}
        for key in _REQUIRED_ITERATION_COUNTERS:
            if key not in stats:
                errs.append(
                    f"{path}:{n}: iteration event missing "
                    f"device-accumulated counter {key!r}"
                )
    # whether this log carries request-trace spans at all:
    # computed ONCE — the partition-takeover matcher below and the
    # per-span contracts further down share it
    has_spans = any(rec.get("kind") == "span" for _, rec in records)
    # chaos contract: every injected fault must have produced a
    # matching detection/recovery record later in the stream
    for idx, (n, rec) in enumerate(records):
        if rec.get("kind") != "fault_injected":
            continue
        matcher = _fault_matcher(rec)
        if matcher is None:
            continue
        if not any(matcher(later) for _, later in records[idx + 1:]):
            errs.append(
                f"{path}:{n}: fault_injected ({rec.get('spec')}) has no "
                "matching detection/recovery record after it"
            )
        if rec.get("fault") == "partition_host":
            # the second half of the partition pairing: the
            # lease-evicted host's sessions must have RESUMED on a
            # survivor from the carry journal — a partition whose
            # takeover was not journal-backed lost state silently
            if not any(
                later.get("kind") == "session"
                and later.get("event") == "resumed"
                for _, later in records[idx + 1:]
            ):
                errs.append(
                    f"{path}:{n}: fault_injected ({rec.get('spec')}) "
                    "has no session:resumed record after it — the "
                    "partitioned host's sessions never resumed on a "
                    "survivor"
                )
            # the trace half: in a log that carries spans
            # at all (the trace layer was armed — chaos requests are
            # always sampled), the detour itself must be visible as a
            # router.takeover span, not just lease bookkeeping
            if has_spans and not any(
                later.get("kind") == "span"
                and later.get("name") == "router.takeover"
                for _, later in records[idx + 1:]
            ):
                errs.append(
                    f"{path}:{n}: fault_injected ({rec.get('spec')}) "
                    "in a traced log with no router.takeover span "
                    "after it — no trace shows the partition's detour"
                )
    # solver-precision contract (same pattern as the
    # fault-matching rule): a rise in the run-cumulative `fallbacks`
    # counter means an audit failed and the update fell back — the
    # health monitor MUST have recorded a matching health:solve_fallback
    # after that iteration row; a silent fallback means the
    # detect→report loop is broken.
    # Gated on the log showing the monitor RAN at all (any health
    # record): the fallbacks counter is emitted whenever the ladder is
    # armed, but health records only exist under --health-checks — a
    # run without the opt-in monitor has a valid log with no pairing to
    # enforce. Baseline 0, matching the monitor: the counter starts at
    # 0 (trpo.init_ladder), so a first-row fallback is a rise too — and
    # a resumed log's carried-over total is re-reported by the
    # monitor's own 0-baseline, keeping the pairing satisfiable there.
    monitor_ran = any(rec.get("kind") == "health" for _, rec in records)
    prev_fb = 0
    for idx, (n, rec) in enumerate(records):
        if not monitor_ran:
            break
        if rec.get("kind") != "iteration":
            continue
        fb = (rec.get("stats") or {}).get("fallbacks")
        if not isinstance(fb, int) or isinstance(fb, bool):
            continue
        if fb > prev_fb:
            if not any(
                later.get("kind") == "health"
                and later.get("check") == "solve_fallback"
                for _, later in records[idx + 1:]
            ):
                errs.append(
                    f"{path}:{n}: solve fallback count rose "
                    f"({prev_fb} -> {fb}) with no matching "
                    "health:solve_fallback record after it"
                )
        prev_fb = fb
    # fleet contract (same pattern as the fault-matching rule):
    # a preempted member the scheduler never requeued or failed is a
    # broken requeue loop, not a valid log
    for idx, (n, rec) in enumerate(records):
        if rec.get("kind") != "fleet" or rec.get("state") != "preempted":
            continue
        member = rec.get("member")
        if not any(
            later.get("kind") == "fleet"
            and later.get("member") == member
            and later.get("state") in ("requeued", "failed", "finished")
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: fleet member {member!r} preempted with no "
                "matching requeued/failed terminal record after it"
            )
    # router contract (same pattern): a replica that died with
    # no later restarted/evicted record means the supervisor's
    # restart-with-backoff loop is broken, not a valid log
    for idx, (n, rec) in enumerate(records):
        if (
            rec.get("kind") != "router"
            or rec.get("scope") != "replica"
            or rec.get("state") != "died"
        ):
            continue
        replica = rec.get("replica")
        if not any(
            later.get("kind") == "router"
            and later.get("scope") == "replica"
            and later.get("replica") == replica
            and later.get("state") in ("restarted", "evicted")
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: router replica {replica!r} died with no "
                "matching restarted/evicted resolution record after it"
            )
    # canary contract (the fleet `preempted` pattern): a
    # canary that started with no later promoted/rolled_back terminal
    # for the same step means the gate loop is broken — an unvalidated
    # checkpoint left wearing live traffic is not a valid log
    for idx, (n, rec) in enumerate(records):
        if rec.get("kind") != "canary" or rec.get("event") != "started":
            continue
        step = rec.get("step")
        if not any(
            later.get("kind") == "canary"
            and later.get("step") == step
            and later.get("event") in ("promoted", "rolled_back")
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: canary for step {step} started with no "
                "matching promoted/rolled_back terminal record after it"
            )
    # flywheel contract (the canary `started` pattern, but
    # whole-log on BOTH sides): a promote candidate with no terminal
    # for the same serving step means the promotion controller's
    # crash-convergence loop is broken — a kill_promoter run satisfies
    # it precisely because the restarted controller's terminal lands
    # later in the same log
    for idx, (n, rec) in enumerate(records):
        if rec.get("kind") != "promote" or rec.get("event") != "candidate":
            continue
        step = rec.get("step")
        if not any(
            later.get("kind") == "promote"
            and later.get("step") == step
            and later.get("event") in (
                "promoted", "rejected", "rolled_back"
            )
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: promote candidate for serving step {step} "
                "has no matching promoted/rejected/rolled_back terminal "
                "record after it — a stranded promotion"
            )
    # lease contract (the replica `died` pattern): an expired
    # lease the supervisor neither evicted on nor re-granted means the
    # lease-liveness loop is broken — a partitioned host's replicas
    # would hold their rotation slots (and their sessions) forever
    for idx, (n, rec) in enumerate(records):
        if rec.get("kind") != "lease" or rec.get("event") != "expired":
            continue
        replica = rec.get("replica")
        if not any(
            (
                later.get("kind") == "router"
                and later.get("scope") == "replica"
                and later.get("replica") == replica
                and later.get("state") in ("died", "evicted")
            )
            or (
                later.get("kind") == "lease"
                and later.get("replica") == replica
                and later.get("event") == "granted"
            )
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: lease for replica {replica!r} expired "
                "with no matching died/evicted resolution (or "
                "re-granted lease) record after it"
            )
    # trace contracts. (1) orphan span: a non-remote parent id
    # never emitted in THIS file means the emitter lost a span (or
    # forgot the remote mark on a cross-process edge) — the assembled
    # tree would silently dangle. (2) unterminated root: dur_ms null on
    # a root span means a request's trace was flushed without its edge
    # ever ending — the end-to-end number every breakdown divides by is
    # missing. Spans flush through a write-behind writer, so parents
    # may land AFTER children — both checks are whole-file, not ordered.
    span_ids = {
        rec.get("span") for _, rec in records
        if rec.get("kind") == "span"
    }
    for n, rec in records:
        if rec.get("kind") != "span":
            continue
        parent = rec.get("parent")
        if (
            parent is not None
            and not rec.get("remote")
            and parent not in span_ids
        ):
            errs.append(
                f"{path}:{n}: orphan span {rec.get('span')!r} "
                f"({rec.get('name')}): parent {parent!r} never emitted "
                "in this file (cross-process parents must be marked "
                "remote)"
            )
        if (
            parent is None
            and not rec.get("remote")
            and rec.get("dur_ms") is None
        ):
            errs.append(
                f"{path}:{n}: unterminated root span "
                f"{rec.get('span')!r} ({rec.get('name')}): the trace "
                "was flushed without its edge span ever ending"
            )
    # data-plane contract: every dispatch hop span names its
    # wire format — `codec` in {json, binary} and `transport` in
    # {tcp, uds} — so the per-format p99 breakdown (analyze.py `wire`
    # table) attributes every hop instead of silently bucketing
    # unlabeled ones. Enforced only on logs whose router emits the
    # attrs at all (any hop span carrying `codec`): a pre-wire-codec log
    # stays valid, a current log with a half-labeled hop does not.
    _hop_spans = [
        (n, rec) for n, rec in records
        if rec.get("kind") == "span"
        and rec.get("name") in ("router.dispatch", "router.retry")
    ]
    if any("codec" in rec for _, rec in _hop_spans):
        for n, rec in _hop_spans:
            codec = rec.get("codec")
            transport = rec.get("transport")
            if codec not in ("json", "binary"):
                errs.append(
                    f"{path}:{n}: dispatch span {rec.get('span')!r} "
                    f"({rec.get('name')}) has codec {codec!r} — every "
                    "hop must name json or binary"
                )
            if transport not in ("tcp", "uds"):
                errs.append(
                    f"{path}:{n}: dispatch span {rec.get('span')!r} "
                    f"({rec.get('name')}) has transport {transport!r} "
                    "— every hop must name tcp or uds"
                )
    # overlapped-training contract: a run whose training root
    # span declares overlap (train/run with overlap truthy) must PROVE
    # it pipelined — at least one rollout-chunk span's wall-clock
    # interval must intersect an update span's interval (rollout k+1
    # streaming while update k runs). A log with the overlap claim but
    # strictly sequential spans is not a valid overlapped-run log; a
    # synchronous-run log (no overlap root) is untouched. Enforced
    # per overlap trace id, whole-file (spans flush out of order).
    _overlap_roots = {
        rec.get("trace") for _, rec in records
        if rec.get("kind") == "span"
        and rec.get("name") == "train/run"
        and rec.get("overlap")
    }
    for tid in _overlap_roots:
        _iv = lambda rec: (
            rec["start"], rec["start"] + (rec.get("dur_ms") or 0.0) / 1e3
        )
        chunks = [
            _iv(rec) for _, rec in records
            if rec.get("kind") == "span" and rec.get("trace") == tid
            and rec.get("name") == "train/rollout_chunk"
            and isinstance(rec.get("start"), (int, float))
        ]
        updates = [
            _iv(rec) for _, rec in records
            if rec.get("kind") == "span" and rec.get("trace") == tid
            and rec.get("name") == "train/update"
            and isinstance(rec.get("start"), (int, float))
        ]
        if not chunks or not updates:
            errs.append(
                f"{path}: overlapped training trace {tid!r} is missing "
                f"{'rollout-chunk' if not chunks else 'update'} spans — "
                "the pipeline's stages were not traced"
            )
            continue
        if not any(
            c0 < u1 and u0 < c1
            for (c0, c1) in chunks
            for (u0, u1) in updates
        ):
            errs.append(
                f"{path}: overlapped training trace {tid!r} has no "
                "rollout-chunk span overlapping an update span — the "
                "run claims overlap (train/run overlap=1) but its "
                "waterfall is strictly sequential"
            )
    # (3) a retried request that names its trace must have the retry
    # visible IN that trace — anomalies are always-sampled precisely so
    # the trace shows what the latency bought
    if has_spans:
        retry_traces = {
            rec.get("trace") for _, rec in records
            if rec.get("kind") == "span"
            and rec.get("name") == "router.retry"
        }
        for n, rec in records:
            if (
                rec.get("kind") == "router"
                and rec.get("scope") == "request"
                and rec.get("retried") is True
                and isinstance(rec.get("trace"), str)
                and rec["trace"] not in retry_traces
            ):
                errs.append(
                    f"{path}:{n}: retried request's trace "
                    f"{rec['trace']!r} has no router.retry span in "
                    "this file — the trace hides the retry"
                )
    # replay-complete contracts, gated on the log carrying
    # replay records at all: (1) every captured act the replayer
    # planned (begin.acts) was actually driven — a replay that silently
    # answered fewer acts than it promised replayed a DIFFERENT
    # incident; (2) every driven act has its diff verdict — an act
    # without a verdict was never compared, and "bit-exact" cannot be
    # claimed over uncompared acts; (3) a replay that began must have
    # its complete record, whose act count matches the plan.
    replay_recs = [
        (n, rec) for n, rec in records if rec.get("kind") == "replay"
    ]
    if replay_recs:
        begins = [
            (n, rec) for n, rec in replay_recs
            if rec.get("event") == "begin"
        ]
        completes = [
            (n, rec) for n, rec in replay_recs
            if rec.get("event") == "complete"
        ]
        acts = [
            (n, rec) for n, rec in replay_recs
            if rec.get("event") == "act"
        ]
        verdict_keys = {
            (rec.get("trace"), rec.get("order"))
            for _, rec in replay_recs
            if rec.get("event") == "verdict"
        }
        planned = sum(rec.get("acts", 0) for _, rec in begins)
        if len(acts) != planned:
            errs.append(
                f"{path}: replay drove {len(acts)} act(s) but "
                f"planned {planned} (begin.acts) — the replayed "
                "request set is not the captured one"
            )
        for n, rec in acts:
            if (rec.get("trace"), rec.get("order")) not in verdict_keys:
                errs.append(
                    f"{path}:{n}: replayed act trace "
                    f"{rec.get('trace')!r} order {rec.get('order')} "
                    "has no diff verdict — the act was driven but "
                    "never compared"
                )
        if begins and not completes:
            errs.append(
                f"{path}: replay began but never emitted its "
                "complete record — the diff summary is missing"
            )
        for n, rec in completes:
            if rec.get("acts") != planned:
                errs.append(
                    f"{path}:{n}: replay complete counts "
                    f"{rec.get('acts')} act(s) but the plan was "
                    f"{planned}"
                )
    # drain contract (the canary `started` pattern): a drain
    # that started with no later same-replica completed/aborted
    # terminal may have stranded sessions on a half-retired replica —
    # not a valid log
    for idx, (n, rec) in enumerate(records):
        if (
            rec.get("kind") != "autoscale"
            or rec.get("event") != "drain_started"
        ):
            continue
        replica = rec.get("replica")
        if not any(
            later.get("kind") == "autoscale"
            and later.get("replica") == replica
            and later.get("event") in ("drain_completed", "drain_aborted")
            for _, later in records[idx + 1:]
        ):
            errs.append(
                f"{path}:{n}: autoscale drain of replica {replica!r} "
                "started with no matching drain_completed/drain_aborted "
                "terminal record after it"
            )
    # alert contracts, gated on the log carrying alert
    # records at all (a run without the aggregation plane armed owes
    # nothing here — the recovery contracts above still bind it).
    alert_recs = [
        (n, rec) for n, rec in records if rec.get("kind") == "alert"
    ]
    if alert_recs:
        import bisect

        from trpo_torch.obs.alerts import FAULT_ALERT_RULES

        sample_ts = sorted(
            float(rec.get("t") or 0.0)
            for _, rec in records
            if rec.get("kind") == "metric_sample"
        )

        def _armed_at(t):
            i = bisect.bisect_left(
                sample_ts, t - _ALERT_ARMED_SLACK_S
            )
            return i < len(sample_ts) and sample_ts[i] <= t

        firing_recs = [
            (n, rec) for n, rec in alert_recs
            if rec.get("state") == "firing"
        ]
        # (1) fault → firing alert: an armed chaos fault of an
        # alert-covered kind that no rule paged on means the alerting
        # layer missed an incident the injector PROVED happened
        for n, rec in records:
            if rec.get("kind") != "fault_injected":
                continue
            expected = FAULT_ALERT_RULES.get(rec.get("fault"))
            t = float(rec.get("t") or 0.0)
            if not expected or not _armed_at(t):
                continue
            if not any(
                fr.get("rule") in expected
                and float(fr.get("t") or 0.0) >= t - 0.5
                for _, fr in firing_recs
            ):
                errs.append(
                    f"{path}:{n}: armed fault_injected "
                    f"({rec.get('spec')}) was never matched by a "
                    f"firing alert of {'/'.join(expected)} — the "
                    "alerting layer missed a proven incident"
                )
        # (2) firing/resolved lifecycle pairing per (rule, target):
        # the canary started→terminal pattern. A resolved with no
        # open firing also fails — it means the engine's dedupe or
        # state machine double-transitioned.
        open_firing = {}
        for n, rec in alert_recs:
            key = (rec.get("rule"), rec.get("target"))
            if rec.get("state") == "firing":
                if key in open_firing:
                    errs.append(
                        f"{path}:{n}: alert {key[0]!r} on "
                        f"{key[1]!r} fired again without resolving "
                        f"(previous firing at line "
                        f"{open_firing[key]}) — lifecycle dedupe "
                        "broken"
                    )
                open_firing[key] = n
            elif rec.get("state") == "resolved":
                if key not in open_firing:
                    errs.append(
                        f"{path}:{n}: alert {key[0]!r} on "
                        f"{key[1]!r} resolved without a matching "
                        "open firing record"
                    )
                open_firing.pop(key, None)
        for (rule, target), n in sorted(open_firing.items()):
            errs.append(
                f"{path}:{n}: alert {rule!r} on {target!r} fired "
                "and never resolved — the rule cannot distinguish "
                "recovery from the incident"
            )
        # (3) zero false positives: every firing alert of a known
        # rule needs a matching cause inside its window
        for n, rec in firing_recs:
            if not _alert_cause_ok(rec, records):
                errs.append(
                    f"{path}:{n}: alert {rec.get('rule')!r} on "
                    f"{rec.get('target')!r} fired (value "
                    f"{rec.get('value')!r} vs threshold "
                    f"{rec.get('threshold')!r}) with NO matching "
                    "cause in its window — false positive"
                )
    return errs


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        errs = validate_file(path)
        if errs:
            failed = True
            for e in errs[:50]:
                print(f"INVALID  {e}", file=sys.stderr)
            if len(errs) > 50:
                print(f"... and {len(errs) - 50} more", file=sys.stderr)
        else:
            with open(path) as f:
                kinds = Counter(
                    json.loads(line).get("kind") for line in f if line.strip()
                )
            summary = ", ".join(f"{k}={v}" for k, v in sorted(kinds.items()))
            print(f"OK       {path} ({summary})")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
