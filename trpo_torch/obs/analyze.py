"""Cross-run analysis over event JSONL: summarize one run, diff two
(counterpart: ``trpo_tpu/obs/analyze.py``; the summary keys are the
reference's, and the manifest block adds the port's ``torch_version``,
``cuda_version`` and ``device_name``).

The event stream (``obs/events.py``) made every run self-describing;
this module makes it machine-checkable. One file → a run report:
per-phase time table, throughput, health/recompile summary, peak-memory
report. Two files → per-phase and per-metric regression verdicts with a
threshold — the engine behind ``python -m trpo_torch.scripts.analyze_run
--compare``, the perf-regression gate.

Reader tolerance vs validator strictness: :func:`load_events` is a
READER — it skips a mid-file corrupt record (crash-torn, disk bit rot)
with a ``warnings.warn`` and keeps going, and it tolerates record kinds
it does not know (a newer writer's log still summarizes). The STRICT
side is ``scripts/validate_events``, which fails on unknown kinds and
newer schema versions; a pipeline that wants both runs the validator
first.

Comparison semantics (:func:`compare_runs`):

* time-like metrics (phase mean ms, steady iteration ms) regress when
  ``new > base × (1 + threshold_pct/100)``;
* rate-like metrics (timesteps/s) regress when
  ``new < base ÷ (1 + threshold_pct/100)``;
* byte-like metrics (program temp/peak bytes, live-buffer peak) regress
  when they GROW past the threshold — an HBM regression OOMs the
  flagship shape as surely as a slowdown misses the deadline;
* serving runs (``serve`` events) are judged by the same rules: latency
  p50/p99 (overall and per padded rung) are time-like, actions/s is
  rate-like — the SLO gate; the rows appear only when at least
  one run actually served;
* replicated-serving runs (``router`` events) likewise:
  router p50/p99 time-like, routed actions/s rate-like, rows only when
  a run actually routed; the single-run summary adds the per-replica
  table, the scaling/balance row, and the session lifecycle counts;
* failover quality: sessions resumed from a journaled carry
  vs restarted fresh (``resumed_fraction`` rate-like — losing lossless
  failover is a regression) plus carry-journal lag, and canary
  deployment verdicts (``rolled_back`` is a strict counter — any rise
  between clean runs means a checkpoint failed its gate);
* elastic serving (``autoscale`` events): scale events,
  drain durations + sessions moved, shed counts by reason;
  ``drain_aborted`` is a strict counter (a drain that could not move
  its sessions losslessly is never noise), drain duration time-like,
  shed totals grow-is-worse;
* multi-host liveness (``lease`` + ``router scope="host"``
  events): the per-host replica table, lease grant/renew/expire
  counts, fenced journal-write refusals, and injected partition
  durations; ``lease_expired`` and ``fenced_write_refused`` are
  strict counters between clean runs — a lease expiring (or a
  split-brain writer being refused) where the base run had none is a
  liveness event, never noise;
* request traces (``span`` events from ``obs/trace.py``):
  :func:`assemble_traces` joins spans across per-process event logs
  (router + N replicas — merge the files' records first),
  :func:`trace_breakdown` attributes each trace's end-to-end time to
  stages (queue / epoch / engine / network / journal / retry /
  takeover — network is structural: each router hop minus the remote
  handler time nested under it), the summary carries the per-stage
  p50/p99 + share table and the slowest-trace rows, and
  ``compare_runs`` judges the root p99 and every per-stage p99
  time-like — a grown stage is a LOCATED regression;
* alerting-plane runs (``alert`` + ``metric_sample`` events
  from ``obs/aggregate.py`` + ``obs/alerts.py``): the per-rule
  fired/resolved/active table with time-to-detect against the log's
  injected faults; ``false_positives`` (a firing in a provably quiet
  phase — no fault at all in the 120 s before it) is a strict counter
  between clean runs, time-to-detect is time-like, and per-rule fired
  counts grow-is-worse;
* phases below ``min_ms`` in BOTH runs are skipped (a 0.1 ms phase
  doubling is scheduler noise, not a regression), as are metrics absent
  from either run (no silent verdict about unmeasured things — they are
  reported as ``skipped``).

The steady iteration time drops each run *segment*'s FIRST iteration
row when more than two rows exist: the first row after every
``run_manifest`` carries XLA compilation — and a resumed/requeued
member (the fleet orchestrator appends the resumed run to the
SAME event file) has one such compile-laden row per segment, which
would otherwise dominate short gate runs and hide real regressions.

Fleet logs (``fleet`` lifecycle records from ``fleet/scheduler.py``)
get their own summary block: per-member last state / attempts /
requeues plus state totals — so ``analyze_run.py`` on a fleet's event
log reads as a fleet report.
"""

from __future__ import annotations

import json
import math
import warnings
from collections import Counter
from typing import Optional

__all__ = [
    "load_events",
    "summarize_run",
    "compare_runs",
    "format_table",
    "assemble_traces",
    "trace_breakdown",
    "render_waterfall",
]


def load_events(path: str) -> list:
    """Parse one event-JSONL file, tolerantly: corrupt lines are skipped
    with a ``UserWarning`` naming the line, blank lines are ignored,
    unknown kinds pass through. Raises ``OSError`` for an unreadable
    file — no events at all is the caller's verdict to make."""
    records = []
    # errors="replace": a non-UTF8 byte (binary garbage, torn gzip) must
    # corrupt THAT line's parse, not abort the whole read — the mangled
    # line then warns-and-skips like any other corrupt record
    with open(path, errors="replace") as f:
        for n, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                warnings.warn(
                    f"{path}:{n}: skipping corrupt record ({e})"
                )
                continue
            if not isinstance(rec, dict):
                warnings.warn(
                    f"{path}:{n}: skipping non-object record"
                )
                continue
            records.append(rec)
    return records


def _finite(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if math.isfinite(v) else None


def _mean(vals: list) -> Optional[float]:
    vals = [v for v in (_finite(v) for v in vals) if v is not None]
    return sum(vals) / len(vals) if vals else None


def _quantile(vals: list, q: float) -> Optional[float]:
    """Nearest-rank quantile over the finite values (None when empty) —
    the shared estimator (``utils/metrics.quantile_nearest_rank``), so a
    scraped /metrics gauge and an analyzed event log tell the same
    story."""
    from trpo_torch.utils.metrics import quantile_nearest_rank

    return quantile_nearest_rank(
        [v for v in (_finite(v) for v in vals) if v is not None], q
    )


def _summarize_serving(records: list) -> Optional[dict]:
    """Aggregate the ``serve`` micro-batch records into the serving SLO
    report: request/batch totals, actions/s over the serving span,
    latency p50/p99 (per-batch oldest-request latency — the conservative,
    SLO-relevant end), and a per-padded-rung breakdown."""
    serves = [r for r in records if r.get("kind") == "serve"]
    if not serves:
        return None
    lats = [r.get("latency_ms") for r in serves]
    requests = sum(
        r.get("requests") for r in serves
        if isinstance(r.get("requests"), int)
    )
    times = [r.get("t") for r in serves if _finite(r.get("t")) is not None]
    span = (max(times) - min(times)) if len(times) >= 2 else None
    shapes: dict = {}
    for r in serves:
        rung = r.get("padded")
        if rung is None:
            continue
        row = shapes.setdefault(str(rung), {"batches": 0, "requests": 0,
                                            "lats": []})
        row["batches"] += 1
        if isinstance(r.get("requests"), int):
            row["requests"] += r["requests"]
        if _finite(r.get("latency_ms")) is not None:
            row["lats"].append(r["latency_ms"])
    return {
        "requests_total": requests,
        "batches_total": len(serves),
        "mean_batch_size": requests / len(serves) if serves else None,
        # span covers first→last dispatch; one lone batch has no rate
        "actions_per_sec": (requests / span) if span else None,
        "latency_p50_ms": _quantile(lats, 0.5),
        "latency_p99_ms": _quantile(lats, 0.99),
        "queue_depth_max": max(
            (r.get("queue_depth") for r in serves
             if _finite(r.get("queue_depth")) is not None),
            default=None,
        ),
        "shapes": {
            rung: {
                "batches": row["batches"],
                "requests": row["requests"],
                "p50_ms": _quantile(row["lats"], 0.5),
                "p99_ms": _quantile(row["lats"], 0.99),
            }
            for rung, row in shapes.items()
        },
    }


def _summarize_router(records: list) -> Optional[dict]:
    """Aggregate the replicated-serving control plane's records:
    ``router`` ``scope="request"`` rows into routed/retried/failed
    totals, p50/p99 and routed actions/s; ``scope="replica"`` rows into
    a per-replica lifecycle/traffic table; ``session`` rows into the
    session lifecycle counts. The ``scaling`` row reports per-replica
    throughput and load balance (worst/best replica request share —
    1.0 = perfectly even); the CROSS-run scaling efficiency (N-replica
    vs 1-replica actions/s) lives in ``bench.py serving_scale`` /
    BENCH_LADDER, where both legs exist."""
    reqs = [
        r for r in records
        if r.get("kind") == "router" and r.get("scope") == "request"
    ]
    lifecycle = [
        r for r in records
        if r.get("kind") == "router" and r.get("scope") == "replica"
    ]
    sessions = [r for r in records if r.get("kind") == "session"]
    canary = [r for r in records if r.get("kind") == "canary"]
    promote = [r for r in records if r.get("kind") == "promote"]
    autoscale = [r for r in records if r.get("kind") == "autoscale"]
    lease = [r for r in records if r.get("kind") == "lease"]
    host_recs = [
        r for r in records
        if r.get("kind") == "router" and r.get("scope") == "host"
    ]
    partitions = [
        r for r in records
        if r.get("kind") == "fault_injected"
        and r.get("fault") == "partition_host"
    ]
    if not reqs and not lifecycle and not lease and not promote:
        # lease-only logs (a fenced zombie's own event file) still get
        # a summary — the fencing refusals are the story there; same
        # for promote-only logs (a promotion controller's own file)
        return None
    ok_reqs = [r for r in reqs if r.get("ok")]
    lats = [r.get("ms") for r in ok_reqs]
    times = [
        r.get("t") for r in ok_reqs if _finite(r.get("t")) is not None
    ]
    span = (max(times) - min(times)) if len(times) >= 2 else None

    replicas: dict = {}

    def _row(rid):
        return replicas.setdefault(
            str(rid),
            {"requests": 0, "lats": [], "restarts": 0, "deaths": 0,
             "last_state": None},
        )

    for r in lifecycle:
        rid = r.get("replica")
        if rid is None:
            continue
        row = _row(rid)
        state = r.get("state")
        row["last_state"] = state if isinstance(state, str) else "unknown"
        if state == "restarted":
            row["restarts"] += 1
        elif state == "died":
            row["deaths"] += 1
    for r in ok_reqs:
        rid = r.get("replica")
        if rid is None:
            continue
        row = _row(rid)
        row["requests"] += 1
        if _finite(r.get("ms")) is not None:
            row["lats"].append(r["ms"])

    shares = [
        row["requests"] for row in replicas.values() if row["requests"]
    ]
    routed = len(ok_reqs)
    return {
        "routed_total": routed,
        "retried_total": sum(1 for r in reqs if r.get("retried")),
        "failed_total": sum(1 for r in reqs if not r.get("ok")),
        "actions_per_sec": (routed / span) if span else None,
        "latency_p50_ms": _quantile(lats, 0.5),
        "latency_p99_ms": _quantile(lats, 0.99),
        "replicas": {
            rid: {
                "requests": row["requests"],
                "p50_ms": _quantile(row["lats"], 0.5),
                "restarts": row["restarts"],
                "deaths": row["deaths"],
                "last_state": row["last_state"],
            }
            for rid, row in replicas.items()
        },
        "scaling": {
            "replicas": len(replicas),
            "actions_per_sec_per_replica": (
                routed / span / len(replicas)
                if span and replicas else None
            ),
            "balance": (
                min(shares) / max(shares) if shares and max(shares)
                else None
            ),
        },
        "sessions": dict(
            sorted(Counter(r.get("event") for r in sessions).items())
        ) if sessions else None,
        "failover": _failover_rows(sessions),
        "canary": _canary_rows(canary),
        "episodes": _episode_rows(sessions),
        "promote": _promote_rows(promote),
        "autoscale": _autoscale_rows(autoscale),
        "hosts": _host_rows(lifecycle, lease, host_recs),
        "lease": _lease_rows(lease, partitions),
    }


def _host_rows(lifecycle: list, lease: list, host_recs: list):
    """Per-host replica table: which replicas ran where,
    deaths and lease expiries per host, and the host's last recorded
    health state. None for single-host logs that never stamped a host
    on anything."""
    hosts: dict = {}

    def _row(host):
        return hosts.setdefault(
            str(host),
            {"replicas": set(), "deaths": 0, "lease_expired": 0,
             "last_state": None},
        )

    for r in lifecycle:
        host = r.get("host")
        if host is None:
            continue
        row = _row(host)
        if isinstance(r.get("replica"), str):
            row["replicas"].add(r["replica"])
        if r.get("state") == "died":
            row["deaths"] += 1
    for r in lease:
        host = r.get("host")
        if host is None:
            continue
        row = _row(host)
        if isinstance(r.get("replica"), str):
            row["replicas"].add(r["replica"])
        if r.get("event") == "expired":
            row["lease_expired"] += 1
    for r in host_recs:
        host = r.get("host")
        if host is None:
            continue
        state = r.get("state")
        _row(host)["last_state"] = (
            state if isinstance(state, str) else "unknown"
        )
    if not hosts:
        return None
    return {
        host: {**row, "replicas": sorted(row["replicas"])}
        for host, row in sorted(hosts.items())
    }


def _lease_rows(lease: list, partitions: list):
    """Lease-liveness summary: grant/renew/expire counts,
    fenced journal-write refusals (count + distinct sessions — the
    split-brain writers the fence silenced), and the injected
    partition durations. None for logs with neither lease records nor
    partitions."""
    if not lease and not partitions:
        return None
    counts = Counter(r.get("event") for r in lease)
    fenced_sessions = {
        r.get("session") for r in lease
        if r.get("event") == "fenced_write_refused"
        and isinstance(r.get("session"), str)
    }
    durations = [
        r.get("seconds") for r in partitions
        if _finite(r.get("seconds")) is not None
    ]
    return {
        "granted": counts.get("granted", 0),
        "renewed": counts.get("renewed", 0),
        "expired": counts.get("expired", 0),
        "fenced_write_refused": counts.get("fenced_write_refused", 0),
        "fenced_sessions": len(fenced_sessions),
        "partitions_injected": len(partitions),
        "partition_seconds_max": max(durations) if durations else None,
    }


def _failover_rows(sessions: list) -> Optional[dict]:
    """Failover quality: sessions resumed from a journaled
    carry vs restarted fresh, and the carry-journal lag (router-observed
    acts minus journaled steps at resume — 0 = the snapshot was current
    and the continuation bit-exact). None when no failover happened."""
    resumed = [r for r in sessions if r.get("event") == "resumed"]
    fresh = [r for r in sessions if r.get("event") == "reestablished"]
    if not resumed and not fresh:
        return None
    lags = [
        r.get("lag") for r in resumed
        if isinstance(r.get("lag"), int) and not isinstance(
            r.get("lag"), bool
        )
    ]
    total = len(resumed) + len(fresh)
    return {
        "resumed": len(resumed),
        "restarted_fresh": len(fresh),
        "resumed_fraction": len(resumed) / total,
        "journal_lag_mean": (sum(lags) / len(lags)) if lags else None,
        "journal_lag_max": max(lags) if lags else None,
    }


def _canary_rows(canary: list) -> Optional[dict]:
    """Canary deployment verdicts: per-lifecycle counts plus
    the per-step outcome table. None for logs with no canary records."""
    if not canary:
        return None
    counts = Counter(r.get("event") for r in canary)
    steps: dict = {}
    for r in canary:
        step = r.get("step")
        if step is None:
            continue
        row = steps.setdefault(
            str(step), {"replica": None, "outcome": "unresolved",
                        "reason": None}
        )
        if isinstance(r.get("replica"), str):
            row["replica"] = r["replica"]
        if r.get("event") in ("promoted", "rolled_back"):
            row["outcome"] = r["event"]
            if r.get("reason") is not None:
                row["reason"] = r["reason"]
    return {
        "started": counts.get("started", 0),
        "promoted": counts.get("promoted", 0),
        "rolled_back": counts.get("rolled_back", 0),
        "steps": steps,
    }


def _episode_rows(sessions: list) -> Optional[dict]:
    """Served realized-return summary: the router books a
    ``session``/``episode`` record per completed client episode — the
    feed the canary's reward gate judges and the promotion controller's
    feedback pools. None for logs with no episode records."""
    eps = [r for r in sessions if r.get("event") == "episode"]
    if not eps:
        return None
    returns = [
        r.get("ep_return") for r in eps
        if _finite(r.get("ep_return")) is not None
    ]
    steps = [
        r.get("ep_steps") for r in eps
        if isinstance(r.get("ep_steps"), int)
        and not isinstance(r.get("ep_steps"), bool)
    ]
    by_replica = Counter(
        str(r.get("replica")) for r in eps if r.get("replica") is not None
    )
    return {
        "episodes": len(eps),
        "mean_return": (
            sum(returns) / len(returns) if returns else None
        ),
        "steps_total": sum(steps) if steps else None,
        "by_replica": dict(sorted(by_replica.items())),
    }


def _promote_rows(promote: list) -> Optional[dict]:
    """Train→serve promotion verdicts: per-lifecycle counts,
    the per-serving-step outcome table, and the pooled served-return
    feedback. None for logs with no promote records."""
    if not promote:
        return None
    counts = Counter(r.get("event") for r in promote)
    steps: dict = {}
    fb_n = 0
    fb_weighted = 0.0
    for r in promote:
        step = r.get("step")
        if r.get("event") == "feedback":
            n = r.get("episodes")
            m = r.get("mean_return")
            if (
                isinstance(n, int) and not isinstance(n, bool) and n > 0
                and _finite(m) is not None
            ):
                fb_n += n
                fb_weighted += float(m) * n
            continue
        if step is None:
            continue
        row = steps.setdefault(
            str(step), {"member": None, "outcome": "unresolved",
                        "reason": None}
        )
        if isinstance(r.get("member"), str):
            row["member"] = r["member"]
        if r.get("event") in ("promoted", "rejected", "rolled_back"):
            row["outcome"] = r["event"]
            if r.get("reason") is not None:
                row["reason"] = r["reason"]
    return {
        "candidates": counts.get("candidate", 0),
        "promoted": counts.get("promoted", 0),
        "rejected": counts.get("rejected", 0),
        "rolled_back": counts.get("rolled_back", 0),
        "feedback_episodes": fb_n,
        "feedback_mean_return": (
            fb_weighted / fb_n if fb_n > 0 else None
        ),
        "steps": steps,
    }


def _autoscale_rows(autoscale: list) -> Optional[dict]:
    """Elastic-serving control actions: scale events, drain
    durations/sessions-moved, and the shed totals (each ``shed`` record
    is an aggregate carrying ``count``). None for logs with no
    autoscale records."""
    if not autoscale:
        return None
    counts = Counter(r.get("event") for r in autoscale)
    durations = [
        r.get("duration_s") for r in autoscale
        if r.get("event") == "drain_completed"
        and _finite(r.get("duration_s")) is not None
    ]
    moved = sum(
        r.get("sessions_moved") for r in autoscale
        if r.get("event") == "drain_completed"
        and isinstance(r.get("sessions_moved"), int)
    )
    sheds = sum(
        r.get("count") for r in autoscale
        if r.get("event") == "shed"
        and isinstance(r.get("count"), int)
    )
    shed_reasons = Counter()
    for r in autoscale:
        if r.get("event") == "shed" and isinstance(r.get("count"), int):
            shed_reasons[str(r.get("reason"))] += r["count"]
    return {
        "scale_out": counts.get("scale_out", 0),
        "drain_completed": counts.get("drain_completed", 0),
        "drain_aborted": counts.get("drain_aborted", 0),
        "sessions_moved": moved,
        "shed_total": sheds,
        "shed_reasons": dict(sorted(shed_reasons.items())),
        "drain_duration_mean_s": _mean(durations),
        "drain_duration_max_s": max(durations) if durations else None,
    }


# ---------------------------------------------------------------------------
# request traces
# ---------------------------------------------------------------------------

# span name → critical-path stage bucket. Stages are ATTRIBUTION, not a
# partition of the root: a hop span contains the replica's handler time,
# so the "network" share is computed structurally (hop minus its remote
# children), never by subtracting buckets from the root.
_SPAN_STAGES = {
    "batch.queue_wait": "queue",
    "engine.step_batch": "epoch",
    "engine.infer": "engine",
    "journal.sync": "journal",
    "router.retry": "retry",
    "router.takeover": "takeover",
    "router.fence": "takeover",
}
_HOP_NAMES = ("router.dispatch", "router.retry")
TRACE_STAGES = (
    "queue", "epoch", "engine", "network", "journal", "retry",
    "takeover",
)


def assemble_traces(records: list, dropped: Optional[list] = None) -> dict:
    """Join span records — from ONE log or several concatenated
    per-process logs (router + N replicas + hosts; the caller merges
    with ``load_events`` per file) — into ``{trace_id: [spans sorted by
    start]}``. Duplicate records (the same file merged twice) collapse
    on ``(span, trace, name)``.

    ``dropped``: a span record with a malformed/missing
    trace id used to be skipped SILENTLY — a replay-bundle builder
    that needed it could only read the miss as "trace never existed".
    Pass a list and every unjoinable record is appended to it, so
    reconstruction can report per-trace completeness instead of
    guessing."""
    traces: dict = {}
    seen = set()
    for r in records:
        if r.get("kind") != "span":
            continue
        tid = r.get("trace")
        if not isinstance(tid, str):
            if dropped is not None:
                dropped.append(r)
            continue
        key = (tid, r.get("span"), r.get("name"))
        if key in seen:
            continue
        seen.add(key)
        traces.setdefault(tid, []).append(r)
    for spans in traces.values():
        spans.sort(key=lambda s: _finite(s.get("start")) or 0.0)
    return traces


def _span_dur(s) -> float:
    return _finite(s.get("dur_ms")) or 0.0


def trace_breakdown(spans: list) -> Optional[dict]:
    """One assembled trace → its critical-path attribution: the root
    span (the edge's end-to-end time), per-stage durations, and the
    structural network share (each router hop's duration minus the
    remote handler time nested under it — what the wire and the
    injected transport latency cost). None when the trace has no root
    (a replica-only fragment)."""
    roots = [
        s for s in spans
        if s.get("parent") is None and not s.get("remote")
    ]
    if not roots:
        return None
    root = max(roots, key=_span_dur)
    stages = {stage: 0.0 for stage in TRACE_STAGES}
    by_parent: dict = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            by_parent.setdefault(p, []).append(s)
    for s in spans:
        stage = _SPAN_STAGES.get(s.get("name"))
        if stage is not None:
            stages[stage] += _span_dur(s)
        if s.get("name") in _HOP_NAMES:
            handler = sum(
                _span_dur(c)
                for c in by_parent.get(s.get("span"), [])
                if c.get("remote")
            )
            stages["network"] += max(0.0, _span_dur(s) - handler)
    return {
        "trace": root.get("trace"),
        "root": root.get("name"),
        "root_ms": _span_dur(root),
        "unterminated": root.get("dur_ms") is None,
        "spans": len(spans),
        "stages": {
            k: v for k, v in stages.items() if v > 0.0
        },
    }


def _summarize_hops(spans: list) -> dict:
    """Dispatch-hop stats grouped by wire format: every
    ``router.dispatch``/``router.retry`` span carries ``codec``
    (json|binary) and ``transport`` (tcp|uds) attrs, so the per-group
    hop p99 — and the structural network share (hop minus the remote
    handler nested under it) — is exactly the before/after evidence the
    data-plane bench quotes. Keyed ``codec/transport``; spans from old
    logs without the attrs group under ``json/tcp`` (the only path that
    existed before the attrs did)."""
    by_parent: dict = {}
    for s in spans:
        p = s.get("parent")
        if p is not None:
            by_parent.setdefault(p, []).append(s)
    groups: dict = {}
    for s in spans:
        if s.get("name") not in _HOP_NAMES:
            continue
        key = (
            f"{s.get('codec') or 'json'}/{s.get('transport') or 'tcp'}"
        )
        handler = sum(
            _span_dur(c)
            for c in by_parent.get(s.get("span"), [])
            if c.get("remote")
        )
        dur = _span_dur(s)
        groups.setdefault(key, []).append(
            (dur, max(0.0, dur - handler))
        )
    out = {}
    for key in sorted(groups):
        hops = [h for h, _ in groups[key]]
        net = [n for _, n in groups[key]]
        out[key] = {
            "hops": len(hops),
            "hop_p50_ms": _quantile(hops, 0.5),
            "hop_p99_ms": _quantile(hops, 0.99),
            "network_p50_ms": _quantile(net, 0.5),
            "network_p99_ms": _quantile(net, 0.99),
        }
    return out


def _summarize_traces(records: list) -> Optional[dict]:
    """The per-run trace block: trace/span counts, root-duration
    quantiles, per-stage p50/p99 + mean share of the root, and the
    slowest traces (root duration, stage attribution). None for logs
    with no spans."""
    traces = assemble_traces(records)
    if not traces:
        return None
    rows = [
        b for b in (trace_breakdown(s) for s in traces.values())
        if b is not None
    ]
    spans_total = sum(len(s) for s in traces.values())
    wire = _summarize_hops(
        [s for spans in traces.values() for s in spans]
    )
    if not rows:
        return {"count": len(traces), "spans": spans_total,
                "assembled": 0, "stages": {}, "wire": wire,
                "slowest": []}
    roots = [r["root_ms"] for r in rows]
    root_mean = _mean(roots)
    stage_stats: dict = {}
    for stage in TRACE_STAGES:
        vals = [
            r["stages"][stage] for r in rows if stage in r["stages"]
        ]
        if not vals:
            continue
        stage_stats[stage] = {
            "traces": len(vals),
            "p50_ms": _quantile(vals, 0.5),
            "p99_ms": _quantile(vals, 0.99),
            "mean_ms": _mean(vals),
            # the stage's share of mean end-to-end time across ALL
            # assembled traces (absent = 0 for a trace) — the
            # critical-path table's headline column
            "share": (
                sum(vals) / (root_mean * len(rows))
                if root_mean else None
            ),
        }
    slowest = sorted(rows, key=lambda r: -r["root_ms"])[:5]
    return {
        "count": len(traces),
        "assembled": len(rows),
        "spans": spans_total,
        "root_p50_ms": _quantile(roots, 0.5),
        "root_p99_ms": _quantile(roots, 0.99),
        "stages": stage_stats,
        "wire": wire,
        "slowest": [
            {
                "trace": r["trace"],
                "root": r["root"],
                "root_ms": r["root_ms"],
                "stages": {
                    k: round(v, 3) for k, v in r["stages"].items()
                },
            }
            for r in slowest
        ],
    }


def render_waterfall(spans: list) -> str:
    """One assembled trace as a text waterfall: start offsets, scaled
    bars, durations, the stage taxonomy readable at a glance over ssh
    (no deps — the format_table contract)."""
    if not spans:
        return "(no spans)"
    spans = sorted(spans, key=lambda s: _finite(s.get("start")) or 0.0)
    t0 = min(_finite(s.get("start")) or 0.0 for s in spans)
    ends = [
        (_finite(s.get("start")) or 0.0) - t0 + _span_dur(s) / 1e3
        for s in spans
    ]
    window_s = max(max(ends), 1e-9)
    width = 32
    rows = []
    for s in spans:
        off_s = (_finite(s.get("start")) or 0.0) - t0
        dur_s = _span_dur(s) / 1e3
        left = int(off_s / window_s * width)
        bar = max(1, int(dur_s / window_s * width)) if dur_s else 1
        bar = min(bar, width - min(left, width - 1))
        attrs = " ".join(
            f"{k}={s[k]}"
            for k in (
                "process", "host", "replica", "width", "rung",
                "status", "resumed", "cause", "gate_ms",
            )
            if s.get(k) is not None
        )
        rows.append([
            f"{off_s * 1e3:8.2f}",
            "." * min(left, width - 1) + "#" * bar,
            s.get("name"),
            "-" if s.get("dur_ms") is None
            else f"{_span_dur(s):.2f}",
            attrs,
        ])
    head = spans[0].get("trace")
    return f"trace {head}\n" + format_table(
        rows, ["offset_ms", "timeline", "span", "dur_ms", "attrs"]
    )


def _summarize_fleet(records: list) -> Optional[dict]:
    """Aggregate ``fleet`` lifecycle records (fleet/scheduler.py) into a
    per-member table: last state, launch attempts, requeues — plus the
    fleet-wide state totals. None for non-fleet logs."""
    fleet = [r for r in records if r.get("kind") == "fleet"]
    if not fleet:
        return None
    members: dict = {}
    counts: Counter = Counter()
    for r in fleet:
        mid, state = r.get("member"), r.get("state")
        if not isinstance(mid, str):
            continue
        if not isinstance(state, str):
            # reader contract: tolerate what the validator rejects — a
            # stateless record must not make sorted() compare None<str
            state = "unknown"
        counts[state] += 1
        row = members.setdefault(
            mid, {"last_state": None, "attempts": 0, "requeues": 0,
                  "transitions": 0}
        )
        row["last_state"] = state
        row["transitions"] += 1
        a = r.get("attempt")
        if isinstance(a, int) and not isinstance(a, bool):
            row["attempts"] = max(row["attempts"], a)
        if state == "requeued":
            row["requeues"] += 1
    return {"members": members, "counts": dict(sorted(counts.items()))}


def _summarize_alerts(records: list) -> Optional[dict]:
    """Aggregate ``alert`` lifecycle records (obs/alerts.py) into a
    per-rule table: fired / resolved / still-active counts plus the
    fastest time-to-detect against the log's injected faults. None for
    logs without an alerting plane.

    ``false_positives`` is the STRICT counter ``compare_runs`` gates
    on: in a log that injects faults, a firing alert is counted false
    when NO fault at all was injected in the 120 s before it fired —
    an alert going off in a provably quiet phase. The counter is
    deliberately COARSER than the validator's per-rule cause analysis
    (``scripts/validate_events`` cross-checks metric evidence and
    control-plane reactions): a fault's collateral damage legitimately
    fires rules outside its own ``FAULT_ALERT_RULES`` contract (a
    checkpoint-chaos phase stalling serving long enough to breach the
    latency SLO), and only the validator can tell that from noise.
    This row is the cross-run trend of the indefensible case."""
    alerts = [r for r in records if r.get("kind") == "alert"]
    if not alerts:
        return None
    from trpo_torch.obs.alerts import FAULT_ALERT_RULES

    rules: dict = {}
    open_keys: set = set()
    for r in alerts:
        rule = r.get("rule")
        if not isinstance(rule, str):
            continue
        row = rules.setdefault(
            rule,
            {"fired": 0, "resolved": 0, "active": 0, "detect_s": None},
        )
        key = (rule, r.get("target"))
        if r.get("state") == "firing":
            row["fired"] += 1
            open_keys.add(key)
        elif r.get("state") == "resolved":
            row["resolved"] += 1
            open_keys.discard(key)
    for rule, _target in open_keys:
        rules[rule]["active"] += 1

    # time-to-detect: for each armed fault, the first firing of a rule
    # its contract expects; credited both fleet-wide and per rule
    faults = [
        r for r in records
        if r.get("kind") == "fault_injected"
        and isinstance(r.get("fault"), str)
        and _finite(r.get("t")) is not None
    ]
    detects = []
    for f in faults:
        expected = FAULT_ALERT_RULES.get(f["fault"])
        if not expected:
            continue
        best = None
        for a in alerts:
            if (
                a.get("state") == "firing"
                and a.get("rule") in expected
                and _finite(a.get("t")) is not None
                and a["t"] >= f["t"]
            ):
                d = a["t"] - f["t"]
                if best is None or d < best[0]:
                    best = (d, a["rule"])
        if best is not None:
            detects.append(best[0])
            row = rules.get(best[1])
            if row is not None and (
                row["detect_s"] is None or best[0] < row["detect_s"]
            ):
                row["detect_s"] = best[0]

    false_positives = 0
    if faults:
        for a in alerts:
            if a.get("state") != "firing":
                continue
            t = _finite(a.get("t"))
            if t is None:
                continue
            caused = any(
                t - 120.0 <= f["t"] <= t for f in faults
            )
            if not caused:
                false_positives += 1

    return {
        "rules": {k: rules[k] for k in sorted(rules)},
        "fired_total": sum(r["fired"] for r in rules.values()),
        "resolved_total": sum(r["resolved"] for r in rules.values()),
        "active_total": sum(r["active"] for r in rules.values()),
        "false_positives": false_positives,
        "time_to_detect_mean_s": _mean(detects),
        "time_to_detect_max_s": max(detects) if detects else None,
    }


def summarize_run(records: list) -> dict:
    """One run's report, computed from its event records alone."""
    manifest = next(
        (r for r in records if r.get("kind") == "run_manifest"), None
    )
    iters = [r for r in records if r.get("kind") == "iteration"]
    iters.sort(key=lambda r: r.get("iteration", 0))

    # -- iteration metrics -------------------------------------------------
    last_stats = dict(iters[-1].get("stats") or {}) if iters else {}
    iter_ms = [
        (r.get("stats") or {}).get("iteration_ms") for r in iters
    ]
    # every run SEGMENT's first iteration row carries XLA compilation: a
    # resumed/requeued run appends a new manifest + a compile-laden first
    # row mid-file, so the drop is per segment, not just row 1 (records
    # walk in FILE order here — `iters` above is sorted by iteration)
    compile_rows = set()
    awaiting_first = False
    for r in records:
        if r.get("kind") == "run_manifest":
            awaiting_first = True
        elif r.get("kind") == "iteration" and awaiting_first:
            compile_rows.add(id(r))
            awaiting_first = False
    steady_vals = [
        (r.get("stats") or {}).get("iteration_ms")
        for r in iters
        if id(r) not in compile_rows
    ]
    if compile_rows and steady_vals and len(iter_ms) > 2:
        steady_ms = _mean(steady_vals)
    else:  # manifest-less/tiny logs: the pre-fleet single-drop rule
        steady_ms = _mean(iter_ms[1:] if len(iter_ms) > 2 else iter_ms)
    throughput = None
    if len(iters) >= 2:
        ts0 = (iters[0].get("stats") or {}).get("timesteps_total")
        ts1 = (iters[-1].get("stats") or {}).get("timesteps_total")
        t0, t1 = iters[0].get("t"), iters[-1].get("t")
        if None not in (ts0, ts1, t0, t1) and t1 > t0:
            throughput = (ts1 - ts0) / (t1 - t0)
    # env-steps/s as a first-class rate metric: per-iteration
    # batch size (the median of consecutive timesteps_total deltas —
    # robust to a resume gap or a dropped row) over the STEADY iteration
    # time, so the regression gate judges rollout throughput directly
    # instead of only iter ms. Differs from timesteps_per_sec above,
    # which divides by wall-clock time between rows (logging, drain and
    # checkpoint stalls included).
    env_steps_per_sec = None
    batch_per_iter = None
    ts_vals = [
        _finite((r.get("stats") or {}).get("timesteps_total"))
        for r in iters
    ]
    deltas = sorted(
        b - a
        for a, b in zip(ts_vals, ts_vals[1:])
        if a is not None and b is not None and b > a
    )
    if deltas:
        batch_per_iter = deltas[len(deltas) // 2]
    if batch_per_iter and steady_ms:
        env_steps_per_sec = batch_per_iter / (steady_ms / 1e3)
    rewards = [
        (r.get("stats") or {}).get("reward_running") for r in iters
    ]
    rewards = [v for v in (_finite(v) for v in rewards) if v is not None]

    # -- phase table (mean ms weighted by calls when present) --------------
    phases: dict = {}
    for r in records:
        if r.get("kind") != "phase":
            continue
        name, ms = r.get("name"), _finite(r.get("ms"))
        if name is None or ms is None:
            continue
        calls = r.get("calls")
        calls = calls if isinstance(calls, int) and calls > 0 else 1
        row = phases.setdefault(
            name, {"ms_sum": 0.0, "calls": 0, "events": 0}
        )
        row["ms_sum"] += ms * calls
        row["calls"] += calls
        row["events"] += 1
    phase_table = {
        name: {
            "mean_ms": row["ms_sum"] / row["calls"],
            "calls": row["calls"],
        }
        for name, row in phases.items()
    }

    # -- health / recompile / faults --------------------------------------
    health = Counter(
        f"{r.get('check')}:{r.get('level')}"
        for r in records
        if r.get("kind") == "health"
    )
    recompiles = [r for r in records if r.get("kind") == "recompile"]
    faults = sum(1 for r in records if r.get("kind") == "fault_injected")
    recoveries = sum(1 for r in records if r.get("kind") == "recovery")

    # -- memory ------------------------------------------------------------
    programs: dict = {}
    live_peak = None
    for r in records:
        if r.get("kind") != "memory":
            continue
        if r.get("scope") == "program":
            programs[r.get("program")] = {
                k: v for k, v in r.items() if k.endswith("_bytes")
            }
        elif r.get("scope") == "live":
            b = _finite(r.get("live_buffer_bytes"))
            if b is not None:
                live_peak = b if live_peak is None else max(live_peak, b)

    serving = _summarize_serving(records)

    # -- solver precision ladder ---------------------------------
    # the counters are run-cumulative (they ride TrainState.ladder), so
    # the LAST row that carries them is the run total; cosine stats come
    # from the per-iteration audit values
    solver_precision = None
    ladder_rows = [
        r for r in iters if "fallbacks" in (r.get("stats") or {})
    ]
    if ladder_rows:
        last_l = ladder_rows[-1].get("stats") or {}
        cosines = [
            v
            for v in (
                _finite((r.get("stats") or {}).get("solve_cosine"))
                for r in ladder_rows
            )
            if v is not None
        ]
        solver_precision = {
            "audit_runs": last_l.get("audit_runs"),
            "fallbacks": last_l.get("fallbacks"),
            "solve_cosine_min": _finite(last_l.get("solve_cosine_min")),
            "solve_cosine_mean": _mean(cosines),
            "cg_budget_final": last_l.get("cg_budget"),
            "pinned": bool(last_l.get("solve_pinned")),
        }

    return {
        "manifest": {
            k: manifest.get(k)
            for k in (
                "config_hash", "backend", "jax_version", "device_count",
                "git_sha", "driver", "n_iterations",
                # the port's manifest names its stack beside the
                # reference's keys (obs/events.manifest_fields)
                "torch_version", "cuda_version", "device_name",
            )
        }
        if manifest
        else None,
        "iterations": len(iters),
        "last_iteration": iters[-1].get("iteration") if iters else None,
        "last_stats": last_stats,
        "final_reward_running": rewards[-1] if rewards else None,
        "steady_iteration_ms": steady_ms,
        "timesteps_per_sec": throughput,
        "env_steps_per_sec": env_steps_per_sec,
        "batch_per_iteration": batch_per_iter,
        "phases": phase_table,
        "health": dict(sorted(health.items())),
        "recompiles": {
            "total": len(recompiles),
            "unexpected": sum(
                1 for r in recompiles if r.get("unexpected")
            ),
        },
        "faults_injected": faults,
        "recoveries": recoveries,
        "memory": {
            "programs": programs,
            "peak_live_buffer_bytes": live_peak,
        },
        "serving": serving,
        "router": _summarize_router(records),
        "traces": _summarize_traces(records),
        "solver_precision": solver_precision,
        "fleet": _summarize_fleet(records),
        "alerts": _summarize_alerts(records),
        "events_total": dict(
            Counter(r.get("kind") for r in records)
        ),
    }


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

# direction: "time" (higher is worse), "rate" (lower is worse),
# "bytes" (higher is worse)
_METRIC_DIRECTIONS = {
    "steady_iteration_ms": "time",
    "timesteps_per_sec": "rate",
    # rollout throughput judged directly: batch/iteration over
    # steady iteration time — shrink = regress, like any rate
    "env_steps_per_sec": "rate",
    # reward parity (the mixed-precision gate: a ladder run must
    # land within the threshold of its f32 twin; identical-config gate
    # legs are seed-deterministic, so the row is exact there)
    "final_reward_running": "rate",
}


def _rung_key(rung: str):
    """Numeric sort for padded-rung keys ('8' before '64'), tolerating a
    non-numeric key from a foreign log."""
    try:
        return (0, int(rung))
    except ValueError:
        return (1, rung)


def _verdict(metric, base, new, threshold_pct, direction) -> dict:
    row = {
        "metric": metric,
        "base": base,
        "new": new,
        "direction": direction,
    }
    if base is None or new is None:
        row["verdict"] = "skipped"
        row["delta_pct"] = None
        return row
    if base <= 0:
        # a zero/negative baseline has no meaningful ratio. Growth from
        # zero (e.g. a fully-fused program's temp_bytes going 0 → 2 GiB)
        # must NOT auto-pass as "ok" — report it as skipped so a human
        # sees the row; only a still-zero value is genuinely fine
        row["delta_pct"] = None
        row["verdict"] = "ok" if new <= max(base, 0) else "skipped"
        return row
    delta_pct = (new - base) / base * 100.0
    row["delta_pct"] = delta_pct
    factor = 1.0 + threshold_pct / 100.0
    if direction == "rate":
        regressed = new < base / factor
        improved = new > base * factor
    else:
        regressed = new > base * factor
        improved = new < base / factor
    row["verdict"] = (
        "regressed" if regressed else "improved" if improved else "ok"
    )
    return row


def compare_runs(
    base: dict,
    new: dict,
    threshold_pct: float = 20.0,
    min_ms: float = 1.0,
) -> dict:
    """Regression verdicts between two :func:`summarize_run` outputs.

    Returns ``{"verdicts": [...], "regressed": bool, "threshold_pct",
    "min_ms"}`` — ``regressed`` is True when ANY verdict row regressed
    (the CLI turns it into a nonzero exit)."""
    verdicts = []

    # per-phase mean ms — only phases both runs measured, above the floor
    base_ph = base.get("phases") or {}
    new_ph = new.get("phases") or {}
    for name in sorted(set(base_ph) | set(new_ph)):
        b = (base_ph.get(name) or {}).get("mean_ms")
        n = (new_ph.get(name) or {}).get("mean_ms")
        if b is not None and n is not None and max(b, n) < min_ms:
            continue  # sub-floor phases are scheduler noise
        verdicts.append(
            _verdict(f"phase/{name}", b, n, threshold_pct, "time")
        )

    # scalar run metrics
    for metric, direction in _METRIC_DIRECTIONS.items():
        b, n = base.get(metric), new.get(metric)
        if metric == "final_reward_running" and b is not None and b <= 0:
            # rewards are signed: _verdict's base<=0 branch was written
            # for time/bytes growth-from-zero and would call a collapse
            # from -50 to -400 "ok" (and -50 → +100 "skipped"). A
            # percent threshold is meaningless against a ≤0 baseline —
            # surface the pair for a human instead of auto-judging.
            verdicts.append({
                "metric": metric, "base": b, "new": n,
                "direction": direction, "delta_pct": None,
                "verdict": "skipped",
            })
            continue
        verdicts.append(
            _verdict(metric, b, n, threshold_pct, direction)
        )

    # memory: live peak + per-program compiled footprints
    b_mem = (base.get("memory") or {})
    n_mem = (new.get("memory") or {})
    verdicts.append(
        _verdict(
            "memory/peak_live_buffer_bytes",
            b_mem.get("peak_live_buffer_bytes"),
            n_mem.get("peak_live_buffer_bytes"),
            threshold_pct, "bytes",
        )
    )
    # serving SLOs — only when at least one run served (training-only
    # comparisons must not grow a block of always-skipped rows). Latency
    # is time-like (grow = regress), actions/s is rate-like (shrink =
    # regress) — the acceptance contract; per-rung p50 rows use
    # the same union-not-intersection policy as the program-memory rows.
    b_srv = base.get("serving") or {}
    n_srv = new.get("serving") or {}
    if b_srv or n_srv:
        for metric, direction in (
            ("latency_p50_ms", "time"),
            ("latency_p99_ms", "time"),
            ("actions_per_sec", "rate"),
        ):
            verdicts.append(
                _verdict(
                    f"serve/{metric}", b_srv.get(metric),
                    n_srv.get(metric), threshold_pct, direction,
                )
            )
        b_shapes = b_srv.get("shapes") or {}
        n_shapes = n_srv.get("shapes") or {}
        for rung in sorted(set(b_shapes) | set(n_shapes), key=_rung_key):
            verdicts.append(
                _verdict(
                    f"serve/shape{rung}/p50_ms",
                    (b_shapes.get(rung) or {}).get("p50_ms"),
                    (n_shapes.get(rung) or {}).get("p50_ms"),
                    threshold_pct, "time",
                )
            )

    # replicated-serving SLOs — router p50/p99 are time-like,
    # routed actions/s rate-like; rows only when at least one run
    # actually routed (same gating policy as the serve block)
    b_rt = base.get("router") or {}
    n_rt = new.get("router") or {}
    if b_rt or n_rt:
        for metric, direction in (
            ("latency_p50_ms", "time"),
            ("latency_p99_ms", "time"),
            ("actions_per_sec", "rate"),
        ):
            verdicts.append(
                _verdict(
                    f"router/{metric}", b_rt.get(metric),
                    n_rt.get(metric), threshold_pct, direction,
                )
            )
        # failover quality: the resumed fraction is
        # rate-like — a serving change that turns lossless failovers
        # back into fresh restarts is a regression; rows only when a
        # run actually failed over (skipped otherwise, per _verdict)
        b_fo = b_rt.get("failover") or {}
        n_fo = n_rt.get("failover") or {}
        if b_fo or n_fo:
            verdicts.append(
                _verdict(
                    "router/failover_resumed_fraction",
                    b_fo.get("resumed_fraction"),
                    n_fo.get("resumed_fraction"),
                    threshold_pct, "rate",
                )
            )
            verdicts.append(
                _verdict(
                    "router/journal_lag_max",
                    b_fo.get("journal_lag_max"),
                    n_fo.get("journal_lag_max"),
                    threshold_pct, "time",
                )
            )
        # canary verdicts: rolled_back is a strict counter (the
        # solve/fallbacks pattern) — ANY rise between two supposedly
        # clean runs means a checkpoint failed its gate, which no
        # noise threshold excuses
        b_cn = b_rt.get("canary") or {}
        n_cn = n_rt.get("canary") or {}
        if b_cn or n_cn:
            b_rb = b_cn.get("rolled_back") or 0
            n_rb = n_cn.get("rolled_back") or 0
            verdicts.append({
                "metric": "router/canary_rolled_back",
                "base": b_rb,
                "new": n_rb,
                "direction": "count",
                "delta_pct": None,
                "verdict": "regressed" if n_rb > b_rb else "ok",
            })
            verdicts.append(
                _verdict(
                    "router/canary_promoted",
                    b_cn.get("promoted"), n_cn.get("promoted"),
                    threshold_pct, "rate",
                )
            )
        # promotion verdicts: an unresolved/timed-out
        # promotion (rolled_back) is a strict counter — the canary
        # rolled_back pattern; promoted throughput and the served
        # realized return are rate-like (lower is worse)
        b_pm = b_rt.get("promote") or {}
        n_pm = n_rt.get("promote") or {}
        if b_pm or n_pm:
            b_rb = b_pm.get("rolled_back") or 0
            n_rb = n_pm.get("rolled_back") or 0
            verdicts.append({
                "metric": "router/promote_rolled_back",
                "base": b_rb,
                "new": n_rb,
                "direction": "count",
                "delta_pct": None,
                "verdict": "regressed" if n_rb > b_rb else "ok",
            })
            verdicts.append(
                _verdict(
                    "router/promote_promoted",
                    b_pm.get("promoted"), n_pm.get("promoted"),
                    threshold_pct, "rate",
                )
            )
        b_ep = b_rt.get("episodes") or {}
        n_ep = n_rt.get("episodes") or {}
        if b_ep or n_ep:
            verdicts.append(
                _verdict(
                    "router/served_episodes",
                    b_ep.get("episodes"), n_ep.get("episodes"),
                    threshold_pct, "rate",
                )
            )
        # elastic-serving verdicts: an aborted drain is a
        # strict counter (the canary_rolled_back pattern — a drain
        # that could not move its sessions losslessly is never noise);
        # drain duration is time-like, sheds grow-is-worse under the
        # same threshold (comparable runs drive comparable storms)
        b_as = b_rt.get("autoscale") or {}
        n_as = n_rt.get("autoscale") or {}
        if b_as or n_as:
            b_da = b_as.get("drain_aborted") or 0
            n_da = n_as.get("drain_aborted") or 0
            verdicts.append({
                "metric": "router/autoscale_drain_aborted",
                "base": b_da,
                "new": n_da,
                "direction": "count",
                "delta_pct": None,
                "verdict": "regressed" if n_da > b_da else "ok",
            })
            verdicts.append(
                _verdict(
                    "router/autoscale_drain_duration_max_s",
                    b_as.get("drain_duration_max_s"),
                    n_as.get("drain_duration_max_s"),
                    threshold_pct, "time",
                )
            )
            # sheds are a COUNT (grow-is-worse under the threshold —
            # comparable runs drive comparable storms): judged with the
            # time-direction rule, labeled honestly as a count so no
            # consumer renders shed totals in milliseconds
            shed_row = _verdict(
                "router/autoscale_shed_total",
                b_as.get("shed_total"),
                n_as.get("shed_total"),
                threshold_pct, "time",
            )
            shed_row["direction"] = "count"
            verdicts.append(shed_row)
        # multi-host liveness verdicts: lease expiries and
        # fenced (split-brain) journal writes are STRICT counters —
        # the drain_aborted pattern: between two supposedly-clean runs
        # a lease expiring, or a zombie writer needing to be refused,
        # is a liveness event no noise threshold excuses
        b_ls = b_rt.get("lease") or {}
        n_ls = n_rt.get("lease") or {}
        if b_ls or n_ls:
            for key in ("expired", "fenced_write_refused"):
                b_v = b_ls.get(key) or 0
                n_v = n_ls.get(key) or 0
                verdicts.append({
                    "metric": f"router/lease_{key}"
                    if key == "expired" else f"router/{key}",
                    "base": b_v,
                    "new": n_v,
                    "direction": "count",
                    "delta_pct": None,
                    "verdict": "regressed" if n_v > b_v else "ok",
                })

    # request-trace critical path — per-stage durations are
    # time-like (a stage's p99 growing past the threshold is a located
    # regression, which is the whole point of attribution); rows only
    # when at least one run traced, and only for stages either run
    # actually spent time in (the union-not-intersection policy)
    b_tr = base.get("traces") or {}
    n_tr = new.get("traces") or {}
    if b_tr or n_tr:
        verdicts.append(
            _verdict(
                "trace/root_p99_ms",
                b_tr.get("root_p99_ms"), n_tr.get("root_p99_ms"),
                threshold_pct, "time",
            )
        )
        b_st = b_tr.get("stages") or {}
        n_st = n_tr.get("stages") or {}
        for stage in sorted(set(b_st) | set(n_st)):
            verdicts.append(
                _verdict(
                    f"trace/stage_{stage}_p99_ms",
                    (b_st.get(stage) or {}).get("p99_ms"),
                    (n_st.get(stage) or {}).get("p99_ms"),
                    threshold_pct, "time",
                )
            )
        # per-wire-format hop rows: a codec/transport group
        # whose network p99 grew is a located data-plane regression —
        # same union-not-intersection policy as the stage rows
        b_w = b_tr.get("wire") or {}
        n_w = n_tr.get("wire") or {}
        for key in sorted(set(b_w) | set(n_w)):
            verdicts.append(
                _verdict(
                    f"trace/wire_{key}_network_p99_ms",
                    (b_w.get(key) or {}).get("network_p99_ms"),
                    (n_w.get(key) or {}).get("network_p99_ms"),
                    threshold_pct, "time",
                )
            )

    # alerting-plane verdicts — only when at least one run
    # carried alert records. `false_positives` is a STRICT counter (the
    # drain_aborted pattern): between two supposedly-clean runs an
    # alert firing with no fault whose contract expects it is a broken
    # alert contract, which no noise threshold excuses. Time-to-detect
    # is time-like — a PR that makes the plane slower to notice a
    # proven incident is a located observability regression. Per-rule
    # fired counts are grow-is-worse counts under the threshold
    # (comparable runs inject comparable faults — the shed_total
    # pattern).
    b_al = base.get("alerts") or {}
    n_al = new.get("alerts") or {}
    if b_al or n_al:
        b_fp = b_al.get("false_positives") or 0
        n_fp = n_al.get("false_positives") or 0
        verdicts.append({
            "metric": "alerts/false_positives",
            "base": b_fp,
            "new": n_fp,
            "direction": "count",
            "delta_pct": None,
            "verdict": "regressed" if n_fp > b_fp else "ok",
        })
        verdicts.append(
            _verdict(
                "alerts/time_to_detect_mean_s",
                b_al.get("time_to_detect_mean_s"),
                n_al.get("time_to_detect_mean_s"),
                threshold_pct, "time",
            )
        )
        b_rules = b_al.get("rules") or {}
        n_rules = n_al.get("rules") or {}
        for rule in sorted(set(b_rules) | set(n_rules)):
            row = _verdict(
                f"alerts/{rule}_fired",
                (b_rules.get(rule) or {}).get("fired"),
                (n_rules.get(rule) or {}).get("fired"),
                threshold_pct, "time",
            )
            row["direction"] = "count"
            verdicts.append(row)

    # solver-precision counters — only when at least one run
    # carried the ladder. `fallbacks` is judged as a strict counter: ANY
    # rise is a failed audit, which no noise threshold excuses; cosine
    # floors are config-enforced on-device, so cosine_min is reported
    # (delta row) rather than thresholded here.
    b_sp = base.get("solver_precision") or {}
    n_sp = new.get("solver_precision") or {}
    if b_sp or n_sp:
        b_fb = b_sp.get("fallbacks") or 0
        n_fb = n_sp.get("fallbacks") or 0
        verdicts.append({
            "metric": "solve/fallbacks",
            "base": b_fb,
            "new": n_fb,
            "direction": "count",
            "delta_pct": None,
            "verdict": "regressed" if n_fb > b_fb else "ok",
        })
        verdicts.append(
            _verdict(
                "solve/cosine_min",
                b_sp.get("solve_cosine_min"),
                n_sp.get("solve_cosine_min"),
                threshold_pct, "rate",
            )
        )
        verdicts.append(
            _verdict(
                "solve/cg_budget_final",
                b_sp.get("cg_budget_final"),
                n_sp.get("cg_budget_final"),
                threshold_pct, "time",
            )
        )

    b_prog = b_mem.get("programs") or {}
    n_prog = n_mem.get("programs") or {}
    # union, not intersection: a program only one run measured (added,
    # renamed, or dropped by a PR) must surface as a `skipped` row — an
    # HBM-critical new program escaping the report entirely would
    # violate the no-silent-verdict contract above
    for pname in sorted(set(b_prog) | set(n_prog)):
        for field in ("temp_bytes", "peak_estimate_bytes"):
            verdicts.append(
                _verdict(
                    f"memory/{pname}/{field}",
                    (b_prog.get(pname) or {}).get(field),
                    (n_prog.get(pname) or {}).get(field),
                    threshold_pct, "bytes",
                )
            )

    return {
        "verdicts": verdicts,
        "regressed": any(v["verdict"] == "regressed" for v in verdicts),
        "threshold_pct": threshold_pct,
        "min_ms": min_ms,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024
    return f"{v:.1f}TiB"


def _fmt(v, nd=2) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def format_table(rows: list, headers: list) -> str:
    """Plain-text column alignment (no deps — this renders over ssh on
    the serving host)."""
    rows = [[str(c) for c in row] for row in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(headers), sep] + [line(r) for r in rows])


def render_summary(summary: dict) -> str:
    """The single-run report as text: identity, throughput, phase table,
    health/recompile/memory sections."""
    out = []
    man = summary.get("manifest") or {}
    out.append(
        "run: "
        + " ".join(
            f"{k}={man.get(k)}"
            for k in ("config_hash", "backend", "driver", "git_sha")
            if man.get(k) is not None
        )
    )
    out.append(
        f"iterations: {summary['iterations']}"
        f" (last={summary['last_iteration']})"
        f"  steady_iteration_ms={_fmt(summary['steady_iteration_ms'])}"
        f"  timesteps/s={_fmt(summary['timesteps_per_sec'], 1)}"
        f"  env-steps/s={_fmt(summary.get('env_steps_per_sec'), 1)}"
        f"  final_reward_running={_fmt(summary['final_reward_running'])}"
    )
    phases = summary.get("phases") or {}
    if phases:
        out.append("")
        out.append(format_table(
            [
                [name, _fmt(row["mean_ms"]), row["calls"]]
                for name, row in sorted(phases.items())
            ],
            ["phase", "mean_ms", "calls"],
        ))
    health = summary.get("health") or {}
    rc = summary.get("recompiles") or {}
    out.append("")
    out.append(
        "health: "
        + (
            ", ".join(f"{k}×{v}" for k, v in health.items())
            if health
            else "clean"
        )
        + f"  recompiles: {rc.get('total', 0)} "
        f"({rc.get('unexpected', 0)} unexpected)"
        + f"  faults: {summary.get('faults_injected', 0)}"
        f"  recoveries: {summary.get('recoveries', 0)}"
    )
    srv = summary.get("serving") or {}
    if srv:
        out.append("")
        out.append(
            f"serving: requests={srv.get('requests_total')}"
            f" batches={srv.get('batches_total')}"
            f" actions/s={_fmt(srv.get('actions_per_sec'), 1)}"
            f" p50={_fmt(srv.get('latency_p50_ms'))}ms"
            f" p99={_fmt(srv.get('latency_p99_ms'))}ms"
            f" queue_max={srv.get('queue_depth_max')}"
        )
        shapes = srv.get("shapes") or {}
        if shapes:
            out.append(format_table(
                [
                    [
                        rung,
                        row.get("batches"),
                        row.get("requests"),
                        _fmt(row.get("p50_ms")),
                        _fmt(row.get("p99_ms")),
                    ]
                    for rung, row in sorted(
                        shapes.items(), key=lambda kv: _rung_key(kv[0])
                    )
                ],
                ["padded", "batches", "requests", "p50_ms", "p99_ms"],
            ))
    rt = summary.get("router") or {}
    if rt:
        out.append("")
        out.append(
            f"router: routed={rt.get('routed_total')}"
            f" retried={rt.get('retried_total')}"
            f" failed={rt.get('failed_total')}"
            f" actions/s={_fmt(rt.get('actions_per_sec'), 1)}"
            f" p50={_fmt(rt.get('latency_p50_ms'))}ms"
            f" p99={_fmt(rt.get('latency_p99_ms'))}ms"
        )
        replicas = rt.get("replicas") or {}
        if replicas:
            out.append(format_table(
                [
                    [
                        rid,
                        row.get("last_state"),
                        row.get("requests"),
                        _fmt(row.get("p50_ms")),
                        row.get("deaths"),
                        row.get("restarts"),
                    ]
                    for rid, row in sorted(replicas.items())
                ],
                ["replica", "state", "requests", "p50_ms", "deaths",
                 "restarts"],
            ))
        sc = rt.get("scaling") or {}
        if sc.get("replicas"):
            out.append(
                f"scaling: replicas={sc.get('replicas')}"
                "  actions/s/replica="
                + _fmt(sc.get("actions_per_sec_per_replica"), 1)
                + f"  balance={_fmt(sc.get('balance'))}"
            )
        sess = rt.get("sessions") or {}
        if sess:
            out.append(
                "sessions: "
                + ", ".join(f"{k}×{v}" for k, v in sess.items())
            )
        fo = rt.get("failover") or {}
        if fo:
            out.append(
                f"failover: resumed={fo.get('resumed')}"
                f" restarted_fresh={fo.get('restarted_fresh')}"
                f" resumed_fraction={_fmt(fo.get('resumed_fraction'))}"
                f" journal_lag_mean={_fmt(fo.get('journal_lag_mean'))}"
                f" journal_lag_max={fo.get('journal_lag_max')}"
            )
        asr = rt.get("autoscale") or {}
        if asr:
            reasons = asr.get("shed_reasons") or {}
            out.append(
                f"autoscale: scale_out={asr.get('scale_out')}"
                f" drain_completed={asr.get('drain_completed')}"
                f" drain_aborted={asr.get('drain_aborted')}"
                f" sessions_moved={asr.get('sessions_moved')}"
                f" sheds={asr.get('shed_total')}"
                + (
                    " ("
                    + ", ".join(f"{k}×{v}" for k, v in reasons.items())
                    + ")"
                    if reasons else ""
                )
                + f" drain_max={_fmt(asr.get('drain_duration_max_s'))}s"
            )
        hosts = rt.get("hosts") or {}
        if hosts:
            out.append(format_table(
                [
                    [host, ",".join(row.get("replicas") or []) or "-",
                     row.get("deaths"), row.get("lease_expired"),
                     row.get("last_state") or "-"]
                    for host, row in sorted(hosts.items())
                ],
                ["host", "replicas", "deaths", "lease_expired", "state"],
            ))
        ls = rt.get("lease") or {}
        if ls:
            out.append(
                f"lease: granted={ls.get('granted')}"
                f" renewed={ls.get('renewed')}"
                f" expired={ls.get('expired')}"
                f" fenced_writes={ls.get('fenced_write_refused')}"
                f" (sessions={ls.get('fenced_sessions')})"
                + (
                    f"  partitions={ls.get('partitions_injected')}"
                    f" (max {_fmt(ls.get('partition_seconds_max'))}s)"
                    if ls.get("partitions_injected") else ""
                )
            )
        cn = rt.get("canary") or {}
        if cn:
            out.append(
                f"canary: started={cn.get('started')}"
                f" promoted={cn.get('promoted')}"
                f" rolled_back={cn.get('rolled_back')}"
            )
            steps = cn.get("steps") or {}
            if steps:
                out.append(format_table(
                    [
                        [step, row.get("replica"), row.get("outcome"),
                         row.get("reason") or ""]
                        for step, row in sorted(
                            steps.items(), key=lambda kv: _rung_key(kv[0])
                        )
                    ],
                    ["step", "canary", "outcome", "reason"],
                ))
        ep = rt.get("episodes") or {}
        if ep:
            out.append(
                f"episodes: served={ep.get('episodes')}"
                f" mean_return={_fmt(ep.get('mean_return'))}"
                f" steps={ep.get('steps_total')}"
            )
        pm = rt.get("promote") or {}
        if pm:
            out.append(
                f"promote: candidates={pm.get('candidates')}"
                f" promoted={pm.get('promoted')}"
                f" rejected={pm.get('rejected')}"
                f" rolled_back={pm.get('rolled_back')}"
                + (
                    f"  feedback={pm.get('feedback_episodes')}eps"
                    f" mean={_fmt(pm.get('feedback_mean_return'))}"
                    if pm.get("feedback_episodes") else ""
                )
            )
            steps = pm.get("steps") or {}
            if steps:
                out.append(format_table(
                    [
                        [step, row.get("member"), row.get("outcome"),
                         row.get("reason") or ""]
                        for step, row in sorted(
                            steps.items(), key=lambda kv: _rung_key(kv[0])
                        )
                    ],
                    ["step", "member", "outcome", "reason"],
                ))
    tr = summary.get("traces") or {}
    if tr:
        out.append("")
        out.append(
            f"traces: {tr.get('count')} assembled={tr.get('assembled')}"
            f" spans={tr.get('spans')}"
            f" root_p50={_fmt(tr.get('root_p50_ms'))}ms"
            f" root_p99={_fmt(tr.get('root_p99_ms'))}ms"
        )
        stages = tr.get("stages") or {}
        if stages:
            out.append(format_table(
                [
                    [
                        stage,
                        row.get("traces"),
                        _fmt(row.get("p50_ms")),
                        _fmt(row.get("p99_ms")),
                        "-" if row.get("share") is None
                        else f"{row['share'] * 100:.1f}%",
                    ]
                    for stage, row in stages.items()
                ],
                ["stage", "traces", "p50_ms", "p99_ms", "share"],
            ))
        wire = tr.get("wire") or {}
        if wire:
            out.append(format_table(
                [
                    [
                        key,
                        row.get("hops"),
                        _fmt(row.get("hop_p50_ms")),
                        _fmt(row.get("hop_p99_ms")),
                        _fmt(row.get("network_p50_ms")),
                        _fmt(row.get("network_p99_ms")),
                    ]
                    for key, row in wire.items()
                ],
                [
                    "wire", "hops", "hop_p50", "hop_p99",
                    "net_p50", "net_p99",
                ],
            ))
        slowest = tr.get("slowest") or []
        if slowest:
            out.append(format_table(
                [
                    [
                        row.get("trace"),
                        row.get("root"),
                        _fmt(row.get("root_ms")),
                        ", ".join(
                            f"{k}={v:.1f}"
                            for k, v in (row.get("stages") or {}).items()
                        ),
                    ]
                    for row in slowest
                ],
                ["slowest trace", "root", "ms", "stage breakdown (ms)"],
            ))
    sp = summary.get("solver_precision") or {}
    if sp:
        out.append("")
        out.append(
            f"solver precision: audits={sp.get('audit_runs')}"
            f" fallbacks={sp.get('fallbacks')}"
            f" cosine_min={_fmt(sp.get('solve_cosine_min'), 5)}"
            f" cosine_mean={_fmt(sp.get('solve_cosine_mean'), 5)}"
            f" cg_budget={sp.get('cg_budget_final')}"
            + ("  PINNED-AT-F32" if sp.get("pinned") else "")
        )
    fleet = summary.get("fleet") or {}
    if fleet:
        out.append("")
        out.append(
            "fleet: "
            + ", ".join(
                f"{k}×{v}" for k, v in (fleet.get("counts") or {}).items()
            )
        )
        out.append(format_table(
            [
                [mid, row.get("last_state"), row.get("attempts"),
                 row.get("requeues")]
                for mid, row in sorted((fleet.get("members") or {}).items())
            ],
            ["member", "state", "attempts", "requeues"],
        ))
    al = summary.get("alerts") or {}
    if al:
        out.append("")
        out.append(
            f"alerts: fired={al.get('fired_total')}"
            f" resolved={al.get('resolved_total')}"
            f" active={al.get('active_total')}"
            f" false_positives={al.get('false_positives')}"
            f" detect_mean={_fmt(al.get('time_to_detect_mean_s'))}s"
        )
        out.append(format_table(
            [
                [rule, row.get("fired"), row.get("resolved"),
                 row.get("active"),
                 "-" if row.get("detect_s") is None
                 else _fmt(row["detect_s"])]
                for rule, row in (al.get("rules") or {}).items()
            ],
            ["rule", "fired", "resolved", "active", "detect_s"],
        ))
    mem = summary.get("memory") or {}
    progs = mem.get("programs") or {}
    if progs or mem.get("peak_live_buffer_bytes") is not None:
        # the port has no compiled program to account (obs/memory.py):
        # its footprint column reads n/a, never a guess
        out.append(
            "memory: peak_live="
            + _fmt_bytes(mem.get("peak_live_buffer_bytes"))
            + ("" if progs else " compiled=n/a")
        )
        if progs:
            out.append(format_table(
                [
                    [
                        name,
                        _fmt_bytes(f.get("argument_bytes")),
                        _fmt_bytes(f.get("temp_bytes")),
                        _fmt_bytes(f.get("output_bytes")),
                        _fmt_bytes(f.get("peak_estimate_bytes")),
                    ]
                    for name, f in sorted(progs.items())
                ],
                ["program", "args", "temp", "output", "peak_est"],
            ))
    return "\n".join(out)


def render_comparison(result: dict) -> str:
    rows = []
    for v in result["verdicts"]:
        base, new = v["base"], v["new"]
        is_bytes = v["metric"].startswith("memory/")
        fmt = _fmt_bytes if is_bytes else _fmt
        rows.append([
            v["metric"],
            fmt(base),
            fmt(new),
            "-" if v["delta_pct"] is None else f"{v['delta_pct']:+.1f}%",
            v["verdict"].upper() if v["verdict"] == "regressed"
            else v["verdict"],
        ])
    table = format_table(
        rows, ["metric", "base", "new", "delta", "verdict"]
    )
    tail = (
        f"\nREGRESSED (threshold {result['threshold_pct']:g}%)"
        if result["regressed"]
        else f"\nOK (threshold {result['threshold_pct']:g}%)"
    )
    return table + tail
