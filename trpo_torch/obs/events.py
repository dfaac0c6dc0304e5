"""The run-event bus: typed, versioned JSONL records with pluggable sinks
(counterpart: ``trpo_tpu/obs/events.py``, copied: the port imports nothing
of the reference package).

Every record is a flat JSON object with a versioned envelope (``v``,
``kind``, ``t``); :func:`validate_event` is the one source of truth for
what each kind requires. The schema is the reference's, unchanged
(``SCHEMA_VERSION`` 1, ``schema: "trpo-tpu-events"`` in the manifest), so
the reference's offline tools (``scripts/validate_events.py``,
``scripts/analyze_run.py``) read the port's logs, as the port's own copies
do (``python -m trpo_torch.scripts.validate_events``); the kinds and their
fields are documented in the reference module.

One stated difference, in :func:`manifest_fields`: the port has no jax.
``run_manifest`` keeps the required ``jax_version`` field (the
reference's validator requires a string) with the value ``"n/a"``, and
adds ``torch_version``, ``cuda_version`` (None on a CPU build),
``device_name`` and ``device_count``; ``backend`` is ``"cuda"`` or
``"cpu"``, the device the run was given.

Sinks are append-only and flush-on-write; :class:`JsonlSink` repairs a
crash-cut final line on open (``utils/metrics.repair_jsonl_tail``).
``EventBus.emit`` is thread-safe: the async driver's drain thread emits
iteration events while the main thread emits the others.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import IO, Any, Callable, Iterable, Optional

from trpo_torch.utils.metrics import repair_jsonl_tail

__all__ = [
    "SCHEMA_VERSION",
    "EVENT_KINDS",
    "FLEET_STATES",
    "ROUTER_REPLICA_STATES",
    "ROUTER_HOST_STATES",
    "SESSION_EVENTS",
    "CANARY_EVENTS",
    "PROMOTE_EVENTS",
    "AUTOSCALE_EVENTS",
    "LEASE_EVENTS",
    "ALERT_STATES",
    "EventBus",
    "JsonlSink",
    "ConsoleSink",
    "validate_event",
    "manifest_fields",
]

SCHEMA_VERSION = 1

# member lifecycle states the fleet orchestrator may record (the state
# machine lives in fleet/scheduler.py; the vocabulary lives HERE so the
# validator needs no fleet import)
FLEET_STATES = (
    "launched", "preempted", "requeued", "finished", "failed", "culled",
    "respawned",
)

# replica lifecycle states the serving replica supervisor may record
# (the state machine lives in serve/replicaset.py; the vocabulary lives
# HERE so the validator needs no serve import — the FLEET_STATES pattern).
# `draining`/`drained` are the elastic scale-in states: a
# draining replica leaves stateless rotation while its sessions resume
# elsewhere; `drained` is the terminal record of a session-empty replica
# leaving the set.
ROUTER_REPLICA_STATES = (
    "started", "healthy", "reloading", "draining", "drained", "died",
    "evicted", "restarted", "failed",
)

# session lifecycle transitions the recurrent serving protocol records
# (stores live in serve/session.py, router affinity in serve/router.py);
# `resumed` = re-created from a journaled carry (lossless failover),
# `reestablished` = the fresh-carry fallback when no journal entry
# existed — the discriminator the failover report reads; `drained`
# = the same lossless journal move performed ON PURPOSE by
# a scale-in drain, kept distinct so planned migrations never inflate
# the failover-quality metrics
SESSION_EVENTS = (
    "created", "resumed", "reestablished", "expired", "evicted",
    "drained", "episode",
)

# gated-deployment transitions the canary controller records (the state
# machine lives in serve/replicaset.CanaryController; the vocabulary
# lives HERE so the validator needs no serve import — the FLEET_STATES
# pattern). `started` must resolve to `promoted` or `rolled_back`.
CANARY_EVENTS = ("started", "promoted", "rolled_back")

# train→serve promotion transitions the flywheel controller records
# (the state machine lives in fleet/promote.PromotionController; the
# vocabulary lives HERE so the validator needs no fleet import — the
# FLEET_STATES pattern). `candidate` must resolve to a same-step
# `promoted` / `rejected` / `rolled_back` terminal — possibly by a
# RESTARTED controller converging a predecessor's half-done promotion;
# `feedback` books served realized-return stats for fleet re-scoring.
PROMOTE_EVENTS = (
    "candidate", "canary", "promoted", "rejected", "rolled_back",
    "feedback",
)

# elastic-serving control actions (serve/autoscaler.py and
# the router's overload sheds; vocabulary HERE so the validator needs
# no serve import). `drain_started` must resolve to a same-replica
# `drain_completed` or `drain_aborted`.
AUTOSCALE_EVENTS = (
    "scale_out", "drain_started", "drain_completed", "drain_aborted",
    "shed",
)

# host health transitions in the multi-host serving plane (the state machine lives in serve/replicaset.py; vocabulary HERE so
# the validator needs no serve import — the FLEET_STATES pattern).
# `suspect` = transport strikes accumulated: the host's replicas are
# held out of NEW session placement while the lease decides.
ROUTER_HOST_STATES = ("suspect", "healthy")

# lease-liveness transitions (serve/replicaset.py grants/
# renews/expires; serve/session.CarryJournal emits the fencing
# refusals). `expired` must resolve to the replica's died/evicted (or
# a re-grant after the partition heals) — the died-needs-terminal
# pattern.
LEASE_EVENTS = ("granted", "renewed", "expired", "fenced_write_refused")

# Shadow-replay lifecycle (scripts/replay_run.py): `begin`
# announces the bundle and how many captured acts it will drive, one
# `act` per replayed request, one `verdict` per bit-exact action diff,
# `complete` closes with the tallies — the validator pairs them.
REPLAY_EVENTS = ("begin", "act", "verdict", "complete")

# alert lifecycle (obs/alerts.AlertEngine; vocabulary HERE
# so the validator needs no obs.alerts import — the FLEET_STATES
# pattern). Every `firing` must resolve to a later `resolved` for the
# same (rule, target) — the started-needs-terminal pattern.
ALERT_STATES = ("firing", "resolved")

_SCALAR = (bool, int, float, str, type(None))

# kind -> {field: predicate}; extra fields are always allowed (the schema
# is versioned and additive — readers must tolerate fields they don't know)
_REQUIRED = {
    "run_manifest": {
        "schema": lambda v: v == "trpo-tpu-events",
        "jax_version": lambda v: isinstance(v, str),
        "backend": lambda v: isinstance(v, str),
        "config_hash": lambda v: isinstance(v, str) and len(v) >= 8,
        "config": lambda v: v is None or isinstance(v, dict),
    },
    "iteration": {
        "iteration": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "stats": lambda v: isinstance(v, dict)
        and all(isinstance(x, _SCALAR) for x in v.values()),
    },
    "phase": {
        "name": lambda v: isinstance(v, str) and v,
        "ms": lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool),
    },
    "health": {
        "check": lambda v: isinstance(v, str) and v,
        "level": lambda v: v in ("info", "warn", "error"),
        "message": lambda v: isinstance(v, str),
    },
    "recompile": {
        "program": lambda v: isinstance(v, str) and v,
        "count": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "unexpected": lambda v: isinstance(v, bool),
    },
    "fault_injected": {
        "fault": lambda v: isinstance(v, str) and v,
        "at": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "spec": lambda v: isinstance(v, str) and v,
    },
    "recovery": {
        "action": lambda v: isinstance(v, str) and v,
        "reason": lambda v: isinstance(v, str) and v,
        "iteration": lambda v: isinstance(v, int)
        and not isinstance(v, bool),
    },
    "memory": {
        "scope": lambda v: v in ("program", "live"),
    },
    "status": {
        "port": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and 0 < v < 65536,
    },
    "serve": {
        # one record per micro-batch the serving tier dispatched
        # (serve/batcher.py): how many real requests coalesced, which
        # ladder rung the batch padded to, what was left waiting, and
        # the oldest coalesced request's end-to-end latency
        "requests": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 1,
        "padded": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 1,
        "queue_depth": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
        "latency_ms": lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool)
        and v >= 0,
    },
    "fleet": {
        # one member lifecycle transition (fleet/scheduler.py): member
        # id, the state entered, and the 1-based launch attempt it
        # happened on (0 for records before any launch)
        "member": lambda v: isinstance(v, str) and v,
        "state": lambda v: v in FLEET_STATES,
        "attempt": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
    },
    "router": {
        # scope-discriminated (like `memory`): "replica" lifecycle
        # transitions vs per-"request" routing records vs per-"host"
        # health transitions — the per-scope required
        # fields live in _ROUTER_SCOPED below
        "scope": lambda v: v in ("replica", "request", "host"),
    },
    "lease": {
        # one lease-liveness transition ; per-event required
        # fields (epoch on lifecycle records, session on fencing
        # refusals) live in _LEASE_SCOPED below. `host` rides along as
        # an optional field on multi-host records.
        "replica": lambda v: isinstance(v, str) and v,
        "event": lambda v: v in LEASE_EVENTS,
    },
    "session": {
        # one session lifecycle transition (serve/session.py store,
        # serve/router.py affinity); `replica` rides along as an
        # optional field, `steps`/`lag` on resumed records
        "session": lambda v: isinstance(v, str) and v,
        "event": lambda v: v in SESSION_EVENTS,
    },
    "canary": {
        # one gated-deployment transition
        # (serve/replicaset.CanaryController); `reason` rides along on
        # rolled_back records
        "step": lambda v: isinstance(v, int) and not isinstance(v, bool),
        "event": lambda v: v in CANARY_EVENTS,
        "replica": lambda v: isinstance(v, str) and v,
    },
    "promote": {
        # one train→serve promotion transition
        # (fleet/promote.PromotionController): source fleet member,
        # the serving-side step the weights publish as, lifecycle
        # event; `src_step`/`reason`/`score`/`episodes`/`mean_return`
        # ride along as optional fields
        "member": lambda v: isinstance(v, str) and v,
        "event": lambda v: v in PROMOTE_EVENTS,
        "step": lambda v: isinstance(v, int) and not isinstance(v, bool),
    },
    "span": {
        # one finished request-trace span (obs/trace.py);
        # `parent`/`remote`/`process`/`host` and stage attrs ride
        # along as optional fields. dur_ms is REQUIRED but nullable:
        # None marks a span that was never terminated — representable
        # so the validator can FAIL an unterminated root instead of
        # the failure mode being an invisible missing record.
        "trace": lambda v: isinstance(v, str) and 8 <= len(v) <= 64,
        "span": lambda v: isinstance(v, str) and v,
        "name": lambda v: isinstance(v, str) and v,
        "start": lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool)
        and v >= 0,
        "dur_ms": lambda v: v is None
        or (
            isinstance(v, (int, float))
            and not isinstance(v, bool)
            and v >= 0
        ),
    },
    "autoscale": {
        # one elastic-serving control action (serve/autoscaler.py /
        # the router's overload sheds); every record says WHY — the
        # trigger metrics (p99_ms, inflight, pressure) ride along as
        # optional fields. Per-event required fields (replica on
        # scale/drain records, count on sheds) live in
        # _AUTOSCALE_SCOPED below.
        "event": lambda v: v in AUTOSCALE_EVENTS,
        "reason": lambda v: isinstance(v, str) and v,
    },
    "capture": {
        # one captured request (obs/capture.py): the
        # replayable inputs of one sampled/forced request — path,
        # arrival order, answered status. `payload` (the base64
        # wire-frame obs), `session`, `seq`, `step` (the answering
        # replica's loaded checkpoint step), `action` (the answered
        # action — the replay diff's recorded side), `replica`,
        # `forced`, and the writer's `process`/`host` stamps ride
        # along as optional fields: a body the writer could not parse
        # still produces a record (the bundle builder reports it as
        # non-replayable instead of the miss being invisible).
        "trace": lambda v: isinstance(v, str) and 8 <= len(v) <= 64,
        "order": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
        "path": lambda v: isinstance(v, str) and v.startswith("/"),
        "endpoint": lambda v: v in ("act", "session_act"),
        "status": lambda v: isinstance(v, int) and not isinstance(v, bool),
    },
    "replay": {
        # one shadow-replay lifecycle record (# scripts/replay_run.py); per-event required fields live in
        # _REPLAY_SCOPED below. The validator's replay-complete
        # contracts pair these: every captured act announced by
        # `begin` must have an `act` record, every `act` its diff
        # `verdict`.
        "event": lambda v: v in REPLAY_EVENTS,
    },
    "metric_sample": {
        # one polled value of one series on one scrape target (obs/aggregate.MetricsAggregator). `value` is nullable:
        # a failed scrape still produces the target's `up` sample
        # (value 0.0) and marks it `stale` — the miss is representable
        # instead of invisible. `stale` rides along as an optional
        # bool.
        "target": lambda v: isinstance(v, str) and v,
        "series": lambda v: isinstance(v, str) and v,
        "value": lambda v: v is None
        or (isinstance(v, (int, float)) and not isinstance(v, bool)),
    },
    "alert": {
        # one alert-lifecycle transition (# obs/alerts.AlertEngine); per-state required fields (the
        # evaluation evidence on firing records) live in
        # _ALERT_SCOPED below. `target` (which scrape target the rule
        # fired for) rides along as an optional field.
        "rule": lambda v: isinstance(v, str) and v,
        "state": lambda v: v in ALERT_STATES,
    },
}

_BYTES = lambda v: isinstance(v, int) and not isinstance(v, bool) and v >= 0

# memory events are scope-discriminated: the per-scope required fields
# (checked by validate_event after the flat table above passes)
_MEMORY_SCOPED = {
    "program": {
        "program": lambda v: isinstance(v, str) and v,
        "argument_bytes": _BYTES,
        "output_bytes": _BYTES,
        "temp_bytes": _BYTES,
    },
    "live": {
        "iteration": lambda v: isinstance(v, int)
        and not isinstance(v, bool),
        "live_buffer_bytes": _BYTES,
    },
}

# router events are scope-discriminated the same way (checked by
# validate_event after the flat table above passes)
_ROUTER_SCOPED = {
    "replica": {
        "replica": lambda v: isinstance(v, str) and v,
        "state": lambda v: v in ROUTER_REPLICA_STATES,
    },
    "request": {
        "ms": lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool)
        and v >= 0,
        "ok": lambda v: isinstance(v, bool),
        "retried": lambda v: isinstance(v, bool),
    },
    "host": {
        "host": lambda v: isinstance(v, str) and v,
        "state": lambda v: v in ROUTER_HOST_STATES,
    },
}

_INT = lambda v: isinstance(v, int) and not isinstance(v, bool)

# lease events are EVENT-discriminated (the autoscale pattern): the
# lifecycle records carry the lease's epoch number; a fencing refusal
# names the session whose write was dropped
_LEASE_SCOPED = {
    "granted": {"epoch": _INT},
    "renewed": {"epoch": _INT},
    "expired": {"epoch": _INT},
    "fenced_write_refused": {
        "session": lambda v: isinstance(v, str) and v,
    },
}

# autoscale events are EVENT-discriminated the same way: scale/drain
# actions name the replica they act on (the validator's drain-terminal
# pairing needs it); sheds aggregate and carry how many they stand for
_AUTOSCALE_SCOPED = {
    "scale_out": {"replica": lambda v: isinstance(v, str) and v},
    "drain_started": {"replica": lambda v: isinstance(v, str) and v},
    "drain_completed": {"replica": lambda v: isinstance(v, str) and v},
    "drain_aborted": {"replica": lambda v: isinstance(v, str) and v},
    "shed": {
        "count": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 1,
    },
}

# replay events are EVENT-discriminated: begin/complete carry the
# tallies the validator's replay-complete pairing counts against, each
# act/verdict names the captured request it answers by (trace, order)
_REPLAY_SCOPED = {
    "begin": {
        "acts": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
    },
    "act": {
        "trace": lambda v: isinstance(v, str) and 8 <= len(v) <= 64,
        "order": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
        "status": _INT,
    },
    "verdict": {
        "trace": lambda v: isinstance(v, str) and 8 <= len(v) <= 64,
        "order": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
        "match": lambda v: isinstance(v, bool),
    },
    "complete": {
        "acts": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
        "mismatches": lambda v: isinstance(v, int)
        and not isinstance(v, bool)
        and v >= 0,
    },
}

# alert records are STATE-discriminated: a firing alert must carry its
# evaluation evidence (the window it was judged over, the observed
# value, the threshold it breached) — the validator's zero-false-
# positive contract reads them; `resolved` needs nothing extra beyond
# naming the rule it closes.
_NUM = (
    lambda v: isinstance(v, (int, float))
    and not isinstance(v, bool)
)
_ALERT_SCOPED = {
    "firing": {
        "window_s": lambda v: _NUM(v) and v >= 0,
        "value": _NUM,
        "threshold": _NUM,
    },
    "resolved": {},
}

EVENT_KINDS = tuple(sorted(_REQUIRED))


def validate_event(rec: Any) -> list:
    """Schema-check one event record; returns a list of error strings
    (empty = valid). Works on freshly built records and on records parsed
    back from JSONL — the round-trip invariant the tests pin."""
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    errs = []
    if rec.get("v") != SCHEMA_VERSION:
        errs.append(f"v must be {SCHEMA_VERSION}, got {rec.get('v')!r}")
    if not isinstance(rec.get("t"), (int, float)) or isinstance(
        rec.get("t"), bool
    ):
        errs.append("t (unix seconds) missing or non-numeric")
    kind = rec.get("kind")
    required = _REQUIRED.get(kind)
    if required is None:
        errs.append(f"unknown kind {kind!r} (have {list(EVENT_KINDS)})")
        return errs
    for field, ok in required.items():
        if field not in rec:
            errs.append(f"{kind}: missing required field {field!r}")
        elif not ok(rec[field]):
            errs.append(f"{kind}: field {field!r} failed its check "
                        f"(got {rec[field]!r})")
    for scoped_kind, discriminator, table in (
        ("memory", "scope", _MEMORY_SCOPED),
        ("router", "scope", _ROUTER_SCOPED),
        ("autoscale", "event", _AUTOSCALE_SCOPED),
        ("lease", "event", _LEASE_SCOPED),
        ("replay", "event", _REPLAY_SCOPED),
        ("alert", "state", _ALERT_SCOPED),
    ):
        if kind != scoped_kind:
            continue
        # discriminated record: each scope/event has its own required set
        tag = rec.get(discriminator)
        for field, ok in table.get(tag, {}).items():
            if field not in rec:
                errs.append(
                    f"{kind}[{tag}]: missing required field {field!r}"
                )
            elif not ok(rec[field]):
                errs.append(
                    f"{kind}[{tag}]: field {field!r} failed "
                    f"its check (got {rec[field]!r})"
                )
    return errs


def _json_safe(x):
    """Recursively coerce numpy scalars, 0-d tensors, tuples, and unknown
    objects into JSON-representable values (the bus sanitizes every record
    before validating/writing, so callers may pass device scalars
    directly)."""
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, _SCALAR):
        return x
    if hasattr(x, "item"):
        try:
            return _json_safe(x.item())
        except Exception:
            return str(x)
    return str(x)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class JsonlSink:
    """Append events to a JSONL file: crash-safe open (a partial final
    line from a killed previous run is truncated away first), one
    ``write`` call per record, flush-on-write."""

    def __init__(self, path: str):
        self.path = path
        repair_jsonl_tail(path)
        self._f: Optional[IO] = open(path, "a")

    def write(self, rec: dict) -> None:
        if self._f is None:
            raise RuntimeError(f"JsonlSink({self.path}) is closed")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write_batch(self, recs: list) -> None:
        """Many records, ONE file write + flush : the trace
        writer drains dozens of spans per wake, and per-record
        write+flush under the bus lock measurably stalls the serving
        dispatcher threads contending for it. Same crash semantics —
        a torn tail still repairs on the next open."""
        if self._f is None:
            raise RuntimeError(f"JsonlSink({self.path}) is closed")
        self._f.write("".join(json.dumps(r) + "\n" for r in recs))
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ConsoleSink:
    """One-line console rendering, optionally restricted to a set of
    kinds (the CLI's ``--health-checks`` prints health/recompile findings
    without drowning stdout in per-iteration records)."""

    def __init__(self, stream: Optional[IO] = None,
                 kinds: Optional[Iterable[str]] = None):
        self.stream = stream
        self.kinds = None if kinds is None else frozenset(kinds)

    def write(self, rec: dict) -> None:
        if self.kinds is not None and rec.get("kind") not in self.kinds:
            return
        stream = self.stream if self.stream is not None else sys.stderr
        body = {k: v for k, v in rec.items() if k not in ("v", "kind", "t")}
        print(f"[obs:{rec.get('kind')}] {json.dumps(body)}", file=stream)

    def close(self) -> None:
        pass


class _CallbackSink:
    def __init__(self, fn: Callable[[dict], Any]):
        self._fn = fn

    def write(self, rec: dict) -> None:
        self._fn(rec)

    def close(self) -> None:
        pass


class EventBus:
    """Validated, thread-safe fan-out of event records to sinks.

    Sinks are objects with ``write(rec)``/``close()`` or bare callables
    (wrapped). ``emit`` sanitizes the record (numpy scalars and tensors → Python),
    validates it against the schema (raising on failure — an invalid
    event is a bug in the emitter, never data), then writes to every sink
    under one lock so concurrent emitters (main loop, drain thread,
    logging handlers) interleave whole records, not bytes."""

    def __init__(self, *sinks):
        self._sinks = [self._wrap(s) for s in sinks]
        self._lock = threading.Lock()

    @staticmethod
    def _wrap(sink):
        return sink if hasattr(sink, "write") else _CallbackSink(sink)

    def add_sink(self, sink) -> None:
        with self._lock:
            self._sinks.append(self._wrap(sink))

    def emit(self, kind: str, **fields) -> dict:
        rec = _json_safe(
            {"v": SCHEMA_VERSION, "kind": kind, "t": time.time(), **fields}
        )
        errs = validate_event(rec)
        if errs:
            raise ValueError(f"invalid {kind!r} event: {errs}")
        with self._lock:
            for s in self._sinks:
                s.write(rec)
        return rec

    def emit_batch(self, kind: str, fields_list) -> list:
        """Emit many same-kind records, holding the sink lock ONCE and
        letting batch-capable sinks (``JsonlSink.write_batch``) write
        them in one IO call (the trace writer's drain — the
        per-record flush was the measurable hot-path cost). Records are
        sanitized and validated exactly as :meth:`emit` would."""
        recs = []
        for fields in fields_list:
            rec = _json_safe(
                {"v": SCHEMA_VERSION, "kind": kind, "t": time.time(),
                 **fields}
            )
            errs = validate_event(rec)
            if errs:
                raise ValueError(f"invalid {kind!r} event: {errs}")
            recs.append(rec)
        if not recs:
            return recs
        with self._lock:
            for s in self._sinks:
                batch = getattr(s, "write_batch", None)
                if batch is not None:
                    batch(recs)
                else:
                    for rec in recs:
                        s.write(rec)
        return recs

    def close(self) -> None:
        with self._lock:
            for s in self._sinks:
                s.close()
            self._sinks = []


# ---------------------------------------------------------------------------
# run manifest
# ---------------------------------------------------------------------------


def _git_sha() -> Optional[str]:
    """Repo HEAD sha, or None (not a checkout, no git binary, …) — the
    manifest must never fail a run over provenance lookup."""
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5, cwd=root,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def manifest_fields(config: Any = None, extra: Optional[dict] = None,
                    device: Any = None) -> dict:
    """The ``run_manifest`` payload: config (dataclass or dict) + a stable
    hash of it, torch/CUDA/device info, git sha. ``device`` is the run's
    device (``"cuda"`` when None and CUDA is available, else ``"cpu"``).
    ``extra`` merges on top (driver name, env id, …). ``jax_version`` is
    ``"n/a"``: the field is required by the schema, and the port has no
    jax (module docstring)."""
    import dataclasses

    import torch

    cfg_dict = None
    if config is not None:
        cfg_dict = (
            dataclasses.asdict(config)
            if dataclasses.is_dataclass(config)
            else dict(config)
        )
        cfg_dict = _json_safe(cfg_dict)
    payload = json.dumps(cfg_dict, sort_keys=True, default=str)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    cuda = device.type == "cuda"
    fields = {
        "schema": "trpo-tpu-events",
        "jax_version": "n/a",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": device.type,
        "device_name": torch.cuda.get_device_name(device) if cuda
        else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "config": cfg_dict,
        "config_hash": hashlib.sha256(payload.encode()).hexdigest()[:16],
        "git_sha": _git_sha(),
    }
    if extra:
        fields.update(_json_safe(extra))
    return fields
