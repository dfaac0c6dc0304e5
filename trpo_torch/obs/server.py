"""Live status/metrics endpoint: look at a long run while it runs
(counterpart: ``trpo_tpu/obs/server.py``).

A :class:`StatusSink` rides the event bus like any other sink, folding
each record into a small in-memory model of the run (manifest, current
iteration row, phase timings, health findings, builds and captures,
memory gauges) and publishing it as an immutable snapshot dict — one
reference swap per event, so the HTTP side never holds the bus's lock.
:class:`StatusServer` serves it on a background daemon thread
(``utils/httpd.BackgroundHTTPServer``):

* ``GET /status``  — the full JSON snapshot;
* ``GET /metrics`` — the same gauges and counters in Prometheus text
  (:func:`render_prometheus`, byte-identical to the reference's for the
  same snapshot).

Contracts: the sink and server exist only when ``--status-port`` /
``cfg.status_port`` is given (no thread, no socket otherwise); ``write``
never blocks on a reader; port 0 is ephemeral, and the bound port is
``StatusServer.port``, printed by the CLI and announced as a ``status``
event after the manifest. The manifest's identity card carries the
port's ``torch_version``/``cuda_version``/``device_name`` beside the
reference's keys.
"""

from __future__ import annotations

import json
import threading
import time
from collections import Counter, deque
from typing import Optional

from trpo_torch.utils.exposition import _esc, _fmt, _json_safe
from trpo_torch.utils.httpd import BackgroundHTTPServer

__all__ = ["StatusSink", "StatusServer", "render_prometheus"]

_SNAPSHOT_SCHEMA = "trpo-tpu-status"

# manifest fields worth surfacing (the full config is in the event log;
# the status page wants the identity card, not the whole dataclass)
_MANIFEST_KEYS = (
    "config_hash", "jax_version", "backend", "device_count", "git_sha",
    "driver", "n_iterations", "torch_version", "cuda_version",
    "device_name",
)


class StatusSink:
    """Event-bus sink that maintains the live run snapshot.

    ``write`` is called under the bus lock (whole records, never bytes);
    all internal mutation happens under ``self._lock`` and ends with a
    swap of ``self.snapshot`` — readers take the reference and go.
    Gauges that do not travel over the bus (the async driver's drain
    depth) are pushed in via :meth:`set_gauges`.
    """

    def __init__(self, max_health: int = 20):
        self._lock = threading.Lock()
        self._started_t = time.time()
        self._manifest: Optional[dict] = None
        self._iteration: Optional[int] = None
        self._iteration_t: Optional[float] = None
        self._stats: dict = {}
        self._phases: dict = {}
        self._health_counts: Counter = Counter()
        self._health_last: deque = deque(maxlen=max_health)
        self._recompiles = 0
        self._recompiles_unexpected = 0
        self._faults = 0
        self._events_total: Counter = Counter()
        self._drain: Optional[dict] = None
        self._mem_programs: dict = {}
        self._mem_live: Optional[dict] = None
        self._finished = False
        self.snapshot: dict = self._build()

    # -- bus sink protocol -------------------------------------------------

    def write(self, rec: dict) -> None:
        kind = rec.get("kind")
        with self._lock:
            self._events_total[kind] += 1
            if kind == "run_manifest":
                self._manifest = {
                    k: rec.get(k) for k in _MANIFEST_KEYS if k in rec
                }
            elif kind == "iteration":
                self._iteration = rec.get("iteration")
                self._iteration_t = rec.get("t")
                self._stats = dict(rec.get("stats") or {})
            elif kind == "phase":
                self._phases[rec.get("name")] = {
                    "ms": rec.get("ms"),
                    "calls": rec.get("calls"),
                    "total_s": rec.get("total_s"),
                }
            elif kind == "health":
                self._health_counts[
                    (rec.get("check"), rec.get("level"))
                ] += 1
                self._health_last.append({
                    "t": rec.get("t"),
                    "check": rec.get("check"),
                    "level": rec.get("level"),
                    "message": rec.get("message"),
                    "iteration": rec.get("iteration"),
                })
            elif kind == "recompile":
                self._recompiles += 1
                if rec.get("unexpected"):
                    self._recompiles_unexpected += 1
            elif kind == "fault_injected":
                self._faults += 1
            elif kind == "memory":
                if rec.get("scope") == "program":
                    self._mem_programs[rec.get("program")] = {
                        k: v
                        for k, v in rec.items()
                        if k.endswith("_bytes")
                    }
                else:
                    # "iteration" excluded: it has its own family
                    # (trpo_iteration) and is not a memory gauge
                    self._mem_live = {
                        k: v
                        for k, v in rec.items()
                        if k not in ("v", "kind", "t", "scope",
                                     "iteration")
                    }
            # unknown kinds still count in events_total: readers tolerate,
            # only the strict validator rejects
            self.snapshot = self._build()

    def close(self) -> None:
        pass

    # -- non-bus gauges ----------------------------------------------------

    def set_gauges(self, **drain) -> None:
        """Host-side gauges with no event record (the StatsDrain queue's
        depth/high-water/bound) — pushed per iteration by ``Telemetry``."""
        with self._lock:
            self._drain = drain
            self.snapshot = self._build()

    def set_phases(self, summary: dict) -> None:
        """Live phase timings (``PhaseTimer.summary()`` rows, same keys
        as ``phase`` events) — pushed per iteration by ``Telemetry``,
        since the bus only carries phase events at ``finish_run``, when
        a mid-run scrape can no longer use them."""
        with self._lock:
            self._phases = {
                name: {
                    "ms": row.get("mean_ms"),
                    "calls": row.get("calls"),
                    "total_s": row.get("total_s"),
                }
                for name, row in summary.items()
            }
            self.snapshot = self._build()

    def mark_finished(self) -> None:
        with self._lock:
            self._finished = True
            self.snapshot = self._build()

    # -- snapshot ----------------------------------------------------------

    def _build(self) -> dict:
        """A fresh, immutable-by-convention snapshot dict. Every nested
        container is copied, so a handler serializing an OLD snapshot
        never races a newer ``write``."""
        return {
            "schema": _SNAPSHOT_SCHEMA,
            "started_t": self._started_t,
            "updated_t": time.time(),
            "manifest": dict(self._manifest) if self._manifest else None,
            "iteration": self._iteration,
            "iteration_t": self._iteration_t,
            "stats": dict(self._stats),
            "phases": {k: dict(v) for k, v in self._phases.items()},
            "drain": dict(self._drain) if self._drain else None,
            "health": {
                "counts": {
                    f"{check}:{level}": n
                    for (check, level), n in sorted(
                        self._health_counts.items()
                    )
                },
                "last": list(self._health_last),
            },
            "recompiles": {
                "total": self._recompiles,
                "unexpected": self._recompiles_unexpected,
            },
            "faults_injected": self._faults,
            "memory": {
                "programs": {
                    k: dict(v) for k, v in self._mem_programs.items()
                },
                "live": dict(self._mem_live) if self._mem_live else None,
            },
            "events_total": dict(self._events_total),
            "finished": self._finished,
        }


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _num(v):
    """Prometheus sample value, or None to skip (non-numeric)."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    return None


def render_prometheus(snap: dict) -> str:
    """The snapshot as Prometheus text format (version 0.0.4).

    Families: ``trpo_iteration``, every numeric stat of the current row
    as ``trpo_iteration_stat{stat=...}``, phase timings, event/health
    counters, recompiles, drain gauges, memory gauges, and
    ``trpo_run_finished``. NaN/±Inf are legal sample values and pass
    through (a reward with no finished episodes reads as NaN; the JSON
    side, where bare NaN tokens are invalid, serves null instead).
    """
    out = []

    def fam(name, mtype, help_, samples):
        rows = []
        for labels, value in samples:
            v = _num(value)
            if v is None:
                continue
            if labels:
                lbl = ",".join(
                    f'{k}="{_esc(v2)}"' for k, v2 in labels.items()
                )
                rows.append(f"{name}{{{lbl}}} {_fmt(v)}")
            else:
                rows.append(f"{name} {_fmt(v)}")
        if rows:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            out.extend(rows)

    stats = snap.get("stats") or {}
    if snap.get("iteration") is not None:
        fam("trpo_iteration", "gauge", "current training iteration",
            [({}, snap["iteration"])])
    fam(
        "trpo_iteration_stat", "gauge",
        "latest iteration's stats row (one sample per stat)",
        [({"stat": k}, v) for k, v in sorted(stats.items())],
    )
    fam(
        "trpo_phase_ms", "gauge", "per-phase mean milliseconds",
        [
            ({"phase": name}, row.get("ms"))
            for name, row in sorted((snap.get("phases") or {}).items())
        ],
    )
    fam(
        "trpo_events_total", "counter", "event records seen, by kind",
        [
            ({"kind": k}, n)
            for k, n in sorted((snap.get("events_total") or {}).items())
        ],
    )
    health = snap.get("health") or {}
    fam(
        "trpo_health_total", "counter", "health findings, by check:level",
        [
            ({"check": k}, n)
            for k, n in sorted((health.get("counts") or {}).items())
        ],
    )
    rec = snap.get("recompiles") or {}
    fam("trpo_recompile_total", "counter", "XLA compilations observed",
        [({}, rec.get("total", 0))])
    fam(
        "trpo_recompile_unexpected_total", "counter",
        "post-steady-state retraces (should be zero)",
        [({}, rec.get("unexpected", 0))],
    )
    fam("trpo_faults_injected_total", "counter", "chaos faults fired",
        [({}, snap.get("faults_injected", 0))])
    drain = snap.get("drain") or {}
    fam(
        "trpo_stats_drain", "gauge",
        "async stats-drain queue gauges (depth/high_water/maxsize)",
        [({"gauge": k}, v) for k, v in sorted(drain.items())],
    )
    mem = snap.get("memory") or {}
    live = mem.get("live") or {}
    fam(
        "trpo_memory_live", "gauge",
        "live device-memory gauges (bytes/counts)",
        [({"gauge": k}, v) for k, v in sorted(live.items())],
    )
    prog_samples = []
    for pname, fields in sorted((mem.get("programs") or {}).items()):
        for k, v in sorted(fields.items()):
            prog_samples.append(({"program": pname, "kind": k}, v))
    fam(
        "trpo_program_memory_bytes", "gauge",
        "compiled memory_analysis bytes per jitted program",
        prog_samples,
    )
    fam("trpo_run_finished", "gauge", "1 once learn() has finished",
        [({}, 1.0 if snap.get("finished") else 0.0)])
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


class StatusServer:
    """Background HTTP server over a :class:`StatusSink`.

    Binds ``host:port`` at construction (``port=0`` = OS-assigned; read
    the result from ``.port``) and serves on a daemon thread until
    :meth:`close` — the shared plumbing (daemon handler threads,
    silenced logs/errors, address reuse) lives in
    ``utils/httpd.BackgroundHTTPServer``, which the policy-serving
    front end (``serve/server.py``) reuses.
    """

    ENDPOINTS = ("/status", "/metrics")

    def __init__(self, sink: StatusSink, port: int,
                 host: str = "127.0.0.1"):
        self.sink = sink

        def _status():
            body = json.dumps(_json_safe(self.sink.snapshot)).encode()
            return 200, "application/json", body

        def _metrics():
            body = render_prometheus(self.sink.snapshot).encode()
            return 200, "text/plain; version=0.0.4; charset=utf-8", body

        self._httpd = BackgroundHTTPServer(
            port,
            host=host,
            get={"/": _status, "/status": _status, "/metrics": _metrics},
            not_found="have /status and /metrics",
            thread_name="obs-status-server",
        )
        self.host = host
        self.port = self._httpd.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.close()
