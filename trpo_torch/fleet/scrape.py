"""Fleet-wide introspection: scrape members, serve one fleet view
(counterpart: ``trpo_tpu/fleet/scrape.py``).

Every live member serves its own ``/status`` + ``/metrics``
(``obs/server.StatusServer``) on an ephemeral port, and announces that
port in a ``run.json`` descriptor (``trpo_torch.train
--run-descriptor``) so a scraper never parses console output. This
module is the consumption side:

* :func:`read_descriptor` — one process's ``run.json`` (atomic-written
  at startup; absent while the process is still importing torch — the
  scraper just tries again next interval). The serving tier's
  ``SubprocessReplica`` discovers its children through it too.
* :func:`scrape_member` — ``GET <status_url>/status`` with a short
  timeout, reduced to the fields a fleet view needs (iteration, steady
  timings, reward, health/recompile counts). A member mid-start or
  just-exited scrapes as ``None``; the fleet snapshot says so instead
  of going stale silently.
* :func:`render_fleet_prometheus` — the fleet snapshot as Prometheus
  text: per-member state (one-hot over the record states), attempt /
  requeue counters, and the scraped live gauges (iteration,
  iteration_ms, reward_running).
* :class:`FleetStatusServer` — ``/status`` + ``/metrics`` over the
  scheduler's snapshot, on the shared
  ``utils/httpd.BackgroundHTTPServer`` plumbing (daemon thread,
  silenced logs, port 0 = ephemeral).

The snapshot the server reads is swapped by reference by the scheduler
(same contract as ``obs/server.StatusSink``): handlers read the
attribute once and serialize outside any lock, so a slow scraper never
blocks the scheduling loop.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Callable, Optional

# one escaping/formatting/sanitizing implementation for ALL the
# endpoints (member /metrics, fleet /metrics, /status JSON) — a fix to
# label escaping or nonfinite handling must never diverge between them
from trpo_torch.utils.exposition import _esc, _fmt, _json_safe

__all__ = [
    "RECORD_STATES",
    "read_descriptor",
    "scrape_member",
    "render_fleet_prometheus",
    "FleetStatusServer",
]

# the values MemberRecord.state actually takes — the scheduling view.
# The transitional EVENT states (launched/preempted/requeued) exist
# only as bus records: a member sitting in requeue backoff is state
# "pending" here, so the one-hot must not ship permanently-zero series
# for vocabulary the snapshot never uses (alert on the
# trpo_fleet_member_requeues counter, not a state series)
RECORD_STATES = ("pending", "running", "finished", "failed", "culled")

# the live-member stats a fleet view carries (a subset of the member's
# iteration row: timing + progress + reward — not the whole solver row)
_LIVE_STATS = (
    "iteration_ms", "timesteps_total", "reward_running",
    "mean_episode_reward",
)


def read_descriptor(path: str) -> Optional[dict]:
    """Parse one process's ``run.json``; None while absent/partial (the
    process may not have reached its write yet — never an error)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def scrape_member(
    descriptor: dict, timeout: float = 0.75
) -> Optional[dict]:
    """One member's live snapshot, reduced for the fleet view: GET
    ``<status_url>/status`` and keep iteration/stats/health/recompile
    essentials. None when the member isn't serving (yet/anymore)."""
    url = (descriptor or {}).get("status_url")
    if not url:
        return None
    try:
        with urllib.request.urlopen(url + "/status", timeout=timeout) as r:
            snap = json.load(r)
    except Exception:
        return None
    if not isinstance(snap, dict):
        return None
    stats = snap.get("stats") or {}
    health = (snap.get("health") or {}).get("counts") or {}
    rec = snap.get("recompiles") or {}
    return {
        "iteration": snap.get("iteration"),
        "updated_t": snap.get("updated_t"),
        "stats": {
            k: stats.get(k) for k in _LIVE_STATS if k in stats
        },
        "health_counts": dict(health),
        "recompiles_unexpected": rec.get("unexpected"),
        "finished": snap.get("finished"),
    }


# ---------------------------------------------------------------------------
# Prometheus rendering (escaping/formatting shared with obs/server.py)
# ---------------------------------------------------------------------------


def render_fleet_prometheus(snap: dict) -> str:
    """The fleet snapshot as Prometheus text (version 0.0.4): per-member
    state one-hot, attempt/requeue/failure counters, and the scraped
    live gauges for RUNNING members."""
    out = []

    def fam(name, mtype, help_, samples):
        rows = []
        for labels, value in samples:
            if isinstance(value, bool):
                value = float(value)
            if not isinstance(value, (int, float)):
                continue
            lbl = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            rows.append(
                f"{name}{{{lbl}}} {_fmt(float(value))}"
                if lbl else f"{name} {_fmt(float(value))}"
            )
        if rows:
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            out.extend(rows)

    members = snap.get("members") or {}
    fam(
        "trpo_fleet_member_state", "gauge",
        "member scheduling state (one-hot over states)",
        [
            ({"member": mid, "state": s},
             1.0 if (row.get("state") == s) else 0.0)
            for mid, row in sorted(members.items())
            for s in RECORD_STATES
        ],
    )
    for field, help_ in (
        ("attempt", "launches so far (1-based; 0 = not launched yet)"),
        ("requeues", "preemption requeues so far"),
        ("failures", "crash exits so far"),
    ):
        fam(
            f"trpo_fleet_member_{field}", "counter", help_,
            [
                ({"member": mid}, row.get(field, 0))
                for mid, row in sorted(members.items())
            ],
        )
    live_iter, live_samples = [], {k: [] for k in _LIVE_STATS}
    for mid, row in sorted(members.items()):
        live = row.get("live") or {}
        if live.get("iteration") is not None:
            live_iter.append(({"member": mid}, live["iteration"]))
        for k in _LIVE_STATS:
            v = (live.get("stats") or {}).get(k)
            if v is not None:
                live_samples[k].append(({"member": mid}, v))
    fam(
        "trpo_fleet_member_iteration", "gauge",
        "member's current training iteration (scraped /status)",
        live_iter,
    )
    for k in _LIVE_STATS:
        fam(
            f"trpo_fleet_member_{k}", "gauge",
            f"member's latest {k} (scraped /status)",
            live_samples[k],
        )
    counts = snap.get("state_counts") or {}
    fam(
        "trpo_fleet_members_total", "gauge",
        "members per lifecycle state",
        [({"state": s}, n) for s, n in sorted(counts.items())],
    )
    fam(
        "trpo_fleet_finished", "gauge", "1 once the fleet run is over",
        [({}, 1.0 if snap.get("finished") else 0.0)],
    )
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# the fleet endpoint
# ---------------------------------------------------------------------------


class FleetStatusServer:
    """``GET /status`` (JSON fleet snapshot) + ``GET /metrics``
    (Prometheus) over a zero-argument snapshot supplier (the
    scheduler's reference-swapped dict)."""

    ENDPOINTS = ("/status", "/metrics")

    def __init__(
        self,
        snapshot_fn: Callable[[], dict],
        port: int,
        host: str = "127.0.0.1",
    ):
        from trpo_torch.utils.httpd import BackgroundHTTPServer

        self._snapshot_fn = snapshot_fn

        def _status():
            body = json.dumps(_json_safe(self._snapshot_fn())).encode()
            return 200, "application/json", body

        def _metrics():
            body = render_fleet_prometheus(self._snapshot_fn()).encode()
            return 200, "text/plain; version=0.0.4; charset=utf-8", body

        self._httpd = BackgroundHTTPServer(
            port,
            host=host,
            get={"/": _status, "/status": _status, "/metrics": _metrics},
            not_found="have /status and /metrics",
            thread_name="fleet-status-server",
        )
        self.host = host
        self.port = self._httpd.port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.close()


def descriptor_path(member_dir: str) -> str:
    """Where a member's ``run.json`` lives (one convention, shared by
    the scheduler's launch argv and the scraper)."""
    return os.path.join(member_dir, "run.json")
