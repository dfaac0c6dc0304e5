#!/usr/bin/env python
"""The observatory: one screen for the whole system.

    # reconstruct the dashboard from a run's event log (CI mode)
    python -m trpo_torch.scripts.observatory --events RUN.jsonl --once --json

    # watch a live system (names are yours; URLs are /status servers)
    python -m trpo_torch.scripts.observatory \\
        --targets router=http://127.0.0.1:8080 \\
                  m0=http://127.0.0.1:9090 \\
        --journal /ckpts/serve --watch

One screen shows: fleet members with their states and promotion
scores, replicas per host with lease/suspect state, SLO status bars
(p99 vs objective over the router's time-expiring recent window),
currently-FIRING alerts, and the slowest sampled-trace stages.

Two sources, one dashboard:

* ``--events`` — offline/CI: replays JSONL event logs (merge several
  files by passing them all) into the same view a live watcher would
  have shown; alerts come from the ``alert`` records the run's own
  `AlertEngine` emitted. ``--json`` emits the machine layer a gate
  asserts against (rules fired AND resolved, nothing left active).
* ``--targets`` — live: embeds a :class:`MetricsAggregator` +
  :func:`default_rules` engine right here, polling the named
  endpoints; ``--journal`` adds the promotion journal as a target.

``--once`` renders a single frame and exits; ``--watch`` redraws
every ``--interval`` seconds until interrupted.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


# ---------------------------------------------------------------------------
# dashboard state (one dict; text and JSON render the same thing)
# ---------------------------------------------------------------------------


def state_from_events(records: list) -> dict:
    """The dashboard state a live watcher would have ended this log
    with: last sample per series, open/closed alerts, member and
    replica lifecycle, slowest traces."""
    from trpo_torch.obs.analyze import _summarize_traces

    alerts: dict = {}
    open_alerts: dict = {}
    samples: dict = {}
    members: dict = {}
    scores: dict = {}
    replicas: dict = {}
    leases: dict = {}
    hosts: dict = {}
    for rec in records:
        kind = rec.get("kind")
        if kind == "alert":
            rule, target = rec.get("rule"), rec.get("target")
            row = alerts.setdefault(
                rule, {"fired": 0, "resolved": 0, "targets": set()}
            )
            row["targets"].add(target)
            if rec.get("state") == "firing":
                row["fired"] += 1
                open_alerts[(rule, target)] = rec
            elif rec.get("state") == "resolved":
                row["resolved"] += 1
                open_alerts.pop((rule, target), None)
        elif kind == "metric_sample":
            key = (rec.get("target"), rec.get("series"))
            samples[key] = rec
        elif kind == "fleet":
            members[rec.get("member")] = {
                "state": rec.get("state"),
                "attempt": rec.get("attempt"),
            }
        elif kind == "promote":
            m = rec.get("member")
            row = scores.setdefault(m, {})
            if rec.get("event") == "feedback":
                for k in ("score", "mean_return", "episodes"):
                    if rec.get(k) is not None:
                        row[k] = rec.get(k)
            elif rec.get("event") == "promoted":
                row["promoted_step"] = rec.get("step")
            elif rec.get("event") in ("rejected", "rolled_back"):
                row["last_rejected_step"] = rec.get("step")
        elif kind == "router" and rec.get("scope") == "replica":
            r = rec.get("replica")
            replicas[r] = {
                "state": rec.get("state"),
                "host": rec.get("host"),
            }
        elif kind == "router" and rec.get("scope") == "host":
            hosts[rec.get("host")] = rec.get("state")
        elif kind == "lease":
            r = rec.get("replica")
            leases[r] = {
                "event": rec.get("event"),
                "epoch": rec.get("epoch"),
            }
    for r, row in replicas.items():
        if r in leases:
            row["lease"] = leases[r]["event"]
            row["lease_epoch"] = leases[r].get("epoch")
        if row.get("host") in hosts:
            row["host_state"] = hosts[row["host"]]
    traces = _summarize_traces(records)
    slowest = []
    if traces:
        for row in traces.get("slowest") or []:
            stages = row.get("stages") or {}
            top = sorted(stages.items(), key=lambda kv: -kv[1])[:3]
            slowest.append({
                "trace": row.get("trace"),
                "root_ms": row.get("root_ms"),
                "top_stages": [
                    {"stage": s, "ms": ms} for s, ms in top
                ],
            })
    return {
        "source": "events",
        "targets": _targets_from_samples(samples),
        "slo": _slo_rows(samples, open_alerts),
        "alerts": {
            "rules": {
                rule: {
                    "fired": row["fired"],
                    "resolved": row["resolved"],
                    "active": any(
                        k[0] == rule for k in open_alerts
                    ),
                    "targets": sorted(
                        t for t in row["targets"] if t
                    ),
                }
                for rule, row in sorted(alerts.items())
            },
            "firing": [
                {
                    "rule": k[0], "target": k[1],
                    "value": rec.get("value"),
                    "threshold": rec.get("threshold"),
                    "window_s": rec.get("window_s"),
                }
                for k, rec in sorted(open_alerts.items())
            ],
        },
        "fleet": {
            m: {**row, **scores.get(m, {})}
            for m, row in sorted(members.items())
        },
        "replicas": dict(sorted(replicas.items())),
        "slowest_traces": slowest,
    }


def _targets_from_samples(samples: dict) -> dict:
    out: dict = {}
    for (target, series), rec in samples.items():
        row = out.setdefault(
            target, {"up": None, "stale": False, "series": 0}
        )
        row["series"] += 1
        if series == "up":
            row["up"] = rec.get("value")
            row["stale"] = bool(rec.get("stale"))
    return out


def _slo_rows(samples: dict, open_alerts: dict) -> list:
    """One status bar per target that exposes a recent p99: observed
    value, the SLO threshold when a slo_p99 rule told us one, and
    whether that alert is firing right now."""
    rows = []
    for (target, series), rec in sorted(samples.items()):
        if not series.endswith("latency_recent_ms.0.99"):
            continue
        firing = open_alerts.get(("slo_p99", target))
        threshold = firing.get("threshold") if firing else None
        rows.append({
            "target": target,
            "p99_ms": rec.get("value"),
            "slo_ms": threshold,
            "firing": firing is not None,
        })
    return rows


def state_from_aggregator(agg, engine) -> dict:
    """Live-mode dashboard state straight off the aggregator store."""
    snap = agg.snapshot()
    open_alerts = {
        (rule, target): {"rule": rule, "target": target}
        for rule, target in engine.active()
    }
    samples = {}
    for target, series_map in (snap.get("latest") or {}).items():
        for s, v in series_map.items():
            samples[(target, s)] = {"value": v}
    slo = []
    for (target, s), rec in sorted(samples.items()):
        if s.endswith("latency_recent_ms.0.99"):
            slo.append({
                "target": target,
                "p99_ms": rec.get("value"),
                "slo_ms": next(
                    (r.threshold for r in engine.rules
                     if r.name == "slo_p99"), None
                ),
                "firing": ("slo_p99", target) in open_alerts,
            })
    return {
        "source": "live",
        "targets": {
            name: {
                "up": 1.0 if st.get("up") else 0.0,
                "stale": bool(st.get("stale")),
                "series": len(
                    (snap.get("latest") or {}).get(name, {})
                ),
            }
            for name, st in (snap.get("targets") or {}).items()
        },
        "slo": slo,
        "alerts": {
            "rules": {
                rule: {
                    "fired": engine.firing_total.get(rule, 0),
                    "resolved": engine.resolved_total.get(rule, 0),
                    "active": any(
                        k[0] == rule for k in open_alerts
                    ),
                    "targets": sorted(
                        k[1] for k in open_alerts if k[0] == rule
                    ),
                }
                for rule in sorted(
                    set(engine.firing_total)
                    | {k[0] for k in open_alerts}
                )
            },
            "firing": [
                {"rule": k[0], "target": k[1]}
                for k in sorted(open_alerts)
            ],
        },
        "fleet": {},
        "replicas": {},
        "slowest_traces": [],
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

_BAR_W = 24


def _bar(value, limit) -> str:
    if value is None or not limit:
        return "." * _BAR_W
    frac = max(0.0, min(2.0, float(value) / float(limit)))
    n = int(round(frac / 2.0 * _BAR_W))
    return ("#" * n).ljust(_BAR_W, ".")


def render(state: dict) -> str:
    lines = []
    add = lines.append
    add("=" * 64)
    add(f"observatory · source={state.get('source')} · "
        f"{time.strftime('%H:%M:%S')}")
    add("=" * 64)
    firing = (state.get("alerts") or {}).get("firing") or []
    if firing:
        add(f"ALERTS FIRING ({len(firing)}):")
        for a in firing:
            extra = ""
            if a.get("value") is not None:
                extra = (f"  value={a['value']:.3g} "
                         f"threshold={a.get('threshold'):.3g}")
            add(f"  !! {a['rule']}  target={a.get('target')}{extra}")
    else:
        add("alerts: none firing")
    rules = (state.get("alerts") or {}).get("rules") or {}
    if rules:
        add("  rule history: " + ", ".join(
            f"{r}({row['fired']}/{row['resolved']})"
            for r, row in rules.items()
        ) + "  (fired/resolved)")
    slo = state.get("slo") or []
    if slo:
        add("-" * 64)
        add("SLO (p99 over recent window):")
        for row in slo:
            v, lim = row.get("p99_ms"), row.get("slo_ms")
            mark = "FIRING" if row.get("firing") else "ok"
            vs = f"{v:8.1f}ms" if v is not None else "      --"
            ls = f" / {lim:.0f}ms" if lim else ""
            add(f"  {row['target']:<12} [{_bar(v, lim)}] "
                f"{vs}{ls}  {mark}")
    targets = state.get("targets") or {}
    if targets:
        add("-" * 64)
        add("targets: " + ", ".join(
            f"{name}={'STALE' if row.get('stale') else 'up'}"
            for name, row in sorted(targets.items())
        ))
    fleet = state.get("fleet") or {}
    if fleet:
        add("-" * 64)
        add("fleet:")
        for m, row in fleet.items():
            score = row.get("score")
            ss = f"  score={score:.3f}" if score is not None else ""
            mr = row.get("mean_return")
            ms = f"  served_return={mr:.2f}" if mr is not None else ""
            ps = (f"  promoted@{row['promoted_step']}"
                  if row.get("promoted_step") is not None else "")
            add(f"  {m:<10} {row.get('state', '?'):<10}"
                f"attempt={row.get('attempt')}{ss}{ms}{ps}")
    replicas = state.get("replicas") or {}
    if replicas:
        add("-" * 64)
        add("replicas:")
        for r, row in replicas.items():
            bits = [f"{r:<6} {row.get('state', '?'):<10}"]
            if row.get("host"):
                hs = row.get("host_state")
                bits.append(
                    f"host={row['host']}"
                    + (f"({hs})" if hs else "")
                )
            if row.get("lease"):
                bits.append(
                    f"lease={row['lease']}"
                    + (f"@e{row['lease_epoch']}"
                       if row.get("lease_epoch") is not None else "")
                )
            add("  " + "  ".join(bits))
    slowest = state.get("slowest_traces") or []
    if slowest:
        add("-" * 64)
        add("slowest traces (top stages):")
        for row in slowest:
            stages = ", ".join(
                f"{s['stage']}={s['ms']:.1f}ms"
                for s in row.get("top_stages") or []
            )
            add(f"  {row['trace'][:16]:<16} "
                f"{row['root_ms']:8.1f}ms  {stages}")
    add("=" * 64)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_target(spec: str):
    from trpo_torch.obs.aggregate import HttpTarget

    name, sep, url = spec.partition("=")
    if not sep or not name or not url.startswith("http"):
        raise SystemExit(
            f"--targets wants NAME=http://host:port, got {spec!r}"
        )
    return HttpTarget(name, url)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--events", nargs="+", metavar="FILE",
                    help="reconstruct from event JSONL (merged)")
    ap.add_argument("--targets", nargs="+", metavar="NAME=URL",
                    help="live mode: poll these /status endpoints")
    ap.add_argument("--journal", metavar="PATH",
                    help="live mode: promotion journal file/dir")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--watch", action="store_true",
                    help="redraw every --interval seconds")
    ap.add_argument("--once", action="store_true",
                    help="one frame, then exit (CI)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable state instead of the screen")
    args = ap.parse_args(argv)
    if bool(args.events) == bool(args.targets):
        ap.error("exactly one of --events / --targets")

    def emit(state):
        if args.json:
            print(json.dumps(state, indent=2, sort_keys=True))
        else:
            print(render(state))

    if args.events:
        from trpo_torch.obs.analyze import load_events

        records = []
        for path in args.events:
            records.extend(load_events(path))
        records.sort(key=lambda r: r.get("t") or 0.0)
        state = state_from_events(records)
        emit(state)
        # events mode is inherently a snapshot; --watch re-reads so a
        # growing log can be tailed
        while args.watch and not args.once:
            time.sleep(args.interval)
            records = []
            for path in args.events:
                records.extend(load_events(path))
            records.sort(key=lambda r: r.get("t") or 0.0)
            os.system("clear" if os.name != "nt" else "cls")
            emit(state_from_events(records))
        return 0

    from trpo_torch.obs.aggregate import (
        JournalTarget,
        MetricsAggregator,
    )
    from trpo_torch.obs.alerts import AlertEngine, default_rules

    targets = [_parse_target(s) for s in args.targets]
    if args.journal:
        targets.append(JournalTarget("promoter", args.journal))
    engine = AlertEngine(default_rules())
    agg = MetricsAggregator(
        targets, engine=engine, interval=args.interval
    )
    try:
        # two ticks so rate/burn rules have deltas on the first frame
        agg.tick()
        time.sleep(min(0.5, args.interval))
        agg.tick()
        emit(state_from_aggregator(agg, engine))
        while args.watch and not args.once:
            time.sleep(args.interval)
            agg.tick()
            os.system("clear" if os.name != "nt" else "cls")
            emit(state_from_aggregator(agg, engine))
    except KeyboardInterrupt:
        pass
    finally:
        agg.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
