#!/usr/bin/env python
"""Run an elastic fleet of ``trpo_torch.train`` members (counterpart: the
reference's ``scripts/fleet.py``).

    python -m trpo_torch.scripts.fleet --fleet-dir /tmp/fleet \\
        --grid seed=0..2 -- --preset cartpole --iterations 5 \\
        --batch-timesteps 32 --n-envs 2 --device cpu
    python -m trpo_torch.scripts.fleet --fleet-dir /tmp/fleet --spec F

Everything after ``--`` is the shared base ``trpo_torch.train`` argv
(members run on the card unless it says ``--device cpu``); ``--grid``
expands ``field=lo..hi`` ranges and ``field=a|b`` lists into the
cartesian member product (ids from the varying fields), while ``--spec``
loads the JSON :func:`trpo_torch.fleet.load_spec_file` form for
irregular fleets (per-member overrides such as chaos injection).
``--inject MEMBER=SPEC`` merges an ``--inject-faults`` spec into one
grid member.

The scheduler gives each member its own checkpoint dir, event log,
ephemeral ``/status`` port and ``run.json`` descriptor under
``<fleet-dir>/<member>/``; exit 75 requeues the member with backoff and
resumes from the marker-gated latest checkpoint (zero lost iterations),
other nonzero exits burn the crash budget, and every lifecycle
transition lands in ``<fleet-dir>/fleet_events.jsonl`` (``fleet`` kind;
validate with ``python -m trpo_torch.scripts.validate_events``).
``--status-port`` serves the live fleet view (``/status`` JSON,
``/metrics`` Prometheus with per-member state/attempts and scraped
iteration timings). ``--pbt-rounds`` respawns each round's culled
members from the winner's checkpoint with perturbed hyperparameters.

Exit codes (the fleet gate rides the analyze contract): **0** = every
member finished and the gate compared clean, **1** = a member failed or
a gated member regressed past the threshold, **2** = unusable spec or
an unreadable reference/member log.

One stated difference (:data:`STATED_DIFFERENCES`): the reference's
``--platform`` picks the orchestrator's JAX platform; this orchestrator
touches no device, so the flag is parsed and refused (exit 2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

# the reference's flags this CLI replaces, with what replaces them
STATED_DIFFERENCES = {
    "--platform": "the reference orchestrator's JAX platform; this "
                  "orchestrator touches no device (members pick theirs "
                  "through the base train argv: --device cuda|cpu)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.fleet",
        description="schedule N trpo_torch.train runs over bounded "
        "local worker slots with auto-requeue + fleet gate",
    )
    p.add_argument(
        "--fleet-dir", required=True,
        help="working directory: one subdir per member (checkpoints, "
        "event log, console log, run.json) + fleet_events.jsonl",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument(
        "--grid",
        help="member grid, e.g. seed=0..3,cg_damping=0.1|0.3 "
        "(cartesian product; ids from the varying fields)",
    )
    src.add_argument(
        "--spec",
        help="JSON FleetSpec file (trpo_torch.fleet.load_spec_file)"
    )
    p.add_argument(
        "--inject", action="append", default=[], metavar="MEMBER=SPEC",
        help="merge an --inject-faults spec into one member (grid mode), "
        "e.g. --inject 'seed1=sigterm@iter=2'; repeatable",
    )
    p.add_argument("--max-workers", type=int, default=None,
                   help="concurrent member slots (default 2)")
    p.add_argument("--max-restarts", type=int, default=None,
                   help="per-member crash budget (default 2)")
    p.add_argument("--max-requeues", type=int, default=None,
                   help="per-member preemption-requeue bound (default 8)")
    p.add_argument("--backoff", type=float, default=None,
                   help="base requeue backoff seconds (default 1.0)")
    p.add_argument("--gate-threshold-pct", type=float, default=None,
                   help="fleet gate regression threshold (default 200)")
    p.add_argument("--gate-min-ms", type=float, default=None,
                   help="fleet gate phase floor in ms (default 5)")
    p.add_argument("--gate-reference", default=None,
                   help="member id the gate compares against "
                   "(default: the first member)")
    p.add_argument("--cull-bottom-k", type=int, default=None,
                   help="mark the k lowest-scoring finished members "
                   "culled (default 0)")
    p.add_argument("--pbt-rounds", type=int, default=None,
                   help="PBT exploit/explore rounds (default 0 = off): "
                   "after each round, every culled member respawns "
                   "from the winner's checkpoint with perturbed "
                   "hyperparameters (seed, lam, cg_damping) and "
                   "trains another segment")
    p.add_argument("--pbt-iterations", type=int, default=None,
                   help="explore-segment length in train iterations "
                   "(default: the remainder of the base run)")
    p.add_argument("--pbt-perturb", type=float, default=None,
                   help="multiplicative perturbation factor for "
                   "explored hypers, 0 < f < 1 (default 0.2 — "
                   "hypers scale by 0.8x or 1.2x)")
    p.add_argument(
        "--feedback", default=None, metavar="EVENTS_JSONL",
        help="serving-plane event log(s) with promote feedback "
        "records (comma-separated): realized episode returns from "
        "served traffic blend episode-weighted into member scores — "
        "the flywheel's serve→train feedback path",
    )
    p.add_argument("--scrape-interval", type=float, default=None,
                   help="seconds between /status scrapes (default 2)")
    p.add_argument(
        "--status-port", type=int, default=None, metavar="PORT",
        help="serve the live fleet /status + /metrics on "
        "127.0.0.1:PORT (0 = ephemeral; unset = no endpoint)",
    )
    p.add_argument(
        "--events-jsonl", default=None,
        help="fleet lifecycle event log "
        "(default <fleet-dir>/fleet_events.jsonl)",
    )
    p.add_argument("--timeout", type=float, default=None,
                   help="wall-clock bound in seconds; running members "
                   "are terminated and marked failed past it")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable result instead of "
                   "the text report")
    p.add_argument(
        "train_args", nargs=argparse.REMAINDER,
        help="everything after -- is the shared base trpo_torch.train "
        "argv (grid mode)",
    )
    p.add_argument("--platform", help=argparse.SUPPRESS)
    return p


_SPEC_OVERRIDES = {
    "max_workers": "max_workers",
    "max_restarts": "max_restarts",
    "max_requeues": "max_requeues",
    "backoff": "requeue_backoff",
    "gate_threshold_pct": "gate_threshold_pct",
    "gate_min_ms": "gate_min_ms",
    "gate_reference": "gate_reference",
    "cull_bottom_k": "cull_bottom_k",
    "scrape_interval": "scrape_interval",
    "pbt_rounds": "pbt_rounds",
    "pbt_iterations": "pbt_iterations",
    "pbt_perturb": "pbt_perturb",
}


def _load_feedback(spec_arg: str) -> dict:
    """Pool promote ``feedback`` records from serving-plane logs into
    the scheduler's ``{member: (mean_return, episodes)}`` blend form.
    """
    from trpo_torch.fleet.promote import feedback_scores
    from trpo_torch.obs.analyze import load_events

    records = []
    for path in spec_arg.split(","):
        path = path.strip()
        if not path:
            continue
        if not os.path.exists(path):
            raise OSError(f"--feedback {path}: no such event log")
        records.extend(load_events(path))
    return feedback_scores(records)


def _build_spec(args):
    from trpo_torch.fleet import (
        FleetSpec,
        MemberSpec,
        expand_grid,
        load_spec_file,
    )

    base_args = list(args.train_args)
    if base_args and base_args[0] == "--":
        base_args = base_args[1:]
    if args.spec:
        if base_args:
            # ValueError, not SystemExit: main() maps spec problems to
            # the documented exit 2, never the gate's exit 1
            raise ValueError(
                "--spec carries its own base_args; drop the trailing "
                "train argv"
            )
        spec = load_spec_file(args.spec)
    else:
        members = expand_grid(args.grid)
        spec = FleetSpec(members=tuple(members),
                         base_args=tuple(base_args))
    if args.inject:
        by_id = {m.member_id: m for m in spec.members}
        for item in args.inject:
            mid, _, fault = item.partition("=")
            if not fault or mid not in by_id:
                raise ValueError(
                    f"--inject {item!r}: want MEMBER=FAULT_SPEC with a "
                    f"known member (have {sorted(by_id)})"
                )
            m = by_id[mid]
            by_id[mid] = MemberSpec(
                m.member_id,
                tuple(
                    [(k, v) for k, v in m.overrides
                     if k != "inject_faults"]
                    + [("inject_faults", fault)]
                ),
            )
        spec = dataclasses.replace(
            spec,
            members=tuple(by_id[m.member_id] for m in spec.members),
        )
    updates = {
        spec_field: getattr(args, arg_name)
        for arg_name, spec_field in _SPEC_OVERRIDES.items()
        if getattr(args, arg_name) is not None
    }
    if updates:
        spec = dataclasses.replace(spec, **updates)
    return spec


def _render_report(result: dict) -> str:
    from trpo_torch.obs.analyze import format_table

    rows = []
    for mid, row in sorted(result["members"].items()):
        score = result["scores"].get(mid)
        rows.append([
            mid, row["state"], row["attempt"], row["requeues"],
            row["failures"],
            "-" if row["exit_code"] is None else row["exit_code"],
            "-" if score is None else f"{score:.1f}",
        ])
    out = [format_table(
        rows,
        ["member", "state", "attempts", "requeues", "crashes",
         "exit", "score"],
    )]
    gate = result["gate"]
    out.append("")
    out.append(f"gate (reference={gate['reference']}):")
    for mid, g in sorted(gate.get("members", {}).items()):
        line = f"  {mid}: {g['verdict']}"
        if g.get("reason"):
            line += f" ({g['reason']})"
        if g["verdict"] == "regressed":
            bad = [
                v["metric"]
                for v in g["comparison"]["verdicts"]
                if v["verdict"] == "regressed"
            ]
            line += f" — {', '.join(bad)}"
        out.append(line)
    if gate.get("reason"):
        out.append(f"  gate: {gate['reason']}")
    if result["culled"]:
        out.append(f"culled (bottom-k): {', '.join(result['culled'])}")
    if result.get("respawned"):
        out.append(
            f"pbt respawned: {', '.join(result['respawned'])}"
        )
    bench = result.get("bench")
    if bench:
        out.append(
            "bench: fleet wall "
            f"{bench['fleet_wall_ms'] / 1e3:.1f}s vs member sum "
            f"{bench['members_wall_ms'] / 1e3:.1f}s "
            f"(speedup x{bench['parallel_speedup']:.2f} over "
            f"{bench['max_workers']} workers)"
        )
    verdict = {0: "CLEAN", 1: "FAILED/REGRESSED", 2: "UNREADABLE"}[
        result["exit_code"]
    ]
    out.append(f"fleet: {verdict} (exit {result['exit_code']})")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.platform is not None:
        print(f"ERROR    --platform: {STATED_DIFFERENCES['--platform']}",
              file=sys.stderr)
        return 2
    try:
        spec = _build_spec(args)
        feedback = _load_feedback(args.feedback) if args.feedback else None
    except (ValueError, OSError) as e:
        print(f"ERROR    {e}", file=sys.stderr)
        return 2

    from trpo_torch.fleet import FleetScheduler
    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields

    fleet_dir = os.path.abspath(args.fleet_dir)
    os.makedirs(fleet_dir, exist_ok=True)
    events_path = args.events_jsonl or os.path.join(
        fleet_dir, "fleet_events.jsonl"
    )
    bus = EventBus(JsonlSink(events_path))
    bus.emit(
        "run_manifest",
        **manifest_fields(
            None,
            extra={
                "driver": "fleet",
                "members": [m.member_id for m in spec.members],
                "max_workers": spec.max_workers,
            },
            # the orchestrator's own device: it never touches the card
            device="cpu",
        ),
    )
    scheduler = FleetScheduler(
        spec, fleet_dir, bus=bus, status_port=args.status_port,
        feedback=feedback,
    )
    try:
        if scheduler.status_server is not None:
            # stderr: with --json, stdout must stay machine-parseable
            print(
                f"fleet endpoint: {scheduler.status_server.url}/status "
                "(and /metrics)",
                file=sys.stderr,
                flush=True,
            )
            bus.emit(
                "status",
                port=scheduler.status_server.port,
                url=scheduler.status_server.url,
                endpoints=list(scheduler.status_server.ENDPOINTS),
            )
        result = scheduler.run(timeout=args.timeout)
    finally:
        scheduler.close()
        bus.close()
    if args.json:
        # RFC-valid stdout: a finished member with zero completed
        # episodes scores -inf, which bare json.dumps would emit as the
        # non-standard `-Infinity` token — same sanitization as the
        # fleet /status endpoint
        from trpo_torch.utils.exposition import _json_safe

        print(json.dumps(_json_safe(result), default=str))
    else:
        print(_render_report(result))
    return result["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
