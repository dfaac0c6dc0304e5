#!/usr/bin/env python
"""Re-execute a replay bundle bit-exact against a shadow replica set
(counterpart: ``scripts/replay_run.py``).

    python -m trpo_torch.scripts.replay_run BUNDLE.json --checkpoint-dir CK \\
        --preset cartpole-po [--device cuda|cpu] [--replicas 2] \\
        [--events replay_events.jsonl] [--json] [--fail-stage-regression]

The model flags (``--preset``, ``--policy-hidden``, ``--policy-gru``, ...)
name the recorded server's model as ``python -m trpo_torch.serve`` takes
them: a flag left out keeps the preset's value (the reference's script
fixes its own small defaults instead). ``--device`` defaults to the card;
without one, pass ``--device cpu`` (there is no fallback).

Loads the bundle ``analyze_run --export-bundle`` wrote, restores the
named checkpoint step (the port's ``step_<n>/`` checkpoints) into a fresh
agent, launches an IN-PROCESS shadow
replica set (``InProcessReplica`` + ``PolicyServer`` + ``Router`` — the
same classes production runs, behind the same public HTTP surface), and
re-drives the recorded requests in causal order:

* sessions the capture window opened MID-stream are seeded from their
  bundled journal snapshot through ``Router.restore_session`` — the
  same replica restore protocol a failover takeover uses, so the seq
  counter continues exactly where the recording left off;
* sessions born inside the window are created fresh and their recorded
  ids mapped to the shadow ids;
* every act is POSTed through the router with its RECORDED trace id,
  so the shadow spans assemble under the same ids as the incident.

The diff has three verdicts, in order of severity:

1. **actions** — bit-exact (float64 ``array_equal``) against the
   recorded action of every act. ANY mismatch is exit 1: the policy,
   the checkpoint, or the carry protocol changed behavior.
2. **per-stage p99** — the bundle's recorded trace summary vs the
   shadow run's, through ``compare_runs`` (``trace/...`` rows).
   Informative by default (a shadow set's timings legitimately differ
   from a partitioned production's); ``--fail-stage-regression``
   promotes regressions to exit 1.
3. **event contracts** — the shadow log carries ``replay``
   begin/act/verdict/complete records; ``validate_events``
   checks every captured act was answered and every diff verdict
   emitted.

Exit codes: **0** replay bit-exact (and stages clean when promoted),
**1** action mismatch or promoted stage regression, **2** unusable
bundle/arguments (named reason, never a stack trace).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request


def _ints(text: str) -> tuple:
    return tuple(int(s) for s in text.split(",") if s.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.replay_run",
        description="re-execute a replay bundle against a shadow "
        "replica set, diffing actions bit-exact",
    )
    p.add_argument("bundle", help="replay bundle JSON "
                   "(analyze_run.py --export-bundle)")
    p.add_argument(
        "--checkpoint-dir", required=True,
        help="checkpoint directory holding the bundle's recorded step",
    )
    p.add_argument("--preset", default="pendulum",
                   help="the recorded server's preset")
    p.add_argument("--env", help="override the preset's env")
    p.add_argument("--n-envs", type=int)
    p.add_argument("--policy-hidden", type=_ints,
                   help="comma-separated torso widths, e.g. 8 or 64,64")
    p.add_argument("--vf-hidden", type=_ints)
    p.add_argument("--policy-gru", type=int)
    p.add_argument("--policy-cell", choices=("gru", "lstm"))
    p.add_argument("--normalize-obs", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback to the CPU")
    p.add_argument(
        "--replicas", type=int, default=2,
        help="shadow replica count (default 2)",
    )
    p.add_argument(
        "--events", metavar="FILE",
        help="shadow event log (spans + replay records; default "
        "<bundle>.replay_events.jsonl)",
    )
    p.add_argument(
        "--allow-partial", action="store_true",
        help="replay the replayable traces of a partially-complete "
        "bundle instead of refusing",
    )
    p.add_argument(
        "--fail-stage-regression", action="store_true",
        help="exit 1 when a per-stage p99 row regresses past the "
        "threshold (default: report only — shadow timings "
        "legitimately differ from the recorded incident's)",
    )
    p.add_argument("--threshold-pct", type=float, default=20.0)
    p.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable replay report",
    )
    return p


def _post(url, payload=None, headers=None, timeout=30.0):
    data = b"" if payload is None else json.dumps(payload).encode()
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    req = urllib.request.Request(url, data=data, headers=h)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ordered_acts(bundle: dict, skip_traces=()) -> list:
    """Every bundled act in global causal order (arrival time, then
    router order) — per-session seq order is preserved because the
    router stamped seqs in arrival order in the first place."""
    acts = list(bundle.get("stateless") or [])
    for sid, sess in (bundle.get("sessions") or {}).items():
        for a in sess["acts"]:
            acts.append(dict(a, session=sid))
    acts = [a for a in acts if a.get("trace") not in skip_traces]
    acts.sort(key=lambda a: (a.get("t") or 0, a.get("order") or 0))
    return acts


def replay_bundle(bundle: dict, router_url: str, bus, bundle_obj=None):
    """Drive every act through the shadow router's public surface,
    diffing actions bit-exact. Returns the report dict; emits the
    ``replay`` event stream on ``bus`` (begin / act / verdict /
    complete — the contract ``validate_events.py`` checks). Importable
    for the in-process test legs; ``main`` wraps it with the shadow
    stack."""
    from trpo_torch.obs.capture import decode_payload
    from trpo_torch.obs.replay import action_match
    from trpo_torch.obs.trace import TRACE_HEADER

    skip = {
        c["trace"]
        for c in bundle.get("completeness") or []
        if not c["replayable"]
    }
    acts = _ordered_acts(bundle, skip_traces=skip)
    bus.emit("replay", event="begin", acts=len(acts))
    results, mismatches = [], 0
    sid_map = {}  # recorded sid -> shadow sid (fresh sessions)
    for sid, sess in (bundle.get("sessions") or {}).items():
        if sess.get("seed") is None:
            status, out = _post(router_url + "/session")
            if status != 200:
                raise RuntimeError(
                    f"shadow session create failed: {status} {out}"
                )
            sid_map[sid] = out["session"]
        # seeded sessions were restored under their recorded id
        # (Router.restore_session) before this ran
    for act in acts:
        _scalars, obs = decode_payload(act)
        if obs is None:
            raise RuntimeError(
                f"act order={act.get('order')} has no decodable "
                "payload — the bundle builder should have marked its "
                "trace non-replayable"
            )
        headers = {TRACE_HEADER: act["trace"]}
        if act.get("endpoint") == "session_act":
            sid = sid_map.get(act["session"], act["session"])
            status, out = _post(
                router_url + f"/session/{sid}/act",
                {"obs": obs.tolist()}, headers=headers,
            )
        else:
            status, out = _post(
                router_url + "/act",
                {"obs": obs.tolist()}, headers=headers,
            )
        bus.emit(
            "replay", event="act", trace=act["trace"],
            order=act.get("order") or 0, status=status,
        )
        match = status == 200 and action_match(
            act.get("action"), out.get("action")
        )
        bus.emit(
            "replay", event="verdict", trace=act["trace"],
            order=act.get("order") or 0, match=bool(match),
        )
        if not match:
            mismatches += 1
        results.append({
            "trace": act["trace"],
            "order": act.get("order"),
            "session": act.get("session"),
            "seq": act.get("seq"),
            "status": status,
            "match": bool(match),
            "recorded_action": act.get("action"),
            "replayed_action": out.get("action")
            if status == 200 else out,
        })
    bus.emit(
        "replay", event="complete", acts=len(acts),
        mismatches=mismatches,
    )
    return {
        "acts": len(acts),
        "skipped_traces": sorted(skip),
        "mismatches": mismatches,
        "results": results,
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from trpo_torch.obs.replay import BundleError, load_bundle

    try:
        bundle = load_bundle(args.bundle)
    except BundleError as e:
        print(f"ERROR    {e}", file=sys.stderr)
        return 2
    broken = [
        c for c in bundle.get("completeness") or []
        if not c["replayable"]
    ]
    if broken and not args.allow_partial:
        print(
            f"ERROR    {len(broken)} trace(s) in the bundle are not "
            "replayable (--allow-partial replays the rest):",
            file=sys.stderr,
        )
        for c in broken:
            for piece in c["missing"]:
                print(f"  {c['trace']}: {piece}", file=sys.stderr)
        return 2
    step = bundle.get("checkpoint_step")
    if step is None:
        print(
            "ERROR    bundle records no checkpoint step — cannot pick "
            "the shadow weights",
            file=sys.stderr,
        )
        return 2

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print(
                f"ERROR    --device {args.device}: no CUDA device is "
                "available — pass --device cpu to replay on the CPU",
                file=sys.stderr,
            )
            return 2

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.obs.analyze import _summarize_traces, compare_runs
    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields
    from trpo_torch.obs.trace import Tracer
    from trpo_torch.serve import (
        InProcessReplica,
        MicroBatcher,
        PolicyServer,
        ReplicaSet,
        Router,
    )
    from trpo_torch.utils.checkpoint import Checkpointer

    overrides = {k: v for k, v in {
        "env": args.env,
        "n_envs": args.n_envs,
        "policy_hidden": args.policy_hidden,
        "vf_hidden": args.vf_hidden,
        "policy_gru": args.policy_gru,
        "policy_cell": args.policy_cell,
        "normalize_obs": True if args.normalize_obs else None,
    }.items() if v is not None}
    cfg = get_preset(args.preset).replace(**overrides)
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    if not os.path.isdir(args.checkpoint_dir):
        print(
            f"ERROR    checkpoint dir not found: {args.checkpoint_dir}",
            file=sys.stderr,
        )
        return 2
    try:
        state = Checkpointer(args.checkpoint_dir).restore(
            agent.init_state(seed=0), step=step, prune=False
        )
    except (FileNotFoundError, ValueError) as e:
        print(
            f"ERROR    cannot restore step {step} from "
            f"{args.checkpoint_dir}: {e}",
            file=sys.stderr,
        )
        return 2

    events_path = args.events or (args.bundle + ".replay_events.jsonl")
    bus = EventBus(JsonlSink(events_path))
    bus.emit(
        "run_manifest",
        **manifest_fields(cfg, extra={"driver": "replay_run"},
                          device=agent.device),
    )
    tracer = Tracer(bus, 1.0, process="replay")
    jdir = events_path + ".shadow_journal"

    def factory(rid):
        def build():
            batcher = None
            if agent.is_recurrent:
                engine = agent.serve_session_engine()
            else:
                engine = agent.serve_engine()
                batcher = MicroBatcher(
                    engine, deadline_ms=cfg.serve_deadline_ms,
                    adaptive_deadline=cfg.serve_adaptive_deadline,
                )
            engine.load(state.policy_params, state.obs_norm, step=step)
            server = PolicyServer(
                engine, batcher, port=0, bus=bus, tracer=tracer,
                replica_name=rid,
                carry_journal_dir=jdir if agent.is_recurrent else None,
            )
            return server, [batcher] if batcher is not None else []

        return build

    rs = ReplicaSet(
        lambda rid: InProcessReplica(factory(rid)), args.replicas,
        bus=bus, health_interval=60.0, backoff=0.05,
        health_fail_threshold=1, max_restarts=2,
    )
    exit_code = 1
    try:
        if not rs.wait_healthy(args.replicas, timeout=120.0):
            print(
                f"ERROR    shadow replicas unhealthy: {rs.snapshot()}",
                file=sys.stderr,
            )
            return 2
        router = Router(
            rs, port=0, bus=bus, journal_dir=jdir, tracer=tracer,
        )
        try:
            # seed mid-window sessions from their journal snapshots
            for sid, sess in (bundle.get("sessions") or {}).items():
                if sess.get("seed") is not None:
                    rid = router.restore_session(sid, sess["seed"])
                    print(f"seeded session {sid} (seq "
                          f"{sess['seed'].get('seq')}) on {rid}")
            report = replay_bundle(bundle, router.url, bus)
        finally:
            router.close()
    finally:
        rs.close()
        tracer.drain()
        tracer.close()

    # per-stage p99 vs the recorded trace summary, through the same
    # compare_runs rows the regression gate uses
    from trpo_torch.obs.analyze import load_events

    bus.close()
    shadow_records = load_events(events_path)
    replayed = _summarize_traces(
        [r for r in shadow_records if r.get("kind") == "span"]
    )
    stage_rows = []
    stages_regressed = False
    if bundle.get("recorded") and replayed:
        cmp = compare_runs(
            {"traces": bundle["recorded"]},
            {"traces": replayed},
            threshold_pct=args.threshold_pct,
        )
        stage_rows = [
            v for v in cmp["verdicts"]
            if v["metric"].startswith("trace/")
        ]
        stages_regressed = any(
            v["verdict"] == "regressed" for v in stage_rows
        )

    report["stage_rows"] = stage_rows
    report["stages_regressed"] = stages_regressed
    report["events"] = events_path
    report["checkpoint_step"] = step
    if bundle.get("faults"):
        report["recorded_faults"] = [
            {k: f.get(k) for k in ("kind", "event", "t", "fault",
                                   "session", "replica") if k in f}
            for f in bundle["faults"]
        ]

    ok = report["mismatches"] == 0 and (
        not args.fail_stage_regression or not stages_regressed
    )
    exit_code = 0 if ok else 1

    if args.json:
        print(json.dumps(report))
        return exit_code
    print(
        f"replayed {report['acts']} act(s) at checkpoint step {step}: "
        f"{report['mismatches']} mismatch(es)"
    )
    for r in report["results"]:
        if not r["match"]:
            print(
                f"  MISMATCH trace {r['trace']} order {r['order']}: "
                f"recorded {r['recorded_action']} vs replayed "
                f"{r['replayed_action']}"
            )
    if report["skipped_traces"]:
        print(
            f"  skipped {len(report['skipped_traces'])} "
            "non-replayable trace(s)"
        )
    for v in stage_rows:
        b = v.get("base")
        n = v.get("new")
        print(
            f"  {v['metric']}: recorded="
            f"{b if b is not None else '-'} replayed="
            f"{n if n is not None else '-'} [{v['verdict']}]"
        )
    print("REPLAY " + ("BIT-EXACT" if report["mismatches"] == 0
                       else "DIVERGED"))
    return exit_code


if __name__ == "__main__":
    raise SystemExit(main())
