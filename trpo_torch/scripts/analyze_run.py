#!/usr/bin/env python
"""Summarize one event-JSONL run, or gate a new run against a baseline.

    python -m trpo_torch.scripts.analyze_run RUN.jsonl
    python -m trpo_torch.scripts.analyze_run RUN.jsonl --compare BASE.jsonl \\
        [--threshold-pct 20] [--min-ms 1.0] [--json]
    python -m trpo_torch.scripts.analyze_run ROUTER.jsonl --merge replica0.jsonl \\
        --merge replica1.jsonl --trace <id>        # one trace waterfall
    python -m trpo_torch.scripts.analyze_run ROUTER.jsonl --slowest-traces 5
    python -m trpo_torch.scripts.analyze_run ROUTER.jsonl --merge replica0.jsonl \\
        --export-bundle <trace_id> --journal-dir JDIR --out B.json

Single file: a run report — per-phase time table, throughput (steady
iteration ms + timesteps/s), health/recompile/fault summary, peak-memory
report (compiled program footprints + live-buffer peak), and — for
serving runs (``serve`` events from ``trpo_torch/serve``) — the serving
SLO block (requests/batches, actions/s, latency p50/p99, per-rung
table). With ``--compare``, the per-phase and per-metric regression
verdicts of ``trpo_torch.obs.analyze.compare_runs``: time-like metrics
(including serving latency p50/p99, overall and per padded rung, and
the per-trace-stage p99 rows) regress when they grow past the
threshold, rate-like (timesteps/s, serving actions/s) when they shrink
past it, byte-like when they grow past it; sub-``--min-ms`` phases and
metrics a run did not measure are skipped, never silently judged — and
serve rows appear only when at least one run actually served.

Request traces: ``--merge FILE`` (repeatable) folds more
per-process event logs into the record stream — a multi-host serving
run writes one log per process (router + each replica child), and the
trace assembler joins spans ACROSS them by trace id. ``--trace ID``
renders one assembled trace as a text waterfall (``--json``: the raw
span list); ``--slowest-traces K`` ranks the top-K traces by root
duration with their per-stage breakdown (``--json``: machine-readable
rows — stdout stays parseable, the fleet CLI contract).

Deterministic replay: ``--export-bundle <trace_id>`` (or
``--export-bundle --window START END`` for an incident window) joins
the capture log, the assembled traces, and — via ``--journal-dir`` —
the carry journals into a self-contained replay bundle that
``replay_run`` re-executes bit-exact against a shadow
replica set. An unknown trace id or a capture log without payloads is
a one-line refusal and exit 2, never a stack trace.

Exit codes (the contract a regression gate relies on): **0** = summarized / compared clean, **1** = at least one metric
REGRESSED past the threshold, **2** = usage or unreadable/empty input
(including ``--trace`` ids the logs do not contain).

``--json`` prints the machine-readable summary (or comparison) instead
of the text report. The reader is tolerant (corrupt mid-file records are
skipped with a warning); run ``validate_events`` first when
strictness matters.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.analyze_run",
        description="summarize / regression-gate trpo-tpu event logs",
    )
    p.add_argument("run", help="event JSONL of the run to analyze")
    p.add_argument(
        "--compare", metavar="BASELINE",
        help="baseline event JSONL; exit 1 if RUN regressed past the "
        "threshold on any phase/metric",
    )
    p.add_argument(
        "--threshold-pct", type=float, default=20.0,
        help="regression threshold in percent (default 20)",
    )
    p.add_argument(
        "--min-ms", type=float, default=1.0,
        help="ignore phases whose mean is below this in both runs "
        "(default 1.0 — sub-millisecond phases are scheduler noise)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable summary/comparison JSON",
    )
    p.add_argument(
        "--merge", metavar="FILE", action="append", default=[],
        help="merge another per-process event log (repeatable) — a "
        "replicated run's traces span the router's log AND each "
        "replica's; the assembler joins them by trace id",
    )
    p.add_argument(
        "--trace", metavar="ID",
        help="render ONE assembled trace as a waterfall (exit 2 when "
        "the logs have no spans for it)",
    )
    p.add_argument(
        "--slowest-traces", metavar="K", type=int,
        help="rank the top-K assembled traces by root duration with "
        "their per-stage breakdown",
    )
    p.add_argument(
        "--export-bundle", metavar="TRACE_ID", nargs="?", const="",
        default=None,
        help="build a deterministic-replay bundle for ONE "
        "captured trace id, or — with --window — every captured "
        "trace in an incident window; exit 2 with a named reason "
        "when the trace is unknown or the capture log lacks its "
        "payloads",
    )
    p.add_argument(
        "--window", nargs=2, metavar=("START", "END"), type=float,
        help="with --export-bundle: select every capture whose unix "
        "arrival time falls in [START, END]",
    )
    p.add_argument(
        "--journal-dir", metavar="DIR",
        help="carry-journal directory — seeds mid-window sessions "
        "from the snapshot at first_captured_seq - 1",
    )
    p.add_argument(
        "--out", metavar="FILE",
        help="bundle output path (default: <trace_id|window>.bundle."
        "json next to the run log)",
    )
    return p


def _load_records(path: str):
    from trpo_torch.obs.analyze import load_events

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        records = load_events(path)
    for w in caught:
        print(f"WARN     {w.message}", file=sys.stderr)
    return records


def _load_summary(path: str, merge=()):
    from trpo_torch.obs.analyze import summarize_run

    records = _load_records(path)
    if not records:
        print(f"ERROR    {path}: no readable records", file=sys.stderr)
        return None
    for extra in merge:
        try:
            records = records + _load_records(extra)
        except OSError as e:
            # name the MERGE file, not the primary run, in the error
            print(
                f"ERROR    {extra}: unreadable ({e})", file=sys.stderr
            )
            return None
    return summarize_run(records)


def _trace_views(args) -> int:
    """``--trace`` / ``--slowest-traces``: assemble spans across the
    run log plus every ``--merge`` file, then render."""
    from trpo_torch.obs.analyze import (
        assemble_traces,
        render_waterfall,
        trace_breakdown,
    )

    records = []
    for path in [args.run] + list(args.merge):
        try:
            records.extend(_load_records(path))
        except OSError as e:
            print(f"ERROR    {path}: unreadable ({e})", file=sys.stderr)
            return 2
    traces = assemble_traces(records)
    if args.trace is not None:
        spans = traces.get(args.trace)
        if not spans:
            print(
                f"ERROR    no spans for trace {args.trace!r} in "
                f"{1 + len(args.merge)} log(s) "
                f"({len(traces)} traces present)",
                file=sys.stderr,
            )
            return 2
        if args.json:
            print(json.dumps({"trace": args.trace, "spans": spans}))
        else:
            print(render_waterfall(spans))
        return 0
    rows = sorted(
        (
            b for b in (
                trace_breakdown(s) for s in traces.values()
            )
            if b is not None
        ),
        key=lambda b: -b["root_ms"],
    )[: max(0, args.slowest_traces)]
    if args.json:
        print(json.dumps({"slowest": rows}))
        return 0
    if not rows:
        print("no assembled traces (did the run sample any?)")
        return 0
    from trpo_torch.obs.analyze import format_table

    print(format_table(
        [
            [
                b["trace"], b["root"], f"{b['root_ms']:.2f}",
                b["spans"],
                ", ".join(
                    f"{k}={v:.1f}" for k, v in b["stages"].items()
                ),
            ]
            for b in rows
        ],
        ["trace", "root", "root_ms", "spans", "stage breakdown (ms)"],
    ))
    return 0


def _export_bundle(args) -> int:
    """``--export-bundle``: capture log (+ merges) → one replay
    bundle on disk. Every refusal is a one-line named reason and
    exit 2 — never a stack trace (the fleet-CLI contract)."""
    from trpo_torch.obs.replay import BundleError, build_bundle, write_bundle

    trace_id = args.export_bundle or None
    if (trace_id is None) == (args.window is None):
        print(
            "ERROR    --export-bundle needs exactly one selector: a "
            "trace id, or --window START END",
            file=sys.stderr,
        )
        return 2
    records = []
    for path in [args.run] + list(args.merge):
        try:
            records.extend(_load_records(path))
        except OSError as e:
            print(f"ERROR    {path}: unreadable ({e})", file=sys.stderr)
            return 2
    try:
        bundle = build_bundle(
            records,
            trace_id=trace_id,
            window=tuple(args.window) if args.window else None,
            journal_dir=args.journal_dir,
        )
    except BundleError as e:
        print(f"ERROR    {e}", file=sys.stderr)
        return 2
    out = args.out
    if out is None:
        stem = trace_id or (
            f"window-{int(args.window[0])}-{int(args.window[1])}"
        )
        out = os.path.join(
            os.path.dirname(os.path.abspath(args.run)),
            f"{stem}.bundle.json",
        )
    write_bundle(bundle, out)
    broken = [c for c in bundle["completeness"] if not c["replayable"]]
    print(
        f"wrote {out}: {bundle['acts_total']} act(s), "
        f"{len(bundle['sessions'])} session(s), "
        f"checkpoint step {bundle['checkpoint_step']}, "
        f"{len(bundle['completeness']) - len(broken)}/"
        f"{len(bundle['completeness'])} trace(s) replayable"
    )
    for c in broken:
        for piece in c["missing"]:
            print(f"  NOT REPLAYABLE {c['trace']}: {piece}")
    if args.json:
        print(json.dumps({
            "bundle": out,
            "acts": bundle["acts_total"],
            "replayable": bundle["replayable"],
            "completeness": bundle["completeness"],
        }))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from trpo_torch.obs.analyze import (
        compare_runs,
        render_comparison,
        render_summary,
    )

    if args.export_bundle is not None or args.window is not None:
        if args.compare or args.trace or args.slowest_traces:
            print(
                "ERROR    --export-bundle is its own view — run "
                "--compare/--trace separately",
                file=sys.stderr,
            )
            return 2
        return _export_bundle(args)

    if args.trace is not None or args.slowest_traces is not None:
        if args.compare:
            print(
                "ERROR    --trace/--slowest-traces and --compare are "
                "different views — run them separately",
                file=sys.stderr,
            )
            return 2
        return _trace_views(args)

    try:
        run = _load_summary(args.run, merge=args.merge)
    except OSError as e:
        print(f"ERROR    {args.run}: unreadable ({e})", file=sys.stderr)
        return 2
    if run is None:
        return 2

    if not args.compare:
        if args.json:
            print(json.dumps(run))
        else:
            print(render_summary(run))
        return 0

    try:
        base = _load_summary(args.compare)
    except OSError as e:
        print(f"ERROR    {args.compare}: unreadable ({e})",
              file=sys.stderr)
        return 2
    if base is None:
        return 2
    result = compare_runs(
        base, run,
        threshold_pct=args.threshold_pct,
        min_ms=args.min_ms,
    )
    if args.json:
        print(json.dumps(result))
    else:
        print(render_comparison(result))
    return 1 if result["regressed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
