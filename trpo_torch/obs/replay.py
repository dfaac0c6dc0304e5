"""Replay-bundle reconstruction for trace-driven deterministic replay
(counterpart: ``trpo_tpu/obs/replay.py``).

The capture log (``obs/capture.py``) records each sampled request's
inputs; the carry journals record every session's state at journal sync
cadence; the span stream records where the time went. This module joins
the three into a **replay bundle** — a single self-contained JSON
document that ``scripts/replay_run`` can re-execute against a
fresh shadow replica set:

* ``sessions`` — per recorded session: the acts in causal ``seq``
  order (each with its base64 wire-frame obs payload and the recorded
  action — the bit-exact diff oracle), plus a ``seed`` journal
  snapshot when the capture window opens MID-session (the snapshot
  whose ``seq`` is exactly ``first_captured_seq - 1``; anything else
  would replay from the wrong carry, so a missing aligned snapshot
  marks the trace non-replayable rather than silently diverging —
  the oracle's staleness bound is the journal sync cadence).
* ``stateless`` — the ``/act`` captures, payload + recorded action.
* ``completeness`` — per selected trace: ``replayable: true/false``
  and, when false, WHICH piece is missing (capture payload, aligned
  journal seed, recorded action, assembled spans). The silent-miss
  seam this closes: ``assemble_traces`` used to drop unjoinable spans
  without saying so, and a bundle built over a gap would replay
  *something* and call it the incident.
* ``faults`` — the incident window's fault/lease/session records, so
  the replayed trace can be read against what production was doing.
* ``recorded`` — the recorded traces' stage summary
  (``_summarize_traces`` shape): ``replay_run`` feeds it through
  ``compare_runs`` against the shadow run's own summary for the
  per-stage p99 regression rows.

``build_bundle`` raises :class:`BundleError` (never a stack trace at
the CLI — ``analyze_run.py --export-bundle`` maps it to exit 2) when
the trace id is unknown or the capture log lacks it.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "BUNDLE_VERSION",
    "BundleError",
    "build_bundle",
    "write_bundle",
    "load_bundle",
    "scan_journals",
    "action_match",
]

BUNDLE_VERSION = 1

# fault-timeline slack around the captured acts: detection records
# (lease expiry, session resume) land AFTER the acts that tripped them
_FAULT_SLACK_S = 30.0


class BundleError(ValueError):
    """A bundle that cannot be built, with a message fit for an exit-2
    CLI refusal (unknown trace id, capture log without payloads)."""


def scan_journals(journal_dir: Optional[str]) -> Dict[str, List[dict]]:
    """EVERY entry (not latest-wins) per session across all carry
    journals in ``journal_dir`` — reconstruction needs the snapshot at
    one exact ``seq``, which latest-wins ``read_carry_journal`` throws
    away. A fenced zombie's frozen journal is often exactly the
    pre-takeover snapshot a mid-window replay seeds from, so fences
    are NOT filtered here. Entries per session sort by time."""
    entries: Dict[str, List[dict]] = {}
    if journal_dir is None:
        return entries
    for path in sorted(
        glob.glob(os.path.join(journal_dir, "*.carry.jsonl"))
    ):
        try:
            f = open(path, "rb")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn line: absent, not fatal
                if not isinstance(rec, dict) or rec.get("drop"):
                    continue
                sid = rec.get("session")
                if not isinstance(sid, str) or not sid:
                    continue
                if not isinstance(rec.get("carry"), list):
                    continue
                if not isinstance(rec.get("steps"), int):
                    continue
                rec = dict(rec)
                rec["journal"] = os.path.basename(path)
                entries.setdefault(sid, []).append(rec)
    for sid in entries:
        entries[sid].sort(key=lambda e: e.get("t", 0))
    return entries


def _entry_seq(entry: dict) -> Optional[int]:
    seq = entry.get("seq")
    if isinstance(seq, int) and not isinstance(seq, bool):
        return seq
    steps = entry.get("steps")
    if isinstance(steps, int) and not isinstance(steps, bool):
        # router-stamped flows advance seq and steps in lockstep; a
        # seq-less entry (direct client) falls back to the step count
        return steps
    return None


def _pick_record(candidates: List[dict]) -> dict:
    """One capture record per logical act: the router-side record wins
    (it carries the global arrival order at the public edge), then
    whichever record is most complete (payload + action)."""

    def score(rec: dict) -> tuple:
        return (
            rec.get("process") == "router",
            "payload" in rec,
            "action" in rec,
            -(rec.get("t") or 0),
        )

    return max(candidates, key=score)


def _dedupe(captures: List[dict]) -> List[dict]:
    by_key: Dict[tuple, List[dict]] = {}
    for rec in captures:
        if rec.get("endpoint") == "session_act":
            key = (rec.get("trace"), rec.get("session"), rec.get("seq"))
        else:
            key = (rec.get("trace"), "stateless")
        by_key.setdefault(key, []).append(rec)
    picked = [_pick_record(v) for v in by_key.values()]
    picked.sort(key=lambda r: (r.get("t", 0), r.get("order", 0)))
    return picked


def _act_row(rec: dict) -> dict:
    row = {
        "trace": rec.get("trace"),
        "order": rec.get("order"),
        "path": rec.get("path"),
        "endpoint": rec.get("endpoint"),
        "status": rec.get("status"),
        "t": rec.get("t"),
    }
    for key in ("session", "seq", "payload", "action", "step",
                "replica", "forced"):
        if rec.get(key) is not None:
            row[key] = rec[key]
    return row


def build_bundle(
    records: list,
    trace_id: Optional[str] = None,
    window: Optional[Tuple[float, float]] = None,
    journal_dir: Optional[str] = None,
) -> dict:
    """One replay bundle from a loaded (merged) event stream — select
    by one ``trace_id`` or a ``(start, end)`` unix-seconds ``window``
    (an incident window: every captured trace inside it). Raises
    :class:`BundleError` when the selection is empty or un-replayable
    as a whole (no payloads at all)."""
    from trpo_torch.obs.analyze import _summarize_traces, assemble_traces
    from trpo_torch.obs.capture import capture_records

    if (trace_id is None) == (window is None):
        raise BundleError(
            "select exactly one of: a trace id, or --window START END"
        )
    captures = capture_records(records)
    if trace_id is not None:
        selected = [r for r in captures if r.get("trace") == trace_id]
        if not selected:
            dropped_spans: list = []
            traces = assemble_traces(records, dropped=dropped_spans)
            if trace_id in traces:
                raise BundleError(
                    f"trace {trace_id} has {len(traces[trace_id])} "
                    "assembled spans but NO capture records — the "
                    "capture log lacks its payloads (was capture "
                    "armed on the router when it ran?)"
                )
            raise BundleError(
                f"unknown trace id {trace_id!r}: no capture record or "
                f"span names it ({len(traces)} traces, "
                f"{len(captures)} captures in the log"
                + (
                    f"; {len(dropped_spans)} span records had no "
                    "joinable trace id"
                    if dropped_spans else ""
                )
                + ")"
            )
    else:
        start, end = float(window[0]), float(window[1])
        if end < start:
            raise BundleError(
                f"--window END ({end}) precedes START ({start})"
            )
        selected = [
            r for r in captures
            if start <= (r.get("t") or 0) <= end
        ]
        if not selected:
            raise BundleError(
                f"no capture records in window [{start}, {end}] "
                f"({len(captures)} captures in the log)"
            )
    selected = _dedupe(selected)
    tids = sorted({r.get("trace") for r in selected})

    dropped_spans = []
    traces = assemble_traces(records, dropped=dropped_spans)
    journals = scan_journals(journal_dir)

    sessions: Dict[str, dict] = {}
    stateless: List[dict] = []
    for rec in selected:
        row = _act_row(rec)
        if rec.get("endpoint") == "session_act" and rec.get("session"):
            sess = sessions.setdefault(
                rec["session"], {"seed": None, "acts": []}
            )
            sess["acts"].append(row)
        else:
            stateless.append(row)
    for sess in sessions.values():
        # causal order within a session is the stamped seq (arrival
        # order `order` breaks ties for seq-less acts)
        sess["acts"].sort(
            key=lambda a: (
                a.get("seq") if a.get("seq") is not None else 1 << 60,
                a.get("order") or 0,
            )
        )

    # per-trace completeness: a bundle is whole or LOUDLY partial
    completeness = []
    session_missing: Dict[str, str] = {}
    for sid, sess in sessions.items():
        seqs = [
            a["seq"] for a in sess["acts"] if a.get("seq") is not None
        ]
        first = min(seqs) if seqs else None
        sess["first_seq"] = first
        if first is None or first <= 1:
            continue  # the session was created inside the window
        want = first - 1
        aligned = [
            e for e in journals.get(sid, [])
            if _entry_seq(e) == want
        ]
        if aligned:
            sess["seed"] = aligned[-1]
        else:
            have = sorted(
                {
                    s for s in (
                        _entry_seq(e) for e in journals.get(sid, [])
                    )
                    if s is not None
                }
            )
            session_missing[sid] = (
                f"journal snapshot at seq {want} for session {sid} "
                f"(found seqs {have or 'none'} — the bit-exact oracle "
                "only holds from an aligned snapshot; its staleness "
                "bound is the journal sync cadence)"
            )
    for tid in tids:
        missing = []
        recs = [r for r in selected if r.get("trace") == tid]
        for rec in recs:
            if rec.get("payload") is None:
                missing.append(
                    "capture payload (wire-encoded obs) for "
                    f"order {rec.get('order')}"
                )
            if rec.get("action") is None:
                missing.append(
                    "recorded action (the diff oracle) for "
                    f"order {rec.get('order')}"
                )
            sid = rec.get("session")
            if sid in session_missing:
                missing.append(session_missing[sid])
        if tid not in traces:
            missing.append(
                "assembled trace spans (no per-stage baseline"
                + (
                    f"; {len(dropped_spans)} span records in the log "
                    "had no joinable trace id"
                    if dropped_spans else ""
                )
                + ")"
            )
        completeness.append({
            "trace": tid,
            "replayable": not missing,
            "missing": missing,
        })

    steps = [
        r["step"] for r in selected
        if isinstance(r.get("step"), int)
    ]
    checkpoint_step = (
        max(set(steps), key=steps.count) if steps else None
    )

    times = [r.get("t") or 0 for r in selected]
    lo = min(times) - _FAULT_SLACK_S
    hi = max(times) + _FAULT_SLACK_S
    faults = [
        r for r in records
        if (
            r.get("kind") in ("fault_injected", "recovery")
            or (
                r.get("kind") == "lease"
                and r.get("event") in (
                    "expired", "fenced_write_refused"
                )
            )
            or (
                r.get("kind") == "session"
                and r.get("event") in (
                    "resumed", "reestablished", "drained"
                )
            )
        )
        and lo <= (r.get("t") or 0) <= hi
    ]

    recorded = _summarize_traces(
        [
            r for r in records
            if r.get("kind") == "span" and r.get("trace") in set(tids)
        ]
    )

    return {
        "bundle_version": BUNDLE_VERSION,
        "trace_id": trace_id,
        "window": list(window) if window is not None else None,
        "checkpoint_step": checkpoint_step,
        "acts_total": len(selected),
        "sessions": sessions,
        "stateless": stateless,
        "completeness": completeness,
        "replayable": all(c["replayable"] for c in completeness),
        "faults": faults,
        "recorded": recorded,
    }


def write_bundle(bundle: dict, path: str) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_bundle(path: str) -> dict:
    """Parse + version-check one bundle file; :class:`BundleError` on
    anything unreadable (the CLI maps it to exit 2)."""
    try:
        with open(path) as f:
            bundle = json.load(f)
    except OSError as e:
        raise BundleError(f"cannot read bundle {path}: {e}")
    except ValueError as e:
        raise BundleError(f"bundle {path} is not JSON: {e}")
    if not isinstance(bundle, dict) or "bundle_version" not in bundle:
        raise BundleError(
            f"{path} is not a replay bundle (no bundle_version)"
        )
    if bundle["bundle_version"] != BUNDLE_VERSION:
        raise BundleError(
            f"bundle version {bundle['bundle_version']} != supported "
            f"{BUNDLE_VERSION}"
        )
    return bundle


def action_match(recorded, replayed) -> bool:
    """The bit-exact oracle: both sides as float64 (JSON float repr
    round-trips float64 exactly, so parsed action lists compare at
    full precision), equal element-for-element or the replay FAILED."""
    try:
        a = np.asarray(recorded, np.float64)
        b = np.asarray(replayed, np.float64)
    except (TypeError, ValueError):
        return False
    return a.shape == b.shape and bool(np.array_equal(a, b))
