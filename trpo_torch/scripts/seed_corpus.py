#!/usr/bin/env python
"""Seed a deterministic-replay regression corpus
(counterpart: ``scripts/seed_corpus.py``).

    python -m trpo_torch.scripts.seed_corpus --out DIR [--device cpu]
    python -m trpo_torch.scripts.seed_corpus --checkpoint-only --out DIR
    python -m trpo_torch.scripts.seed_corpus --from-run RUN.jsonl \\
        --slowest 3 --out DIR

A corpus holds replay bundles that ``replay_run`` re-executes against a
shadow replica set — a standing check that the serving stack still
reproduces recorded incidents bit-exact. Bundles embed their obs
payloads, journal seeds, and recorded actions, but NOT the checkpoint
weights; instead the weights are pinned by recipe — the exact config +
seeds below — so a check regenerates them on the fly
(``--checkpoint-only``, a ``step_<n>/`` checkpoint) instead of
committing weights. Changing the recipe (config fields, seeds, init
scheme) invalidates every recorded action in a corpus: re-seed with this
script. The recording mode writes everything (the bundle, the recorded
log and journals under ``recording/``) into ``--out``. A corpus is
bit-exact on the machine and device that recorded it: GEMMs round
another way on another device.

The seeded bundle is the hard case on purpose: a MID-WINDOW export
whose session predates the capture window, so replay must seed from
the bundled carry-journal snapshot (seq = first_captured_seq - 1) —
the same reconstruction a takeover-era incident bundle needs.

``--from-run`` mines a REAL run instead of recording a
synthetic one: it ranks the log's assembled traces by root-span
duration and exports the ``--slowest K`` as per-trace replay bundles
(``slow-<rank>-<trace>.bundle.json``) — the worst latency incidents a
run actually served become standing replay material. Traces the
capture plane did not record payloads for cannot bundle; they are
reported and skipped, and the ranking keeps descending until K bundles
exist or the captured traces run out. Pass ``--journal-dir`` when the
run's carry journals still exist so mid-session traces get their
journal seed; without it such traces export loudly-partial and are
skipped too (a corpus bundle must be whole).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
import urllib.request

# THE corpus recipe — the reference's, so the two corpora share a model.
# Every recorded action in a corpus is a function of these values.
CORPUS_CFG = dict(
    n_envs=4, batch_timesteps=32, cg_iters=2, vf_train_steps=2,
    policy_hidden=(8,), vf_hidden=(8,), seed=5, policy_gru=8,
)
CORPUS_PRESET = "pendulum"
CORPUS_INIT_SEED = 0
CORPUS_STEP = 1
CORPUS_OBS_SEED = 100  # act i uses RandomState(CORPUS_OBS_SEED + i)
CORPUS_ACTS = 6
CORPUS_WINDOW_FROM = 3  # export acts [3:] -> journal-seeded bundle


def _build_agent(device=None):
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig

    agent = TRPOAgent(CORPUS_PRESET, TRPOConfig(**CORPUS_CFG),
                      device=device)
    return agent, agent.init_state(seed=CORPUS_INIT_SEED)


def write_checkpoint(out_dir: str, device=None) -> str:
    """The corpus checkpoint, regenerated from the pinned recipe."""
    from trpo_torch.utils.checkpoint import Checkpointer

    agent, state = _build_agent(device)
    ck_dir = os.path.join(out_dir, "ck")
    Checkpointer(ck_dir).save(CORPUS_STEP, state)
    return ck_dir


def mine_slowest(
    run_paths: list, out_dir: str, k: int,
    journal_dir: str | None = None,
) -> list:
    """Export the ``k`` slowest captured traces of a finished run
    (its event logs, merged — pass router + every child log of a
    multi-process run so traces assemble whole) as replay bundles.
    Returns the written paths (possibly fewer than ``k`` — every skip
    is printed, never silent)."""
    from trpo_torch.obs.analyze import assemble_traces, load_events
    from trpo_torch.obs.capture import capture_records
    from trpo_torch.obs.replay import BundleError, build_bundle, write_bundle

    records = []
    for path in run_paths:
        records.extend(load_events(path))
    records.sort(key=lambda r: r.get("t") or 0.0)
    traces = assemble_traces(records)
    captured = {r.get("trace") for r in capture_records(records)}

    # rank every assembled trace by its root span's duration — the
    # root is the span with no parent (joined cross-process, so this
    # is true end-to-end time, not one hop's share)
    ranked = []
    for tid, spans in traces.items():
        roots = [s for s in spans if not s.get("parent")]
        if not roots:
            continue
        ranked.append((max(_dur_ms(s) for s in roots), tid))
    ranked.sort(reverse=True)
    if not ranked:
        print(
            f"no assembled traces in {' '.join(run_paths)} — "
            "nothing to mine"
        )
        return []

    written = []
    skipped_uncaptured = 0
    for dur, tid in ranked:
        if len(written) >= k:
            break
        if tid not in captured:
            skipped_uncaptured += 1
            continue
        try:
            bundle = build_bundle(
                records, trace_id=tid, journal_dir=journal_dir
            )
        except BundleError as e:
            print(f"skip {tid} ({dur:.1f} ms): {e}")
            continue
        if not bundle["replayable"]:
            print(
                f"skip {tid} ({dur:.1f} ms): partial — "
                f"{bundle['completeness']}"
            )
            continue
        rank = len(written) + 1
        path = os.path.join(out_dir, f"slow-{rank}-{tid}.bundle.json")
        write_bundle(bundle, path)
        written.append(path)
        print(
            f"mined #{rank}: trace {tid} root {dur:.1f} ms, "
            f"{bundle['acts_total']} act(s) -> {path}"
        )
    if skipped_uncaptured:
        print(
            f"note: {skipped_uncaptured} slower trace(s) had no "
            "capture payloads (capture sampling) — ranking descended "
            "past them"
        )
    if len(written) < k:
        print(
            f"mined {len(written)}/{k} bundle(s): the run's captured "
            "traces ran out"
        )
    return written


def _dur_ms(span: dict) -> float:
    v = span.get("dur_ms")
    return float(v) if isinstance(v, (int, float)) else 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m trpo_torch.scripts.seed_corpus")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--checkpoint-only", action="store_true",
        help="only regenerate the corpus checkpoint (a replay check's "
        "per-run step) — no recording, no bundles",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback to the CPU")
    p.add_argument(
        "--from-run", metavar="RUN.jsonl", nargs="+",
        help="mine an existing run's event log(s) instead of "
        "recording a synthetic session — pass router + child logs "
        "together so multi-process traces assemble whole",
    )
    p.add_argument(
        "--slowest", type=int, default=3, metavar="K",
        help="with --from-run: export the K slowest captured traces "
        "(default 3)",
    )
    p.add_argument(
        "--journal-dir",
        help="with --from-run: the run's carry-journal dir, for "
        "bundles whose sessions predate their capture window",
    )
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.checkpoint_only:
        ck_dir = write_checkpoint(args.out, args.device)
        print(f"corpus checkpoint (step {CORPUS_STEP}) at {ck_dir}")
        return 0

    if args.from_run:
        if args.slowest < 1:
            p.error("--slowest must be >= 1")
        written = mine_slowest(
            args.from_run, args.out, args.slowest,
            journal_dir=args.journal_dir,
        )
        return 0 if written else 1

    import numpy as np

    from trpo_torch.obs.capture import RequestCapture, capture_records
    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields
    from trpo_torch.obs.replay import build_bundle, write_bundle
    from trpo_torch.obs.trace import TRACE_HEADER, Tracer, mint_trace_id
    from trpo_torch.serve import (
        InProcessReplica,
        PolicyServer,
        ReplicaSet,
        Router,
    )

    def _post(url, payload=None, headers=None, timeout=30.0):
        import urllib.error

        data = b"" if payload is None else json.dumps(payload).encode()
        h = {"Content-Type": "application/json"}
        h.update(headers or {})
        req = urllib.request.Request(url, data=data, headers=h)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    agent, state = _build_agent(args.device)
    tmp = os.path.join(args.out, "recording")
    shutil.rmtree(tmp, ignore_errors=True)  # a re-seed starts clean
    os.makedirs(tmp)
    log = os.path.join(tmp, "recorded.jsonl")
    bus = EventBus(JsonlSink(log))
    bus.emit(
        "run_manifest",
        **manifest_fields(None, extra={"driver": "seed_corpus"}),
    )
    tracer = Tracer(bus, 1.0, process="router")
    capture = RequestCapture(bus, process="router")
    jdir = os.path.join(tmp, "cj")

    def factory(rid):
        def build():
            engine = agent.serve_session_engine()
            engine.load(
                state.policy_params, state.obs_norm, step=CORPUS_STEP
            )
            server = PolicyServer(
                engine, None, port=0, bus=bus, tracer=tracer,
                replica_name=rid, carry_journal_dir=jdir,
            )
            return server, []

        return build

    rs = ReplicaSet(
        lambda rid: InProcessReplica(factory(rid)), 2, bus=bus,
        health_interval=60.0, backoff=0.05, health_fail_threshold=1,
        max_restarts=2,
    )
    assert rs.wait_healthy(2, timeout=120.0), rs.snapshot()
    router = Router(
        rs, port=0, bus=bus, journal_dir=jdir, tracer=tracer,
        capture=capture,
    )
    try:
        status, out = _post(router.url + "/session")
        assert status == 200, out
        sid = out["session"]
        for i in range(CORPUS_ACTS):
            obs = (
                np.random.RandomState(CORPUS_OBS_SEED + i)
                .randn(*agent.obs_shape).astype(np.float32)
            )
            status, out = _post(
                router.url + f"/session/{sid}/act",
                {"obs": obs.tolist()},
                headers={TRACE_HEADER: mint_trace_id()},
            )
            assert status == 200, (status, out)
        capture.drain()
        assert capture.dropped_total == 0, capture.dropped_total
    finally:
        router.close()
        tracer.drain()
        tracer.close()
        capture.close()
        rs.close()
        bus.close()

    from trpo_torch.obs.analyze import load_events

    records = load_events(log)
    caps = capture_records(records)
    assert len(caps) == CORPUS_ACTS, len(caps)
    bundle = build_bundle(
        records,
        window=(caps[CORPUS_WINDOW_FROM]["t"] - 1e-4, time.time()),
        journal_dir=jdir,
    )
    assert bundle["replayable"], bundle["completeness"]
    assert bundle["sessions"][sid]["seed"] is not None, (
        "the corpus bundle must exercise journal seeding"
    )
    out_path = os.path.join(
        args.out, "session-takeover-window.bundle.json"
    )
    write_bundle(bundle, out_path)
    print(
        f"seeded {out_path}: {bundle['acts_total']} act(s), "
        f"journal seed at seq "
        f"{bundle['sessions'][sid]['seed'].get('seq')}, checkpoint "
        f"step {bundle['checkpoint_step']} (recipe: {CORPUS_PRESET} "
        f"init_seed={CORPUS_INIT_SEED})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
