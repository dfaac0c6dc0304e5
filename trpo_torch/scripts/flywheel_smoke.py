#!/usr/bin/env python
"""Train→serve flywheel smoke (counterpart: the reference's
``scripts/flywheel_smoke.py``).

    python -m trpo_torch.scripts.flywheel_smoke --tmp DIR [--quick]
        [--device cuda|cpu]

One closed loop, end to end, on the card unless ``--device cpu``:

1. **Fleet** — a real 2-member pendulum fleet (GRU-8 policy) trains
   under the :class:`FleetScheduler`; every member must finish and
   :func:`pick_winner` must name a winner through the compare-gate.
   The fleet-level bench row (``phase``/``fleet/wall``) rides the bus.
2. **kill_promoter** — the winner's FIRST promotion dies mid-flight
   (``kill_promoter@step=1``: after the serve-step-1 publish is
   durable, before the gate drives). While the wreck sits, the
   ``promoter_stuck`` alert must fire off its journal; a RESTARTED
   controller must then converge on the journal + completion markers
   WITHOUT re-publishing, drive the reward-aware canary gate, and land
   ``promoted``.
3. **Live flywheel traffic** — client session threads route through
   the canary-striding router, reporting per-act ``reward`` (the
   realized cost ``-mean(action²)``) and ``done``; completed-episode
   returns book per replica. Sessions are the only traffic plane, so
   the reward gate judges and the parity leg stands down.
4. **regress_checkpoint** — the next candidate's weights are rewritten
   at publish (policy leaves ×8: saves cleanly, LOADS cleanly, only
   behaves worse). p99 and parity cannot see it; the reward gate must
   reject it — canary ``rolled_back`` naming the realized return —
   and the incumbent must keep serving.
5. **corrupt_checkpoint** — the following candidate's published files
   (``step_<n>/``) are torn AFTER the completion marker lands; the
   canary's reload must fail loudly and the gate must reject,
   incumbent untouched.
6. **Feedback** — the served episode returns pool into a ``promote``
   ``feedback`` record, and :func:`feedback_scores` reads it back from
   the event log — the edge the next fleet round's scoring blends in.
7. Zero client-visible errors across ALL of it, and the whole log is
   left at ``DIR/flywheel_events.jsonl`` for ``python -m
   trpo_torch.scripts.validate_events`` (every injected fault matched by
   its REQUIRED detector; no stranded promotions; canary
   started→terminal).

``--quick`` trains 1 iteration per member instead of 2. Each step
prints the seconds it took (``t=``); the last line before the OK line
is one JSON object of those timings and counts. Exit 0 on success; any
assertion failure exits nonzero with the reason.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request


def _post(url, payload=None, timeout=30.0):
    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.flywheel_smoke")
    p.add_argument("--tmp", required=True, help="scratch directory")
    p.add_argument(
        "--quick", action="store_true",
        help="1 training iteration per member instead of 2",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the fleet members' and "
                   "the serving replicas' device")
    args = p.parse_args(argv)

    import numpy as np

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.fleet import FleetScheduler, FleetSpec, MemberSpec
    from trpo_torch.fleet.promote import (
        PromotionController,
        feedback_scores,
        pick_winner,
    )
    from trpo_torch.obs.analyze import load_events
    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields
    from trpo_torch.resilience.inject import FaultInjector, PromoterKilled
    from trpo_torch.serve import (
        CanaryController,
        InProcessReplica,
        PolicyServer,
        ReplicaSet,
        Router,
    )
    from trpo_torch.utils.checkpoint import Checkpointer

    t_start = time.perf_counter()
    timings = {}

    def mark(name: str) -> float:
        timings[name] = time.perf_counter() - t_start
        return timings[name]

    os.makedirs(args.tmp, exist_ok=True)
    events_path = os.path.join(args.tmp, "flywheel_events.jsonl")
    bus = EventBus(JsonlSink(events_path))
    bus.emit(
        "run_manifest",
        **manifest_fields(None, extra={"driver": "flywheel_smoke"},
                          device=args.device),
    )

    # -- 1. train a small fleet, pick the winner through the gate --------
    iters = 1 if args.quick else 2
    base = (
        "--preset", "pendulum", "--device", args.device,
        "--iterations", str(iters),
        "--n-envs", "2", "--batch-timesteps", "512",
        "--policy-hidden", "8", "--policy-gru", "8",
        "--cg-iters", "2", "--checkpoint-every", "1",
    )
    spec = FleetSpec(
        members=(
            MemberSpec("seed0", (("seed", 0),)),
            MemberSpec("seed1", (("seed", 1),)),
        ),
        base_args=base, max_workers=2,
        poll_interval=0.1, scrape_interval=60.0,
    )
    fleet_dir = os.path.join(args.tmp, "fleet")
    sch = FleetScheduler(spec, fleet_dir, bus=bus)
    try:
        result = sch.run(timeout=1200.0)
    finally:
        sch.close()
    states = {m: r["state"] for m, r in result["members"].items()}
    assert all(s == "finished" for s in states.values()), states
    winner = pick_winner(result)
    assert winner is not None, (
        f"no promotable member: scores={result['scores']} "
        f"gate={result['gate']['members']}"
    )
    winner_ck = sch.members[winner].checkpoint_dir
    bench = result["bench"]
    print(
        f"fleet: 2 members finished, winner {winner} "
        f"(scores {result['scores']}); t={mark('fleet'):.1f} s; bench "
        "fleet wall "
        f"{bench['fleet_wall_ms'] / 1e3:.1f}s vs member sum "
        f"{bench['members_wall_ms'] / 1e3:.1f}s over "
        f"{bench['max_workers']} workers"
    )

    # the serving-side twin of the members' model (params shapes must
    # match the checkpoints the fleet just wrote)
    cfg = get_preset("pendulum").replace(
        policy_hidden=(8,), policy_gru=8, n_envs=2,
        serve_batch_shapes=(1, 2),
    )
    agent = TRPOAgent("pendulum", cfg, device=args.device)
    template = agent.init_state(seed=0)
    serve_ck = os.path.join(args.tmp, "serve_ck")
    injector = FaultInjector.from_spec(
        "kill_promoter@step=1;regress_checkpoint@step=2;"
        "corrupt_checkpoint@step=3",
        bus=bus,
    )
    incumbent = {"step": None}

    # -- 2. kill_promoter: first promotion dies AFTER the publish --------
    # attempt #1 runs in "another process" (no serving tier up yet —
    # the publish needs none): a shim stands in for the canary surface
    # the pre-gate phases read. The kill fires between publish and gate.
    shim = types.SimpleNamespace(
        incumbent=incumbent, _rejected_steps=set()
    )
    ctrl = PromotionController(
        serve_ck, template, shim, bus=bus, injector=injector,
    )
    died = False
    try:
        ctrl.promote(winner, winner_ck)
    except PromoterKilled:
        died = True
    assert died, "kill_promoter@step=1 never fired"
    assert Checkpointer(serve_ck).latest_step() == 1, (
        "the killed promotion did not leave a durable serve step 1"
    )
    print(
        "kill_promoter: promotion controller died mid-promotion at "
        "serving step 1 (publish durable, gate never driven); "
        f"t={mark('killed'):.1f} s"
    )

    # -- the live observability plane, armed on the wreck ----------------
    # The aggregator watches the promotion journal the dead controller
    # left behind: its mtime stopped at the kill, so while the step-1
    # entry sits non-terminal the `promote.unconverged_s` series grows
    # and the promoter_stuck rule must FIRE — detection precedes the
    # restarted controller's recovery below, exactly the order an
    # operator would live. The canary's rollback counter joins as an
    # in-process target once the gate exists; the router's /status
    # joins once it serves.
    from trpo_torch.obs.aggregate import (
        CallbackTarget,
        HttpTarget,
        JournalTarget,
        MetricsAggregator,
    )
    from trpo_torch.obs.alerts import AlertEngine, default_rules

    alert_eng = AlertEngine(
        default_rules(window_s=2.0, promoter_stuck_s=6.0), bus=bus
    )
    agg = MetricsAggregator(
        [JournalTarget("promoter", serve_ck)],
        bus=bus, engine=alert_eng, interval=0.25,
    ).start()

    # -- serving tier: managed recurrent replicas + striding router ------
    def managed_factory(rid):
        def factory():
            engine = agent.serve_session_engine()
            server = PolicyServer(
                engine, None, port=0, bus=bus, replica_name=rid,
                checkpointer=Checkpointer(serve_ck),
                template=agent.init_state(),
                poll_interval=60.0,
                managed_reload=True,
                initial_step=incumbent["step"],
            )
            return server, []

        return factory

    rs = ReplicaSet(
        lambda rid: InProcessReplica(managed_factory(rid)), 2,
        health_interval=0.2, backoff=0.1, health_fail_threshold=2,
        bus=bus,
    )
    rs.start()
    assert rs.wait_healthy(2, timeout=120.0), rs.snapshot()
    router = Router(rs, port=0, bus=bus, canary_fraction=0.5)
    gate_ck = Checkpointer(serve_ck)
    canary = CanaryController(
        rs, router, gate_ck.latest_step,
        incumbent=incumbent, window_requests=6, poll_interval=0.1,
        gate_timeout_s=60.0, p99_budget_pct=500.0, bus=bus,
        reward_window_episodes=3, reward_min_episodes=3,
        reward_budget=0.5,
    )
    ctrl = PromotionController(
        serve_ck, template, canary, bus=bus, injector=injector,
        gate_timeout_s=120.0, poll_interval=0.1,
    )
    agg.add_target(HttpTarget("router", router.url))
    agg.add_target(
        CallbackTarget(
            "canary",
            lambda: {"rolled_back_total": canary.rolled_back_total},
        )
    )

    # -- 3. live flywheel traffic: sessions reporting reward/done --------
    stop = threading.Event()
    errors: list = []

    def traffic(seed: int) -> None:
        r = np.random.RandomState(seed)
        while not stop.is_set():
            try:
                s, o = _post(router.url + "/session")
                if s != 200:
                    errors.append(("session", s, o))
                    continue
                sid = o["session"]
                prev = None
                for t in range(4):
                    body = {"obs": r.randn(*agent.obs_shape).tolist()}
                    if prev is not None:
                        # the client-observed realized reward: the
                        # quadratic action cost (pendulum's own shape)
                        body["reward"] = -float(np.mean(prev ** 2))
                    if t == 3:
                        body["done"] = True
                    s, o = _post(router.url + f"/session/{sid}/act", body)
                    if s != 200:
                        errors.append(("act", s, o))
                        break
                    prev = np.asarray(o["action"], np.float64)
            except Exception as e:  # noqa: BLE001 — collected
                errors.append(repr(e))

    threads = [
        threading.Thread(target=traffic, args=(i,), daemon=True)
        for i in range(4)
    ]
    for t in threads:
        t.start()

    try:
        time.sleep(0.5)  # episodes are flowing

        # detection BEFORE recovery: the promoter_stuck alert must fire
        # off the wrecked journal while the restarted controller has
        # not yet touched it — an operator is paged about the stuck
        # promotion, not told after the fact
        deadline = time.time() + 60.0
        while (
            time.time() < deadline
            and not alert_eng.firing_total.get("promoter_stuck")
        ):
            time.sleep(0.2)
        assert alert_eng.firing_total.get("promoter_stuck", 0) >= 1, (
            "promoter_stuck never fired off the killed promotion's "
            f"journal: {alert_eng.firing_total}"
        )
        print(
            "alert: promoter_stuck FIRING off the dead controller's "
            "journal (mtime age > threshold, entry non-terminal)"
        )

        mark("stuck_fired")
        # -- 2b. the RESTARTED controller converges and promotes --------
        res = ctrl.promote(winner, winner_ck)
        assert res["outcome"] == "promoted", res
        assert res["serve_step"] == 1, res
        assert incumbent["step"] == 1
        print(
            f"restart: converged on the journal, {winner} promoted at "
            "serving step 1 through the reward-aware gate "
            "(session-only traffic — parity stood down); "
            f"t={mark('promoted'):.1f} s"
        )

        # -- 6a. the served-return feedback edge ------------------------
        deadline = time.time() + 30.0
        while router.episodes_total == 0 and time.time() < deadline:
            time.sleep(0.1)
        fb = ctrl.feedback(winner, res["serve_step"])
        assert fb["episodes"] > 0, fb
        assert "mean_return" in fb, fb

        # -- 4. regress_checkpoint: only the reward gate can see it -----
        res2 = ctrl.promote(f"{winner}-gen2", winner_ck)
        assert res2["serve_step"] == 2, res2
        assert res2["outcome"] == "rejected", res2
        assert incumbent["step"] == 1, incumbent
        print(
            "regress_checkpoint: saturated weights published as serving "
            "step 2, loaded cleanly, REJECTED by the realized-return "
            f"gate; incumbent kept serving step 1; t={mark('regressed'):.1f}"
            " s"
        )

        # -- 5. corrupt_checkpoint: torn after the marker ----------------
        res3 = ctrl.promote(f"{winner}-gen3", winner_ck)
        assert res3["serve_step"] == 3, res3
        assert res3["outcome"] == "rejected", res3
        assert incumbent["step"] == 1, incumbent
        print(
            "corrupt_checkpoint: serving step 3 torn after its marker "
            "landed, canary reload failed loudly, REJECTED; incumbent "
            f"kept serving step 1; t={mark('corrupted'):.1f} s"
        )

        # every replica still serves the incumbent, healthy. A replica's
        # state is its last health poll's (every 0.2 s): one taken during
        # the canary's failed reload reads "reloading" until the next, so
        # the check waits a bounded few polls for the current state
        assert rs.wait_healthy(2, timeout=5.0), rs.snapshot()
        snap = rs.snapshot()
        assert snap["healthy"] == 2, snap
        assert all(
            r["loaded_step"] == 1 for r in snap["replicas"].values()
        ), snap

        # the gate rollbacks must have PAGED: the canary_rejected rule
        # watches the controller's rolled_back counter
        assert alert_eng.firing_total.get("canary_rejected", 0) >= 1, (
            "canary_rejected never fired across two gate rollbacks: "
            f"{alert_eng.firing_total}"
        )

        stop.set()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive(), "traffic thread hung"
        assert not errors, (
            f"{len(errors)} client-visible errors across the flywheel: "
            f"{errors[:5]}"
        )
        assert injector.all_fired, injector.unfired

        # every firing alert must RESOLVE on the recovered system (the
        # journal converged, the rollback deltas drained, the recent
        # p99 window decayed) — the validator's lifecycle contract
        # gates this too
        deadline = time.time() + 45.0
        while time.time() < deadline and alert_eng.active():
            time.sleep(0.25)
        assert not alert_eng.active(), (
            f"alerts never resolved: {alert_eng.active()}"
        )
        assert alert_eng.resolved_total.get("promoter_stuck", 0) >= 1
        assert alert_eng.resolved_total.get("canary_rejected", 0) >= 1
        print(
            f"alerts: fired {alert_eng.firing_total}, all resolved, "
            "zero left active"
        )
    finally:
        # the watcher goes down FIRST — a serving tier torn down under
        # a still-polling aggregator would manufacture target_stale
        # noise in the log's final seconds
        agg.close()
        stop.set()
        canary.close()
        router.close()
        rs.close()
        bus.close()

    # -- 6b/7. the loop closes: read the feedback back from the log ------
    records = load_events(events_path)
    scores = feedback_scores(records)
    assert winner in scores, (winner, scores)
    mean, eps = scores[winner]
    rolled = [
        r for r in records
        if r.get("kind") == "canary" and r.get("event") == "rolled_back"
        and r.get("step") == 2
    ]
    assert rolled and any(
        "realized return" in (r.get("reason") or "") for r in rolled
    ), f"step 2 rollback never named the realized return: {rolled}"
    print(
        f"feedback: {eps} served episodes (mean return {mean:.3f}) "
        f"booked for {winner} and read back via feedback_scores — "
        "ready for the next fleet round"
    )
    # each gate's decision: its canary's start to its terminal record
    started, decisions = {}, {}
    for r in records:
        if r.get("kind") != "canary":
            continue
        if r.get("event") == "started":
            started[r["step"]] = r["t"]
        elif r.get("event") in ("promoted", "rolled_back") \
                and r["step"] in started:
            decisions[r["step"]] = {"event": r["event"],
                                    "s": r["t"] - started[r["step"]]}
    print(json.dumps({
        "timings_s": timings,
        "gate_decision_s": decisions,
        "episodes": eps,
        "client_errors": len(errors),
        "winner": winner,
        "fleet_wall_s": bench["fleet_wall_ms"] / 1e3,
    }))
    print(f"flywheel smoke OK — events at {events_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
