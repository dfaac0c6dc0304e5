"""Serve a trained policy over HTTP: ``python -m trpo_torch.serve``
(counterpart: ``scripts/serve.py``).

    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --port 0
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --preset pendulum \\
        --port 8700 --deadline-ms 5
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck \\
        --preset cartpole-po                # recurrent: the session protocol
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --replicas 4
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --device cpu

Builds the policy the checkpoint was trained with (``--preset`` and the
model overrides ``trpo_torch.train`` takes), and serves it on the card
(``--device cuda``, the default; ``--device cpu`` is the only way onto
the CPU):

* ``POST /act`` — ``{"obs": [...]}`` → ``{"action": ..., "step": N}``
  (feedforward; a typed 409 naming ``/session`` on a recurrent policy)
* ``POST /session`` + ``POST /session/<id>/act`` — the recurrent session
  protocol
* ``GET /healthz``, ``GET /metrics``, ``POST /reload``, ``POST /drain``

A watcher polls the checkpoint directory every ``--poll-interval``
seconds and hot-swaps to a newer complete step. With no checkpoint yet,
the server answers 503 until the first complete save lands. The bound
port is printed (``--port 0`` lets the OS pick), and ``--run-descriptor``
writes it with the pid and URL to an atomically replaced ``run.json``.
SIGTERM or SIGINT closes the server and exits 0.

``--replicas N`` (N > 1) puts one :class:`~trpo_torch.serve.Router` on
``--port`` in front of N supervised replicas on ephemeral ports
(``GET /status`` too): in this process by default, or ``--replica-cmd``
children (``--hosts`` places them on named hosts, with leases).
``--canary-fraction`` gates each new checkpoint through a
:class:`~trpo_torch.serve.CanaryController`, and ``--max-replicas`` arms
the :class:`~trpo_torch.serve.Autoscaler`. At exit the router prints
``routed N requests (…)``. An inconsistent combination of these flags
exits 2 with the reference's message.

``--metrics-jsonl PATH`` appends the run-event stream (a manifest, then
every component's events: ``serve`` per micro-batch, replica lifecycle,
requests, sessions, canary and autoscaler decisions) in the reference's
schema; ``--trace-sample-rate R`` (which needs it) traces that share of
requests as ``span`` records, one ``Tracer`` per process role (the
router, each in-process replica); a ``--replica-cmd`` child arms its own
through its template. At rate 0 no request is head-sampled, but every
anomaly (a retried or failed request, a session failover) is still
traced; without the flag there is no tracer.

``--inject-faults SPEC`` arms one ``resilience.FaultInjector`` (the
serving grammar: ``kill_replica``, ``stall_replica``, ``wedge_reload``,
``drop_carry_journal``, ``overload_storm``, ``slow_replica``,
``flap_replica`` and the host faults), on the event bus when there is one,
handed to the router (the request clock) and to every in-process replica
(the reload seam); a spec that never fired is named on stderr at exit.
The router keeps the reference's fixed act timeout (30 s) and retry
bucket (8 tokens, 4/s): a ``stall_replica`` shorter than the timeout is
only latency, and a replica lost with more requests in flight than the
bucket holds sheds the retries past it as 502s.
``--capture`` (which needs ``--trace-sample-rate`` > 0 and
``--metrics-jsonl``) records every emitted request's replayable inputs
as ``capture`` records, one ``obs.capture.RequestCapture`` per process
role like the tracers; export a window with ``python -m
trpo_torch.scripts.analyze_run LOG --export-bundle`` and re-execute it
with ``python -m trpo_torch.scripts.replay_run``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Optional, Sequence

__all__ = ["build_parser", "main"]


def _ints(text: str) -> tuple:
    return tuple(int(s) for s in text.split(",") if s.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.serve",
        description="serve a trained TRPO policy over HTTP",
    )
    p.add_argument("--checkpoint-dir", required=True,
                   help="checkpoint directory to serve from (and watch)")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port (default 0 = OS-assigned, printed)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--uds-path",
                   help="also listen on this Unix domain socket")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs eagerly)")
    p.add_argument("--preset", default="cartpole",
                   help="the config the checkpoint was trained with")
    p.add_argument("--env", help="override the env name (its spaces shape "
                                 "the policy)")
    p.add_argument("--policy-hidden", type=_ints,
                   help="comma-separated torso sizes (match training)")
    p.add_argument("--policy-activation")
    p.add_argument("--policy-experts", type=int)
    p.add_argument("--policy-gru", type=int,
                   help="recurrent-cell size: serves the session protocol")
    p.add_argument("--policy-cell", choices=("gru", "lstm"))
    p.add_argument("--vf-hidden", type=_ints,
                   help="critic sizes (the restore template holds it)")
    p.add_argument("--n-envs", type=int,
                   help="the training run's n_envs (shapes its env carry)")
    p.add_argument("--normalize-obs", action="store_true",
                   help="the run normalized observations: serve raw ones "
                        "through its statistics")
    p.add_argument("--batch-shapes", type=_ints,
                   help="the engine's rung ladder (default 1,8,64)")
    p.add_argument("--deadline-ms", type=float,
                   help="micro-batcher budget (default 10)")
    p.add_argument("--no-adaptive-deadline", action="store_true",
                   help="hold requests for the whole half-deadline")
    p.add_argument("--poll-interval", type=float,
                   help="seconds between checkpoint polls (default 1)")
    p.add_argument("--session-batch-shapes", type=_ints,
                   help="the session engine's rung ladder (default 1,8,64)")
    p.add_argument("--session-deadline-ms", type=float,
                   help="session epoch budget (default 3)")
    p.add_argument("--session-ttl", type=float)
    p.add_argument("--max-sessions", type=int)
    p.add_argument("--carry-sync-every", type=int)
    p.add_argument("--carry-journal-dir",
                   help="journal session carries here (recurrent; default "
                        "<checkpoint-dir>/carry_journal with --replicas > "
                        "1, 'none' turns it off)")
    p.add_argument("--replica-name",
                   help="this replica's name in its journal file (default "
                        "'solo')")
    p.add_argument("--run-descriptor",
                   help="write run.json (pid, port, url) here, atomically")
    p.add_argument("--serve-seconds", type=float,
                   help="exit after this many seconds (default: at "
                        "SIGTERM/SIGINT)")
    # the replicated control plane
    p.add_argument("--replicas", type=int,
                   help="N replicas behind one router on --port (default 1 "
                        "= one bare replica)")
    p.add_argument("--router-core", choices=("async", "thread"),
                   default="async",
                   help="the router's front end: one event loop (async, "
                        "default) or a thread per request")
    p.add_argument("--min-replicas", type=int,
                   help="autoscaler floor (default 1)")
    p.add_argument("--max-replicas", type=int,
                   help="autoscaler ceiling: setting it arms the autoscaler")
    p.add_argument("--slo-p99-ms", type=float,
                   help="the p99 the autoscaler defends (default 250)")
    p.add_argument("--drain-timeout", type=float,
                   help="seconds before a stalled drain aborts (default 30)")
    p.add_argument("--replica-cmd",
                   help="launch replicas as children from this template "
                        "({port}, {checkpoint}, {replica}, {host})")
    p.add_argument("--hosts",
                   help="comma-separated host names for --replica-cmd's "
                        "{host}: round-robin placement and lease liveness")
    p.add_argument("--lease-ttl", type=float,
                   help="replica lease seconds (default 3; armed with "
                        "--hosts, or by setting it)")
    p.add_argument("--health-interval", type=float,
                   help="replica /healthz poll seconds (default 0.5)")
    p.add_argument("--replica-restarts", type=int,
                   help="per-replica crash budget (default 3)")
    p.add_argument("--max-inflight", type=int,
                   help="per-replica outstanding-request bound (default 64)")
    p.add_argument("--canary-fraction", type=float,
                   help="gate each new step through a canary replica "
                        "taking this fraction of traffic (default 0 = off)")
    p.add_argument("--canary-window", type=int,
                   help="canary requests before the gate judges (24)")
    p.add_argument("--canary-parity-tol", type=float,
                   help="max mean |canary - incumbent| action on mirrored "
                        "requests (default: finite actions only)")
    p.add_argument("--reward-window", type=int,
                   help="arm the reward gate: canary episodes to judge")
    p.add_argument("--reward-min-episodes", type=int,
                   help="incumbent episodes the reward gate needs")
    p.add_argument("--reward-budget", type=float,
                   help="mean-return drop the reward gate tolerates")
    p.add_argument("--metrics-jsonl",
                   help="append the run-event stream here (the reference's "
                        "schema)")
    p.add_argument("--trace-sample-rate", type=float,
                   help="head-sampling rate of request traces (span "
                        "records on --metrics-jsonl; anomalies are always "
                        "traced)")
    p.add_argument("--inject-faults",
                   help="serving chaos spec (resilience/inject.py grammar): "
                        "kill_replica@request=K:replica=R, stall_replica@"
                        "request=K:replica=R:seconds=S, wedge_reload@step=N,"
                        " drop_carry_journal@request=K:replica=R, ...")
    p.add_argument("--capture", action="store_true",
                   help="record every SAMPLED request's replayable inputs "
                        "(wire-encoded obs, session, seq, checkpoint step, "
                        "answered action) as capture events; needs "
                        "--trace-sample-rate > 0 and --metrics-jsonl. Export "
                        "with analyze_run --export-bundle, re-execute with "
                        "replay_run")
    return p


def config_from_args(args):
    """The training config the checkpoint was written with, from
    ``--preset`` and the overrides."""
    from trpo_torch.config import get_preset

    cfg = get_preset(args.preset)
    updates = {k: v for k, v in {
        "env": args.env,
        "policy_hidden": args.policy_hidden,
        "policy_activation": args.policy_activation,
        "policy_experts": args.policy_experts,
        "policy_gru": args.policy_gru,
        "policy_cell": args.policy_cell,
        "vf_hidden": args.vf_hidden,
        "n_envs": args.n_envs,
        "normalize_obs": True if args.normalize_obs else None,
        "serve_batch_shapes": args.batch_shapes,
        "serve_deadline_ms": args.deadline_ms,
        "serve_adaptive_deadline":
            False if args.no_adaptive_deadline else None,
        "serve_poll_interval": args.poll_interval,
        "serve_session_batch_shapes": args.session_batch_shapes,
        "serve_session_deadline_ms": args.session_deadline_ms,
        "serve_session_ttl": args.session_ttl,
        "serve_max_sessions": args.max_sessions,
        "serve_carry_sync_every": args.carry_sync_every,
        "serve_replicas": args.replicas,
        "serve_min_replicas": args.min_replicas,
        "serve_max_replicas": args.max_replicas,
        "serve_slo_p99_ms": args.slo_p99_ms,
        "serve_drain_timeout": args.drain_timeout,
        "serve_replica_cmd": args.replica_cmd,
        "serve_hosts": tuple(h.strip() for h in args.hosts.split(",")
                             if h.strip()) if args.hosts else None,
        "serve_lease_ttl": args.lease_ttl,
        "serve_health_interval": args.health_interval,
        "serve_replica_restarts": args.replica_restarts,
        "serve_max_inflight": args.max_inflight,
        "serve_canary_fraction": args.canary_fraction,
        "serve_canary_window": args.canary_window,
        "serve_reward_window": args.reward_window,
        "serve_reward_min_episodes": args.reward_min_episodes,
        "serve_reward_budget": args.reward_budget,
        "trace_sample_rate": args.trace_sample_rate,
    }.items() if v is not None}
    return cfg.replace(**updates) if updates else cfg


def _write_descriptor(path: str, payload: dict) -> None:
    """Write-then-rename, so a reader never sees a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def _arming_error(args, cfg, recurrent: bool) -> Optional[str]:
    """The reference's refusals of inconsistent control-plane flags
    (``scripts/serve.py``), or None."""
    if args.min_replicas is not None and cfg.serve_max_replicas is None:
        return ("--min-replicas only bounds the elastic autoscaler — pass "
                "--max-replicas to arm it (a floor without a ceiling would "
                "silently do nothing).")
    if cfg.serve_hosts and not cfg.serve_replica_cmd:
        return ("--hosts places replicas through the --replica-cmd launch "
                "template — pass --replica-cmd with a {host} target or "
                "drop --hosts.")
    if cfg.serve_replica_cmd and cfg.serve_replicas < 2:
        return ("--replica-cmd launches replicas under the replicated "
                "control plane — run with --replicas >= 2.")
    if cfg.serve_replica_cmd and recurrent and not all(
            part in cfg.serve_replica_cmd
            for part in ("--carry-journal-dir", "--replica-name",
                         "{replica}")):
        return ("a RECURRENT --replica-cmd template must wire the carry "
                "journal the parent router resumes/drains from — include: "
                "--carry-journal-dir {checkpoint}/carry_journal "
                "--replica-name {replica}.")
    if cfg.trace_sample_rate > 0 and not args.metrics_jsonl:
        return ("--trace-sample-rate emits spans on the event bus — pass "
                "--metrics-jsonl so they land somewhere.")
    if args.capture and (cfg.trace_sample_rate <= 0
                         or not args.metrics_jsonl):
        return ("--capture records SAMPLED requests — pass "
                "--trace-sample-rate > 0 and --metrics-jsonl.")
    if cfg.serve_max_replicas is not None and cfg.serve_replicas < 2:
        return ("--max-replicas (the elastic autoscaler) needs the "
                "replicated control plane — run with --replicas >= 2.")
    canary = cfg.serve_canary_fraction > 0 and cfg.serve_replicas > 1
    if canary and cfg.serve_replica_cmd:
        return ("--canary-fraction needs in-process replicas (the canary "
                "controller pins relaunches to the incumbent step through "
                "a shared cell) — drop --replica-cmd or the canary gate.")
    if canary and recurrent and cfg.serve_reward_window < 1:
        return ("--canary-fraction on a recurrent policy needs the "
                "reward-aware gate — pass --reward-window N (and have "
                "clients report reward/done in /session/act bodies), or "
                "drop --canary-fraction.")
    return None


def _wait_for_stop(seconds: Optional[float]) -> None:
    """Return after ``seconds`` (None: never), or at SIGTERM/SIGINT when
    called on the main thread. The handler only sets a flag, and this
    thread sleeps in short slices: the kernel may deliver the signal to
    any of the server's threads, and CPython runs the handler on the main
    thread at its next bytecode, which a lock wait without a timeout never
    reaches (the serve CLI then outlived SIGTERM); an ``Event.set`` inside
    the handler could also run while this thread holds that event's lock."""
    stop: list = []
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.append(True))
    end = None if seconds is None else time.monotonic() + seconds
    while not stop:
        left = 0.1 if end is None else min(0.1, end - time.monotonic())
        if left <= 0:
            return
        time.sleep(left)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.serve import (
        Autoscaler,
        CanaryController,
        InProcessReplica,
        MicroBatcher,
        PolicyServer,
        ReplicaSet,
        Router,
        SubprocessReplica,
        TemplateTransport,
        render_launch_argv,
    )
    from trpo_torch.utils.checkpoint import Checkpointer

    cfg = config_from_args(args)
    injector = None
    if args.inject_faults:
        from trpo_torch.resilience.inject import FaultInjector

        injector = FaultInjector.from_spec(args.inject_faults)
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    recurrent = agent.is_recurrent
    error = _arming_error(args, cfg, recurrent)
    if error is not None:
        print(f"error: {error}", file=sys.stderr)
        return 2
    replicated = cfg.serve_replicas > 1
    canary = cfg.serve_canary_fraction > 0 and replicated
    ck_dir = os.path.abspath(args.checkpoint_dir)
    # replicated recurrent serving journals by default, so a replica's
    # death resumes its sessions; 'none' opts out
    journal_dir = None
    if recurrent and args.carry_journal_dir != "none":
        journal_dir = args.carry_journal_dir or (
            os.path.join(ck_dir, "carry_journal") if replicated else None)
    # the canary controller promotes into this cell; a replica launched
    # mid-gate reads it, so it never comes up on the step under test
    incumbent = {"step": None}
    bus = None
    if args.metrics_jsonl:
        from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields

        bus = EventBus(JsonlSink(args.metrics_jsonl))
        bus.emit("run_manifest", **manifest_fields(cfg, extra={
            "driver": "serve", "checkpoint_dir": ck_dir,
            "replicas": cfg.serve_replicas, "recurrent": recurrent,
            "canary_fraction": cfg.serve_canary_fraction,
            "carry_journal": journal_dir}, device=agent.device))
    if injector is not None:
        injector.bus = bus
    # one Tracer per process role, cached by name so a relaunched replica
    # reuses its own instead of leaking a writer thread per restart
    tracers: dict = {}

    def make_tracer(name: str):
        # armed whenever a rate is given: at 0 no request is head-sampled,
        # but an anomaly (a retry, a failure, a failover) is still traced
        if bus is None or args.trace_sample_rate is None:
            return None
        if name not in tracers:
            from trpo_torch.obs.trace import Tracer

            # a host-namespaced replica name ("hostA--r0") names its host
            host = name.split("--", 1)[0] if "--" in name else None
            tracers[name] = Tracer(bus, cfg.trace_sample_rate, process=name,
                                   host=host)
        return tracers[name]

    # request capture: cached per role like the tracers; it records iff
    # the trace is emitting, so the two agree on which requests it keeps
    captures: dict = {}

    def make_capture(name: str):
        if not args.capture or bus is None:
            return None
        if name not in captures:
            from trpo_torch.obs.capture import RequestCapture

            host = name.split("--", 1)[0] if "--" in name else None
            captures[name] = RequestCapture(bus, process=name, host=host)
        return captures[name]

    def build_replica(replica_name, port, uds_path=None):
        """One serving stack: its engine, batcher, checkpoint watcher and
        port. Under a canary it runs MANAGED reload pinned to the
        incumbent step."""
        batcher = None
        if recurrent:
            engine = agent.serve_session_engine()
        else:
            engine = agent.serve_engine()
            batcher = MicroBatcher(
                engine, deadline_ms=cfg.serve_deadline_ms,
                adaptive_deadline=cfg.serve_adaptive_deadline, bus=bus)
        server = PolicyServer(
            engine, batcher, port, host=args.host,
            checkpointer=Checkpointer(args.checkpoint_dir),
            template=agent.init_state(),
            poll_interval=cfg.serve_poll_interval,
            session_ttl_s=cfg.serve_session_ttl,
            max_sessions=cfg.serve_max_sessions,
            replica_name=replica_name,
            carry_journal_dir=journal_dir,
            carry_sync_every=cfg.serve_carry_sync_every,
            managed_reload=canary,
            initial_step=incumbent["step"],
            injector=injector,
            session_deadline_ms=cfg.serve_session_deadline_ms,
            session_adaptive_deadline=cfg.serve_adaptive_deadline,
            uds_path=uds_path,
            bus=bus,
            tracer=make_tracer(replica_name or "solo"),
            capture=make_capture(replica_name or "solo"),
        )
        return server, [batcher] if batcher is not None else []

    replicaset = router = controller = autoscaler = None
    server = None
    closers: list = []
    try:
        if replicated:
            transport = launcher = None
            replica_root = os.path.join(ck_dir, "replicas")
            if cfg.serve_hosts:
                transport = TemplateTransport(
                    cfg.serve_replica_cmd, cfg.serve_hosts,
                    checkpoint=ck_dir, replica_root=replica_root)
            elif cfg.serve_replica_cmd:
                def launcher(rid):
                    return SubprocessReplica(
                        [], os.path.join(replica_root, rid),
                        command=render_launch_argv(
                            cfg.serve_replica_cmd, port=0,
                            checkpoint=ck_dir, replica=rid))
            else:
                def launcher(rid):
                    # each in-process replica owns PATH.<rid> next to the
                    # front end's socket; the router dials it
                    return InProcessReplica(lambda: build_replica(
                        rid, 0, uds_path=(f"{args.uds_path}.{rid}"
                                          if args.uds_path else None)))
            # leases: always across hosts (a failed poll proves nothing
            # through a partition); locally only with --lease-ttl
            lease_ttl = (cfg.serve_lease_ttl
                         if cfg.serve_hosts or args.lease_ttl is not None
                         else None)
            replicaset = ReplicaSet(
                launcher, cfg.serve_replicas,
                health_interval=cfg.serve_health_interval,
                max_restarts=cfg.serve_replica_restarts,
                transport=transport, lease_ttl=lease_ttl, bus=bus)
            replicaset.start()
            router = Router(
                replicaset, args.port, host=args.host,
                max_inflight=cfg.serve_max_inflight,
                injector=injector,
                session_ttl_s=cfg.serve_session_ttl,
                max_sessions=cfg.serve_max_sessions,
                journal_dir=journal_dir,
                canary_fraction=cfg.serve_canary_fraction,
                min_latency_samples=cfg.serve_autoscale_min_samples,
                uds_path=args.uds_path, core=args.router_core, bus=bus,
                tracer=make_tracer("router"),
                capture=make_capture("router"))
            if canary:
                controller = CanaryController(
                    replicaset, router,
                    Checkpointer(args.checkpoint_dir).latest_step,
                    incumbent=incumbent,
                    window_requests=cfg.serve_canary_window,
                    parity_tol=args.canary_parity_tol,
                    poll_interval=cfg.serve_poll_interval,
                    reward_window_episodes=cfg.serve_reward_window,
                    reward_min_episodes=(
                        cfg.serve_reward_min_episodes or None),
                    reward_budget=cfg.serve_reward_budget, bus=bus)
                controller.start()
            if cfg.serve_max_replicas is not None:
                autoscaler = Autoscaler(
                    replicaset, router,
                    min_replicas=cfg.serve_min_replicas,
                    max_replicas=cfg.serve_max_replicas,
                    slo_p99_ms=cfg.serve_slo_p99_ms,
                    interval=cfg.serve_autoscale_interval,
                    min_samples=cfg.serve_autoscale_min_samples,
                    drain_timeout_s=cfg.serve_drain_timeout, bus=bus)
                autoscaler.start()
            front, endpoints = router, list(Router.ENDPOINTS)
        else:
            server, closers = build_replica(args.replica_name, args.port,
                                            uds_path=args.uds_path)
            front, endpoints = server, list(server.ENDPOINTS)
        if args.run_descriptor:
            _write_descriptor(args.run_descriptor, {
                "schema": "trpo-torch-serve-descriptor",
                "pid": os.getpid(),
                "port": front.port,
                "url": front.url,
                "uds_path": front.uds_path,
                "endpoints": endpoints,
                "replicas": cfg.serve_replicas,
                "recurrent": recurrent,
                "device": str(agent.device),
                "checkpoint_dir": ck_dir,
                "events_jsonl": os.path.abspath(args.metrics_jsonl)
                if args.metrics_jsonl else None,
            })
        proto = "/session" if recurrent else "/act"
        step = ("" if replicated
                else f"; step {server.engine.loaded_step}")
        print(f"serving {cfg.env} policy at {front.url} (POST {proto}, "
              "GET /healthz, GET /metrics"
              + (", GET /status" if replicated else "")
              + f") on {agent.device}, {cfg.serve_replicas} replica(s)"
              + step, flush=True)
        _wait_for_stop(args.serve_seconds)
    finally:
        # teardown in the reverse order of the build
        for part in (autoscaler, controller, router, replicaset, server):
            if part is not None:
                part.close()
        for c in closers:
            c.close()
        for t in tracers.values():
            t.close()  # flush pending spans before the bus closes
        for c in captures.values():
            c.close()  # and pending captures
        if injector is not None and injector.unfired:
            # a chaos run whose faults never fired tested nothing
            print("WARNING: injected faults never fired: "
                  + "; ".join(injector.unfired), file=sys.stderr, flush=True)
        if bus is not None:
            bus.close()
    if router is not None:
        print(f"routed {router.routed_total} requests "
              f"({router.retried_total} retried, {router.failed_total} "
              f"failed, {router.backpressure_total} backpressured)",
              flush=True)
    else:
        served = (server.session_acts_total if recurrent
                  else server.batcher.requests_total)
        print(f"served {served} requests", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
