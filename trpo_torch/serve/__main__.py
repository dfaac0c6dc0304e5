"""Serve a trained policy over HTTP: ``python -m trpo_torch.serve``
(counterpart: ``scripts/serve.py``, its single-replica path).

    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --port 0
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --preset pendulum \\
        --port 8700 --deadline-ms 5
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck \\
        --preset cartpole-po                # recurrent: the session protocol
    python -m trpo_torch.serve --checkpoint-dir /tmp/ck --device cpu

Builds the policy the checkpoint was trained with (``--preset`` and the
model overrides ``trpo_torch.train`` takes), and serves it from one
replica on the card (``--device cuda``, the default; ``--device cpu`` is
the only way onto the CPU):

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

The control plane's flags (``--replicas`` > 1, ``--min/--max-replicas``,
``--slo-p99-ms``, ``--hosts``, ``--lease-ttl``, ``--replica-cmd``,
``--router-core``, canary) raise ``NotImplementedError`` naming
ROADMAP.md Queue 1 item 17; the telemetry and fault flags
(``--metrics-jsonl``, ``--trace-sample-rate``, ``--capture``,
``--inject-faults``) name item 18.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from typing import Optional, Sequence

__all__ = ["build_parser", "main"]


def _ints(text: str) -> tuple:
    return tuple(int(s) for s in text.split(",") if s.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.serve",
        description="serve a trained TRPO policy over HTTP (one replica)",
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
                   help="journal session carries here (recurrent)")
    p.add_argument("--replica-name",
                   help="this replica's name in its journal file (default "
                        "'solo')")
    p.add_argument("--run-descriptor",
                   help="write run.json (pid, port, url) here, atomically")
    p.add_argument("--serve-seconds", type=float,
                   help="exit after this many seconds (default: at "
                        "SIGTERM/SIGINT)")
    # the control plane (item 17) and telemetry/faults (item 18): parsed so
    # that they refuse by name instead of as unknown flags
    for flag, kind in (("--replicas", int), ("--min-replicas", int),
                       ("--max-replicas", int), ("--slo-p99-ms", float),
                       ("--hosts", str), ("--lease-ttl", float),
                       ("--replica-cmd", str), ("--router-core", str),
                       ("--canary-fraction", float),
                       ("--metrics-jsonl", str),
                       ("--trace-sample-rate", float),
                       ("--inject-faults", str)):
        p.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    p.add_argument("--capture", action="store_true", help=argparse.SUPPRESS)
    return p


def _refuse_unported(args) -> None:
    control = [f for f, v in (
        ("--replicas", args.replicas is not None and args.replicas > 1),
        ("--min-replicas", args.min_replicas is not None),
        ("--max-replicas", args.max_replicas is not None),
        ("--slo-p99-ms", args.slo_p99_ms is not None),
        ("--hosts", args.hosts is not None),
        ("--lease-ttl", args.lease_ttl is not None),
        ("--replica-cmd", args.replica_cmd is not None),
        ("--router-core", args.router_core is not None),
        ("--canary-fraction", args.canary_fraction is not None
         and args.canary_fraction > 0)) if v]
    if control:
        raise NotImplementedError(
            f"{', '.join(control)}: the serving control plane is not "
            "ported to trpo_torch yet (ROADMAP.md Queue 1 item 17 (the "
            "control plane)); serve one replica, or use scripts/serve.py")
    telemetry = [f for f, v in (
        ("--metrics-jsonl", args.metrics_jsonl is not None),
        ("--trace-sample-rate", args.trace_sample_rate is not None),
        ("--capture", args.capture),
        ("--inject-faults", args.inject_faults is not None)) if v]
    if telemetry:
        raise NotImplementedError(
            f"{', '.join(telemetry)}: telemetry and fault injection are "
            "not ported to trpo_torch yet (ROADMAP.md Queue 1 item 18)")


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
    }.items() if v is not None}
    return cfg.replace(**updates) if updates else cfg


def _write_descriptor(path: str, payload: dict) -> None:
    """Write-then-rename, so a reader never sees a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.serve import MicroBatcher, PolicyServer
    from trpo_torch.utils.checkpoint import Checkpointer

    cfg = config_from_args(args)
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    recurrent = agent.is_recurrent
    batcher = None
    if recurrent:
        engine = agent.serve_session_engine()
    else:
        engine = agent.serve_engine()
        batcher = MicroBatcher(engine, deadline_ms=cfg.serve_deadline_ms,
                               adaptive_deadline=cfg.serve_adaptive_deadline)
    server = PolicyServer(
        engine, batcher, args.port, host=args.host,
        checkpointer=Checkpointer(args.checkpoint_dir),
        template=agent.init_state(),
        poll_interval=cfg.serve_poll_interval,
        session_ttl_s=cfg.serve_session_ttl,
        max_sessions=cfg.serve_max_sessions,
        replica_name=args.replica_name,
        carry_journal_dir=args.carry_journal_dir,
        carry_sync_every=cfg.serve_carry_sync_every,
        session_deadline_ms=cfg.serve_session_deadline_ms,
        session_adaptive_deadline=cfg.serve_adaptive_deadline,
        uds_path=args.uds_path,
    )
    done = threading.Event()
    try:
        if args.run_descriptor:
            _write_descriptor(args.run_descriptor, {
                "schema": "trpo-torch-serve-descriptor",
                "pid": os.getpid(),
                "port": server.port,
                "url": server.url,
                "uds_path": server.uds_path,
                "endpoints": list(server.ENDPOINTS),
                "recurrent": recurrent,
                "device": str(agent.device),
                "checkpoint_dir": os.path.abspath(args.checkpoint_dir),
            })
        proto = "/session" if recurrent else "/act"
        print(f"serving {cfg.env} policy at {server.url} (POST {proto}, "
              f"GET /healthz, GET /metrics) on {agent.device}; step "
              f"{engine.loaded_step}", flush=True)
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGTERM, signal.SIGINT):
                signal.signal(sig, lambda *_: done.set())
        done.wait(args.serve_seconds)
    finally:
        server.close()
        if batcher is not None:
            batcher.close()
    served = (server.session_acts_total if recurrent
              else batcher.requests_total)
    print(f"served {served} requests", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
