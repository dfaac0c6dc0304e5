"""Command-line training entry point (counterpart: ``trpo_tpu/train.py``).

    python -m trpo_torch.train --preset humanoid-sim --iterations 10 \
        --log-jsonl run.jsonl --checkpoint-dir ck --checkpoint-every 2 \
        [--resume] [--normalize-obs] [--fuse-iterations k] \
        [--recover-on-nan restore] [--reward-target R] --evaluate STEPS
    python -m trpo_torch.train --preset pong-sim      # 84x84x4 conv policy
    python -m trpo_torch.train --preset cartpole-po --policy-cell lstm
    python -m trpo_torch.train --preset cartpole --policy-experts 4
    python -m trpo_torch.train --preset pendulum --env native:pendulum \
        [--host-pipeline-groups 2] [--host-async-pipeline] \
        [--host-inference cpu]
    python -m trpo_torch.train --preset halfcheetah --device cpu  # gymnasium
    python -m trpo_torch.train --preset humanoid-sim-fleet --overlap
    python -m trpo_torch.train --preset cartpole --env gymproc:CartPole-v1 \
        --device cpu --inject-faults "kill_worker@step=3:worker=0"
    python -m trpo_torch.train --preset humanoid-sim --recover-on-nan \
        restore --inject-faults "nan_update@iter=2;sigterm@iter=4"
    torchrun --nproc_per_node 2 -m trpo_torch.train --preset cartpole \
        --mesh-shape 2 [--mesh-axes data] [--device cpu]
    torchrun --nproc_per_node 4 -m trpo_torch.train --preset cartpole-fleet \
        --mesh-shape 2,2 --mesh-axes data,seq
    python -m trpo_torch.train --preset humanoid-sim --metrics-jsonl ev.jsonl \
        --health-checks --status-port 0 --memory-accounting \
        --run-descriptor run.json --profile-dir prof --profile-iteration 3

Runs ``TRPOAgent.learn`` on CUDA unless ``--device cpu`` is given. Each
iteration prints the stats block and a one-line summary (one per chunk
with ``--fuse-iterations``); ``--log-jsonl`` appends one JSON row per
iteration. ``--resume`` continues from the newest complete checkpoint in
``--checkpoint-dir``. On SIGTERM/SIGINT the run writes a final checkpoint
and exits with the requeue code (75). ``--evaluate STEPS`` runs a greedy
rollout of STEPS per env after training. A host env's (``native:``,
``gym:``, ``gymproc:``) simulator state is checkpointed beside each step
and restored with ``--resume``. ``--overlap`` runs the overlapped actor/learner loop
(device envs with a rollout chunk: rollout k+1 runs while update k does,
one window stale, importance-weighted).

Resilience: ``--env gymproc:<Id>`` steps gymnasium envs over worker
processes, supervised (``--env-step-timeout``, ``--max-worker-restarts``);
``--inject-faults SPEC`` fires the ``resilience.inject`` grammar's faults
at their steps or iterations (with ``--recover-on-nan restore`` a poisoned
update is rewound; ``sigterm@iter=N`` ends the run with exit 75).

Telemetry (``obs/``): ``--metrics-jsonl`` appends the typed run events
(manifest, iteration, phase, health, recompile, memory; the reference's
schema), ``--health-checks`` prints health findings, ``--status-port``
serves ``/status`` and ``/metrics`` while the run is in flight (0: the OS
picks; the URL is printed), ``--memory-accounting`` adds allocator gauges
and the leak rule, ``--run-descriptor`` writes the run's pid, status URL
and paths to a ``run.json``, and ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of the whole run, or with
``--profile-iteration N`` of iteration N's chunk only.

``--mesh-shape``/``--mesh-axes`` run data parallelism (``"data"``) and
sequence parallelism (``"seq"``) over one process per rank: launch under
``torchrun`` (a mesh of one rank needs no launcher; more ranks without one
exit 2 naming ``torchrun``). Rank 0 alone prints rows, writes the JSONL,
the checkpoints and the telemetry; a SIGTERM to any rank stops every rank
at the same iteration with the requeue code.

The reference's other flags parse and refuse naming the ROADMAP.md item
that ports them (:data:`REFUSED`, empty now); ``--platform`` is a stated
difference
(:data:`STATED_DIFFERENCES`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional, Sequence

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import PRESETS, get_preset
from trpo_torch.parallel.mesh import UnlaunchedMeshError
from trpo_torch.resilience import Preempted
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger

__all__ = ["main", "parse_args", "REFUSED", "STATED_DIFFERENCES"]

_PRINTED = (
    "total_episodes", "mean_episode_reward", "entropy", "kl_old_new",
    "surrogate_loss", "vf_explained_variance", "cg_iterations",
    "linesearch_success", "kl_rolled_back",
)
_LADDER_PRINTED = ("solve_cosine", "solve_fallback", "solve_pinned",
                   "cg_budget")

# the reference's flags for layers the port does not have yet: parsed, so
# that they refuse naming their ROADMAP.md item instead of as unknown flags
REFUSED: dict = {}

# the reference's flags the port replaces, with what replaces them
STATED_DIFFERENCES = {
    "--platform": "the JAX platform switch; the port takes --device "
                  "cuda|cpu (cuda by default, no fallback to the CPU)",
}


def _hidden(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="humanoid-sim", choices=sorted(PRESETS))
    p.add_argument("--env", help="override the preset's env, e.g. "
                   "native:pendulum or gym:HalfCheetah-v4")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int)
    p.add_argument("--n-envs", type=int)
    p.add_argument("--batch-timesteps", type=int)
    p.add_argument("--fleet-n-envs", type=int,
                   help="wide env fleet (overrides --n-envs) at the same "
                   "total batch")
    p.add_argument("--rollout-chunk", type=int,
                   help="time-chunked rollout: steps per chunk, a divisor "
                   "of ceil(batch-timesteps / n-envs)")
    p.add_argument("--policy-hidden", type=_hidden,
                   help="comma-separated widths, e.g. 256,256")
    p.add_argument("--policy-gru", type=_positive_int,
                   help="recurrent policy: the cell's hidden size (the "
                   "cartpole-po preset sets 64)")
    p.add_argument("--policy-cell", choices=("gru", "lstm"),
                   help="recurrence type when --policy-gru is set")
    p.add_argument("--policy-experts", type=int,
                   help="soft mixture-of-experts torso with K experts "
                   "(not with --policy-gru)")
    p.add_argument("--max-kl", type=float)
    p.add_argument("--cg-iters", type=int)
    p.add_argument("--cg-damping", type=float)
    p.add_argument("--gamma", type=float)
    p.add_argument("--lam", type=float)
    p.add_argument("--precond-refresh-every", type=_positive_int,
                   help="head_block: recompute the Gram factors every k "
                   "updates")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   help="the policy's matmul dtype (the CG solve stays f32)")
    p.add_argument("--cg-precondition",
                   choices=["off", "jacobi", "head_block"])
    p.add_argument("--cg-precond-probes", type=_positive_int,
                   help="jacobi: Hutchinson probes per update")
    p.add_argument("--cg-residual-rtol", type=float,
                   help="relative CG exit ‖r‖ <= rtol·‖g‖: makes --cg-iters "
                   "a cap instead of a fixed count (0 = off)")
    p.add_argument("--linesearch-kl-cap", action="store_true",
                   help="KL-aware line search: candidates must also satisfy "
                   "the rollback KL cap")
    p.add_argument("--fvp-mode", choices=["auto", "fused", "ggn",
                                          "jvp_grad"],
                   help="the CG operator: the fused kernel (auto/fused), "
                   "the Gauss-Newton operator, or jvp of the KL gradient")
    p.add_argument("--adaptive-damping", action="store_true",
                   help="grow the CG damping after a failed line search or "
                   "a KL rollback, shrink it after a clean step")
    p.add_argument("--fvp-subsample", type=float)
    p.add_argument("--fvp-dtype", choices=["f32", "bf16"],
                   help="the cheap solve's matvec dtype; bf16 needs "
                   "--solve-audit-every >= 1")
    p.add_argument("--solve-audit-every", type=int,
                   help="every k-th update, re-solve at full precision and "
                   "gate the cheap solution on the solution cosine (0 = off)")
    p.add_argument("--solve-cosine-floor", type=float)
    p.add_argument("--cg-budget-adaptive", action="store_true",
                   help="adapt the CG iteration cap toward the residual "
                   "rule's exit point")
    p.add_argument("--cg-budget-floor", type=int)
    p.add_argument("--cg-budget-ceiling", type=int)
    p.add_argument("--solve-fault-skew", type=float,
                   help="test lever: skew the cheap matvec so it solves a "
                   "wrong system")
    p.add_argument("--normalize-obs", action="store_true",
                   help="running observation normalization")
    p.add_argument("--fuse-iterations", type=_positive_int,
                   help="iterations per chunk, with one stats transfer per "
                   "chunk; stop rules act at chunk ends")
    p.add_argument("--reward-target", type=float,
                   help="stop once a batch's mean episode reward reaches it")
    p.add_argument("--recover-on-nan", choices=("off", "restore"),
                   help="'restore': on a nonfinite update, restore the "
                   "last-good state and re-run (default 'off': abort)")
    p.add_argument("--max-recoveries", type=_positive_int,
                   help="consecutive recoveries before the run aborts")
    p.add_argument("--on-preempt", choices=("checkpoint", "ignore"),
                   help="SIGTERM/SIGINT: 'checkpoint' (default) writes a "
                   "final checkpoint and exits 75 for requeue; 'ignore' "
                   "keeps the default signal behaviour")
    p.add_argument("--max-worker-restarts", type=int,
                   help="gymproc: pools: process restarts per env worker "
                   "before its slice degrades to an in-process fallback "
                   "(default 2)")
    p.add_argument("--env-step-timeout", type=float,
                   help="gymproc: pools: seconds to wait on a worker reply "
                   "before declaring it dead and restarting it (default 60; "
                   "0 = wait forever)")
    p.add_argument("--inject-faults", metavar="SPEC",
                   help="deterministic chaos (trpo_torch.resilience.inject), "
                   "';'-separated, each firing once: kill_worker@step=K:"
                   "worker=W, hang_worker@step=K:worker=W, delay_step@step=K"
                   ":seconds=S, nan_update@iter=N, sigterm@iter=N — each a "
                   "fault_injected event on --metrics-jsonl")
    p.add_argument("--host-pipeline-groups", type=_positive_int,
                   help="host envs: step the envs in this many groups, "
                   "each on its own thread, overlapping inference")
    p.add_argument("--host-async-pipeline", action="store_true",
                   help="host envs: the asynchronous driver (the critic "
                   "fit and stats run behind the next rollout)")
    p.add_argument("--no-host-staged-transfers", action="store_true",
                   help="pipelined rollout: one transfer at the end "
                   "instead of each group's slice as it finishes")
    p.add_argument("--host-inference", choices=("device", "cpu"),
                   help="host envs: run the rollout's policy on the card "
                   "(default) or on the CPU")
    p.add_argument("--overlap", action="store_true",
                   help="device envs with --rollout-chunk: the overlapped "
                   "actor/learner loop (rollout k+1 runs while update k "
                   "does, staleness one window, importance-weighted; "
                   "train_overlap=1)")
    p.add_argument("--stats-drain-maxsize", type=int,
                   help="async driver: bound on the pending stats (0 = "
                   "unbounded)")
    p.add_argument("--log-jsonl", help="append one JSON row per iteration")
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every", type=_positive_int)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest complete checkpoint in "
                   "--checkpoint-dir")
    p.add_argument("--evaluate", type=_positive_int, metavar="N_STEPS",
                   help="after training, a greedy rollout of N_STEPS per "
                   "env; prints its mean episode reward")
    p.add_argument("--device", help="cuda (default) or cpu")
    p.add_argument("--debug-nans", action="store_true",
                   help="autograd anomaly detection and a finite check of "
                   "every stage's outputs (a debug mode: a host read per "
                   "stage)")
    p.add_argument("--metrics-jsonl",
                   help="append typed run events here (the reference's "
                   "event schema): manifest, iterations with the solver "
                   "counters, phases, health, recompile and memory records")
    p.add_argument("--health-checks", action="store_true",
                   help="watch for NaN/nonfinite trips, KL-rollback streaks, "
                   "explained-variance collapse, solver fallbacks and "
                   "stats-drain backpressure; findings print to stderr")
    p.add_argument("--status-port", type=int, metavar="PORT",
                   help="serve GET /status (JSON) and GET /metrics "
                   "(Prometheus) on 127.0.0.1:PORT while training; 0 = "
                   "the OS picks (printed, and in the status event)")
    p.add_argument("--memory-accounting", action="store_true",
                   help="per-iteration device-memory gauges as memory "
                   "events, and the health:memory_leak rule")
    p.add_argument("--run-descriptor", metavar="PATH",
                   help="write a run.json here at start (atomically): pid, "
                   "the bound status URL, event log, checkpoint dir")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler Chrome trace here: the "
                   "whole run, or with --profile-iteration N that "
                   "iteration's chunk only")
    p.add_argument("--profile-iteration", type=_positive_int, metavar="N",
                   help="with --profile-dir: trace absolute iteration N's "
                   "chunk only")
    p.add_argument("--trace-sample-rate", type=float,
                   help="--overlap: head-sampling rate of the train/* spans "
                   "on the event bus (needs --metrics-jsonl)")
    p.add_argument("--mesh-shape",
                   help="comma-separated mesh shape, e.g. 2 or 2,2 (with "
                   "--mesh-axes); run under torchrun with that many ranks")
    p.add_argument("--mesh-axes",
                   help='comma-separated mesh axis names, e.g. data or '
                   '"data,seq"; the first is the batch/env axis')
    for flag, (_, kind) in REFUSED.items():
        p.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    p.add_argument("--platform", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for a reference flag the port does not run: an unported
    layer's (naming its ROADMAP.md item) or a stated difference."""
    for flag, (item, _) in REFUSED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(
                f"{flag} is not ported to trpo_torch yet (ROADMAP.md Queue 1 "
                f"{item})")
    if args.platform is not None:
        raise SystemExit(f"--platform: {STATED_DIFFERENCES['--platform']}")


def build_config(args):
    cfg = get_preset(args.preset)
    overrides = {
        "env": args.env,
        "cg_precond_probes": args.cg_precond_probes,
        "cg_residual_rtol": args.cg_residual_rtol,
        "status_port": args.status_port,
        "trace_sample_rate": args.trace_sample_rate,
        "fvp_mode": args.fvp_mode,
        "host_pipeline_groups": args.host_pipeline_groups,
        "host_inference": args.host_inference,
        "stats_drain_maxsize": args.stats_drain_maxsize,
        "seed": args.seed,
        "n_envs": args.n_envs,
        "batch_timesteps": args.batch_timesteps,
        "policy_hidden": args.policy_hidden,
        "policy_gru": args.policy_gru,
        "policy_cell": args.policy_cell,
        "policy_experts": args.policy_experts,
        "fleet_n_envs": args.fleet_n_envs,
        "rollout_chunk": args.rollout_chunk,
        "compute_dtype": args.compute_dtype,
        "fvp_subsample": args.fvp_subsample,
        "fvp_dtype": args.fvp_dtype,
        "solve_audit_every": args.solve_audit_every,
        "solve_cosine_floor": args.solve_cosine_floor,
        "cg_budget_floor": args.cg_budget_floor,
        "cg_budget_ceiling": args.cg_budget_ceiling,
        "solve_fault_skew": args.solve_fault_skew,
        "n_iterations": args.iterations,
        "max_kl": args.max_kl,
        "cg_iters": args.cg_iters,
        "cg_damping": args.cg_damping,
        "gamma": args.gamma,
        "lam": args.lam,
        "precond_refresh_every": args.precond_refresh_every,
        "fuse_iterations": args.fuse_iterations,
        "reward_target": args.reward_target,
        "recover_on_nan": args.recover_on_nan,
        "max_recoveries": args.max_recoveries,
        "on_preempt": args.on_preempt,
        "max_worker_restarts": args.max_worker_restarts,
        "env_step_timeout": args.env_step_timeout,
        "inject_faults": args.inject_faults,
        "log_jsonl": args.log_jsonl,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_every": args.checkpoint_every,
    }
    if args.normalize_obs:
        overrides["normalize_obs"] = True
    if args.adaptive_damping:
        overrides["adaptive_damping"] = True
    if args.cg_budget_adaptive:
        overrides["cg_budget_adaptive"] = True
    if args.linesearch_kl_cap:
        overrides["linesearch_kl_cap"] = True
    if args.debug_nans:
        overrides["debug_nans"] = True
    if args.memory_accounting:
        overrides["memory_accounting"] = True
    if args.host_async_pipeline:
        overrides["host_async_pipeline"] = True
    if args.overlap:
        overrides["train_overlap"] = 1
    if args.no_host_staged_transfers:
        overrides["host_staged_transfers"] = False
    if args.cg_precondition is not None:
        overrides["cg_precondition"] = (
            False if args.cg_precondition == "off" else args.cg_precondition
        )
    cfg = cfg.replace(**{k: v for k, v in overrides.items() if v is not None})
    return _mesh_flags(args, cfg)


def _csv_positive_ints(flag: str, raw: str) -> tuple:
    """Parse a comma-separated positive-int flag value or exit cleanly."""
    try:
        vals = tuple(int(s) for s in raw.split(",") if s.strip())
    except ValueError:
        vals = ()
    if not vals or any(v < 1 for v in vals):
        raise SystemExit(
            f"{flag} must be comma-separated positive ints, got {raw!r}"
        )
    return vals


def _mesh_flags(args, cfg):
    """``--mesh-shape``/``--mesh-axes`` into the config, with the
    reference's errors (``trpo_tpu/train.py``)."""
    shape_flag, axes_flag = args.mesh_shape, args.mesh_axes
    if not (shape_flag or axes_flag):
        return cfg
    if shape_flag:
        shape = _csv_positive_ints("--mesh-shape", shape_flag)
    elif cfg.mesh_shape:
        # axes alone may rename a preset-supplied mesh
        shape = tuple(cfg.mesh_shape)
    else:
        raise SystemExit(
            "--mesh-axes requires --mesh-shape (the preset defines no mesh)")
    if len(shape) > 1 and not axes_flag:
        raise SystemExit(
            f"a multi-dimensional --mesh-shape {shape} requires "
            '--mesh-axes (e.g. "data,seq")')
    axes = tuple(s.strip() for s in (axes_flag or "data").split(",")
                 if s.strip())
    if len(axes) != len(shape):
        raise SystemExit(
            f"--mesh-axes {axes} must name one axis per mesh-shape "
            f"dimension {shape}")
    return cfg.replace(mesh_shape=shape, mesh_axes=axes)


def _fmt(value) -> str:
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def _summary(state, stats) -> None:
    """The one-line summary of a chunk's last iteration."""
    line = " ".join(f"{k}={_fmt(stats[k])}" for k in _PRINTED
                    + _LADDER_PRINTED if k in stats)
    print(f"iter {state.iteration} {line} "
          f"ms={stats['iteration_ms']:.1f}", flush=True)


def _write_run_descriptor(args, cfg, telemetry, checkpointer) -> None:
    """The ``--run-descriptor`` run.json: what external tooling needs to
    find this run (pid, the BOUND status URL, event log, checkpoint dir),
    written atomically after the status server bound."""
    server = telemetry.status_server if telemetry is not None else None
    absolute = lambda p: os.path.abspath(p) if p else None  # noqa: E731
    desc = {
        "schema": "trpo-tpu-run-descriptor",
        "pid": os.getpid(),
        "started_t": time.time(),
        "env": cfg.env,
        "preset": args.preset,
        "status_port": server.port if server is not None else None,
        "status_url": server.url if server is not None else None,
        "events_jsonl": absolute(args.metrics_jsonl),
        "log_jsonl": absolute(cfg.log_jsonl),
        "checkpoint_dir": absolute(cfg.checkpoint_dir),
        "resumed_from": checkpointer.latest_step()
        if checkpointer is not None and args.resume else None,
    }
    tmp = args.run_descriptor + ".tmp"
    with open(tmp, "w") as f:
        json.dump(desc, f)
    os.replace(tmp, args.run_descriptor)


def make_telemetry(args, cfg):
    """The run's ``obs.Telemetry``, or None when no telemetry flag is
    set."""
    if args.profile_iteration and not args.profile_dir:
        raise SystemExit("--profile-iteration requires --profile-dir")
    if cfg.trace_sample_rate > 0 and not args.metrics_jsonl:
        raise SystemExit("--trace-sample-rate needs --metrics-jsonl (spans "
                         "ride the event bus)")
    if not (args.metrics_jsonl or args.health_checks or args.profile_dir
            or cfg.status_port is not None or cfg.memory_accounting):
        return None
    from trpo_torch.obs import Telemetry

    telemetry = Telemetry(
        events_jsonl=args.metrics_jsonl,
        health_checks=args.health_checks,
        profile_dir=args.profile_dir,
        profile_iteration=args.profile_iteration,
        status_port=cfg.status_port,
        memory_accounting=cfg.memory_accounting,
    )
    if telemetry.status_server is not None:
        print(f"status endpoint: {telemetry.status_server.url}/status "
              "(and /metrics)", flush=True)
    return telemetry


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    refuse_unported(args)
    cfg = build_config(args)
    if args.resume and not cfg.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    try:
        agent = TRPOAgent(cfg.env, cfg, device=args.device)
    except UnlaunchedMeshError as e:
        print(f"trpo_torch.train: {e}", file=sys.stderr)
        return 2
    writer = agent.mesh is None or agent.mesh.is_writer
    with contextlib.ExitStack() as closing:
        if not writer:
            # ranks other than 0 print nothing: their rows are rank 0's
            closing.enter_context(contextlib.redirect_stdout(
                closing.enter_context(open(os.devnull, "w"))))
        return _run(args, cfg, agent, writer)


def _run(args, cfg, agent, writer: bool) -> int:
    family = (f" {cfg.policy_cell}={cfg.policy_gru}" if agent.is_recurrent
              else f" experts={cfg.policy_experts}"
              if cfg.policy_experts is not None else "")
    print(f"trpo_torch: preset={args.preset} env={cfg.env} "
          f"device={agent.device} batch={agent.n_steps}x{agent.n_envs} "
          f"policy={tuple(cfg.policy_hidden)}{family}", flush=True)
    # before the checkpointer: a corrupt sidecar found by --resume is a
    # health event on the same bus
    telemetry = make_telemetry(args, cfg) if writer else None
    bus = telemetry.bus if telemetry is not None else None
    with contextlib.ExitStack() as closing:
        if telemetry is not None:
            closing.callback(telemetry.close)
        checkpointer, state = None, None
        if cfg.checkpoint_dir:
            checkpointer = Checkpointer(cfg.checkpoint_dir, bus=bus,
                                        mesh=agent.mesh,
                                        param_layout=agent.param_layout)
            if args.resume and checkpointer.latest_step() is not None:
                state = checkpointer.restore(agent.init_state())
                agent.restore_host_env(checkpointer.restore_host_env())
                print(f"resumed from step {checkpointer.latest_step()}",
                      flush=True)
        logger = StatsLogger(jsonl_path=cfg.log_jsonl if writer else None,
                             bus=bus)
        closing.callback(logger.close)
        if args.run_descriptor and writer:
            _write_run_descriptor(args, cfg, telemetry, checkpointer)
        try:
            final = agent.learn(state=state, logger=logger,
                                checkpointer=checkpointer, callback=_summary,
                                telemetry=telemetry)
        except Preempted as p:
            # the final checkpoint is written: exit with the distinct
            # requeue code so a wrapper resubmits exactly this run
            where = (f"final checkpoint at step {p.step}" if p.step
                     else "no checkpoint configured")
            print(f"preempted (signal {p.signum}): {where}; exiting "
                  f"{p.exit_code} for requeue", flush=True)
            return p.exit_code
    print(f"done: {final.iteration} iterations, {final.total_timesteps} "
          f"timesteps, {int(final.total_episodes)} episodes", flush=True)
    if telemetry is not None and telemetry.profile_traces:
        print("profiler trace: " + ", ".join(telemetry.profile_traces),
              flush=True)
    if args.evaluate is not None:
        mean_ret, n_done = agent.evaluate(final, n_steps=args.evaluate)
        if n_done:
            print(f"greedy eval: mean episode reward {mean_ret:.1f} over "
                  f"{n_done} episodes", flush=True)
        else:
            print(f"greedy eval: no episode finished in {args.evaluate} "
                  f"steps; partial-episode reward ≥ {mean_ret:.1f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
