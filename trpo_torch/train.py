"""Command-line training entry point (counterpart: ``trpo_tpu/train.py``).

    python -m trpo_torch.train --preset humanoid-sim --iterations 10 \
        --log-jsonl run.jsonl --checkpoint-dir ck --checkpoint-every 2 \
        [--resume] [--normalize-obs] [--fuse-iterations k] \
        [--recover-on-nan restore] [--reward-target R] --evaluate STEPS
    python -m trpo_torch.train --preset pong-sim      # 84x84x4 conv policy
    python -m trpo_torch.train --preset cartpole-po --policy-cell lstm
    python -m trpo_torch.train --preset cartpole --policy-experts 4

Runs ``TRPOAgent.learn`` on CUDA unless ``--device cpu`` is given. Each
iteration prints the stats block and a one-line summary (one per chunk
with ``--fuse-iterations``); ``--log-jsonl`` appends one JSON row per
iteration. ``--resume`` continues from the newest complete checkpoint in
``--checkpoint-dir``. On SIGTERM/SIGINT the run writes a final checkpoint
and exits with the requeue code (75). ``--evaluate STEPS`` runs a greedy
rollout of STEPS per env after training.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import PRESETS, get_preset
from trpo_torch.resilience import Preempted
from trpo_torch.utils.checkpoint import Checkpointer
from trpo_torch.utils.metrics import StatsLogger

__all__ = ["main", "parse_args"]

_PRINTED = (
    "total_episodes", "mean_episode_reward", "entropy", "kl_old_new",
    "surrogate_loss", "vf_explained_variance", "cg_iterations",
    "linesearch_success", "kl_rolled_back",
)
_LADDER_PRINTED = ("solve_cosine", "solve_fallback", "solve_pinned",
                   "cg_budget")


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
    p.add_argument("--cg-precondition", choices=["off", "head_block"])
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
    return p.parse_args(argv)


def build_config(args):
    cfg = get_preset(args.preset)
    overrides = {
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
    if args.cg_precondition is not None:
        overrides["cg_precondition"] = (
            False if args.cg_precondition == "off" else args.cg_precondition
        )
    return cfg.replace(**{k: v for k, v in overrides.items() if v is not None})


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = build_config(args)
    if args.resume and not cfg.checkpoint_dir:
        raise SystemExit("--resume requires --checkpoint-dir")
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    family = (f" {cfg.policy_cell}={cfg.policy_gru}" if agent.is_recurrent
              else f" experts={cfg.policy_experts}"
              if cfg.policy_experts is not None else "")
    print(f"trpo_torch: preset={args.preset} env={cfg.env} "
          f"device={agent.device} batch={agent.n_steps}x{agent.n_envs} "
          f"policy={tuple(cfg.policy_hidden)}{family}", flush=True)
    checkpointer, state = None, None
    if cfg.checkpoint_dir:
        checkpointer = Checkpointer(cfg.checkpoint_dir)
        if args.resume and checkpointer.latest_step() is not None:
            state = checkpointer.restore(agent.init_state())
            print(f"resumed from step {checkpointer.latest_step()}",
                  flush=True)
    logger = StatsLogger(jsonl_path=cfg.log_jsonl)
    try:
        final = agent.learn(state=state, logger=logger,
                            checkpointer=checkpointer, callback=_summary)
    except Preempted as p:
        # the final checkpoint is written: exit with the distinct requeue
        # code so a wrapper resubmits exactly this run
        where = (f"final checkpoint at step {p.step}" if p.step
                 else "no checkpoint configured")
        print(f"preempted (signal {p.signum}): {where}; exiting "
              f"{p.exit_code} for requeue", flush=True)
        return p.exit_code
    finally:
        logger.close()
    print(f"done: {final.iteration} iterations, {final.total_timesteps} "
          f"timesteps, {int(final.total_episodes)} episodes", flush=True)
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
