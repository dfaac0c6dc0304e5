"""Command-line training entry point (counterpart: ``trpo_tpu/train.py``).

    python -m trpo_torch.train --preset humanoid-sim --solve-audit-every 0 \\
        --iterations 3

Runs on CUDA unless ``--device cpu`` is given, and prints one stats line
per iteration.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import PRESETS, get_preset

__all__ = ["main", "parse_args"]

_PRINTED = (
    "total_episodes", "mean_episode_reward", "entropy", "kl_old_new",
    "surrogate_loss", "vf_explained_variance", "cg_iterations",
    "linesearch_success", "kl_rolled_back",
)


def _hidden(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="humanoid-sim", choices=sorted(PRESETS))
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--seed", type=int)
    p.add_argument("--n-envs", type=int)
    p.add_argument("--batch-timesteps", type=int)
    p.add_argument("--policy-hidden", type=_hidden,
                   help="comma-separated widths, e.g. 256,256")
    p.add_argument("--cg-precondition", choices=["off", "head_block"])
    p.add_argument("--fvp-subsample", type=float)
    p.add_argument("--solve-audit-every", type=int)
    p.add_argument("--device", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_config(args):
    cfg = get_preset(args.preset)
    overrides = {
        "seed": args.seed,
        "n_envs": args.n_envs,
        "batch_timesteps": args.batch_timesteps,
        "policy_hidden": args.policy_hidden,
        "fvp_subsample": args.fvp_subsample,
        "solve_audit_every": args.solve_audit_every,
        "n_iterations": args.iterations,
    }
    if args.cg_precondition is not None:
        overrides["cg_precondition"] = (
            False if args.cg_precondition == "off" else args.cg_precondition
        )
    return cfg.replace(**{k: v for k, v in overrides.items() if v is not None})


def _fmt(value) -> str:
    if isinstance(value, torch.Tensor):
        value = value.item()
    if isinstance(value, float):
        return f"{value:.6g}"
    return str(value)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cfg = build_config(args)
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    print(f"trpo_torch: preset={args.preset} env={cfg.env} "
          f"device={agent.device} batch={agent.n_steps}x{agent.n_envs} "
          f"policy={tuple(cfg.policy_hidden)}", flush=True)
    state = agent.init_state()
    for _ in range(cfg.n_iterations):
        t0 = time.perf_counter()
        state, stats = agent.run_iteration(state)
        line = " ".join(f"{k}={_fmt(stats[k])}" for k in _PRINTED)
        if agent.device.type == "cuda":
            torch.cuda.synchronize(agent.device)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"iter {state.iteration} {line} ms={ms:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
