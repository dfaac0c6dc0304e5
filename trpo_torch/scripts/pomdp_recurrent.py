#!/usr/bin/env python
"""Recurrent (GRU) TRPO on a POMDP: CartPole with hidden velocities
(counterpart: the reference's ``examples/pomdp_recurrent.py``).

    python -m trpo_torch.scripts.pomdp_recurrent            # on the card
    python -m trpo_torch.scripts.pomdp_recurrent --device cpu

The observation is masked to ``[x, theta]`` (``envs.wrappers``), so the
policy must estimate the velocities from history, which a feedforward
network cannot do. ``policy_gru`` adds a GRU between the torso and the
head (``models/recurrent.py``); the update runs the ``torch.func``
Gauss-Newton operator, and returns and GAE the reverse-scan kernel.

Two flags the reference lacks: ``--device`` (default ``cuda``) stands
where the reference pins its JAX platform, and ``--iterations``
(default 40, the reference's count) cuts the run's depth.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.pomdp_recurrent")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iterations", type=int, default=40)
    args = ap.parse_args(argv)
    cfg = get_preset("cartpole-po").replace(
        n_iterations=args.iterations,
        batch_timesteps=1024,
        n_envs=8,
        vf_train_steps=25,
        fuse_iterations=5,       # 5 iterations per chunk, one host read
    )
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    state = agent.learn()

    # eval window ≥ the env's 500-step horizon so episodes can complete
    mean_ret, n_done = agent.evaluate(state, n_steps=600)
    print(
        f"\nGRU policy on velocity-masked CartPole after "
        f"{int(state.iteration)} iterations: greedy eval "
        f"{mean_ret:.1f}"
        + (f" over {n_done} episodes" if n_done else " (partial episode)")
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
