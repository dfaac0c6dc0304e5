#!/usr/bin/env python
"""Quickstart: train CartPole with the high-level API
(counterpart: the reference's ``examples/quickstart.py``).

    python -m trpo_torch.scripts.quickstart                 # on the card
    python -m trpo_torch.scripts.quickstart --device cpu

The inksci reference's whole entry point is three module-level
statements (``env = gym.make("CartPole-v0"); agent = TRPOAgent(env);
agent.learn()``). Here the same three steps are explicit and
configurable. ``--device`` (default ``cuda``) is the one flag the
reference lacks: it stands where the reference pins its JAX platform.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_preset("cartpole").replace(
        n_iterations=30,
        # the inksci stop heuristic (mean reward > 1.1 * 500) as an explicit
        # target; CartPole here is the v1 task (cap 500), so 450 ≈ solved
        reward_target=450.0,
    )
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    state = agent.learn()
    print(f"finished at iteration {int(state.iteration)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
