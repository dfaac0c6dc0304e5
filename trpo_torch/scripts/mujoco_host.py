#!/usr/bin/env python
"""Host-simulator training: the simulator on the host, the update on the
device (counterpart: the reference's ``examples/mujoco_host.py``).

    python -m trpo_torch.scripts.mujoco_host      # needs gymnasium + mujoco
    python -m trpo_torch.scripts.mujoco_host --pipeline 4
    python -m trpo_torch.scripts.mujoco_host --env native:pendulum

The inksci reference drives one host gym env with one ``sess.run`` per
step. This script is the same workload at the port's operating point for
external simulators:

- N vectorized MuJoCo envs behind ``GymVecEnv`` (gymnasium), or the
  port's C++ stepper (``native:<kind>``), with shared running
  observation normalization (``envs/obs_norm.py``);
- policy inference batched over all envs and fetched as one packed array
  per step (``rollout.make_host_act_fn(pack=True)``);
- optionally, the envs split into groups whose host stepping overlaps
  the other groups' inference (``host_pipeline_groups``);
- optionally, inference on the host CPU (``--host-inference cpu``: no
  device round trip per step);
- GAE over the reverse-scan kernel, the critic fit and the update (CG on
  the fused Gauss-Newton FVP kernel) on the device.

``--device`` (default ``cuda``) replaces the reference's ``--platform``.
Where gymnasium or MuJoCo is missing, a ``gym:`` env raises the
adapter's error naming the package and the script exits nonzero; pick a
``native:`` env instead.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.mujoco_host")
    ap.add_argument(
        "--device", default="cuda",
        help="device of the update program: cuda (default) or cpu; with "
        "cuda, --host-inference is an actual placement choice",
    )
    ap.add_argument("--env", default="gym:HalfCheetah-v4")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2000)
    ap.add_argument(
        "--pipeline", type=int, default=1,
        help="host_pipeline_groups: >1 overlaps env stepping with device "
        "inference (multicore hosts)",
    )
    ap.add_argument(
        "--host-inference", choices=("device", "cpu"), default="device",
        help="'cpu' runs rollout inference on the host CPU: zero device "
        "round trips during collection (small policies)",
    )
    args = ap.parse_args(argv)

    cfg = get_preset("halfcheetah").replace(
        env=args.env,
        n_iterations=args.iterations,
        batch_timesteps=args.batch,
        normalize_obs=True,              # standard for MuJoCo-scale TRPO
        host_pipeline_groups=args.pipeline,
        host_inference=args.host_inference,
    )
    agent = TRPOAgent(cfg.env, cfg, device=args.device)
    state = agent.learn()
    mean_ret, n_done = agent.evaluate(state, n_steps=250)
    tag = f"over {n_done} episodes" if n_done else "(partial episode)"
    print(
        f"finished at iteration {int(state.iteration)}; "
        f"greedy eval return {mean_ret:.1f} {tag}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
