#!/usr/bin/env python
"""Reproduce the README's end-to-end learning table on the port
(counterpart: the reference's ``examples/learning_evidence.py``).

    python -m trpo_torch.scripts.learning_evidence              # on the card
    python -m trpo_torch.scripts.learning_evidence --rungs cartpole,pendulum
    python -m trpo_torch.scripts.learning_evidence --device cpu \\
        --rungs cartpole

Each rung trains its preset as published (seed 0) through
``TRPOAgent.run_iterations`` in chunks of the rung's size, and prints a
row ``| rung | iterations | wall | first → last |`` of the mean episode
reward. ``--device`` (default ``cuda``) is the one flag the reference
lacks: it stands where the reference pins its JAX platform. On the CPU
every rung runs, slowly; pick a subset with ``--rungs``.

``train`` also returns the run's per-iteration stats rows (Python
scalars), so a caller can read the solver's audits (``solve_audited``,
``solve_cosine``, ``solve_fallback``) and ``iteration_ms``: a chunk's
wall over its iterations, since the chunk runs with no host read in
between.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from trpo_torch.agent import TRPOAgent, _host_rows
from trpo_torch.config import get_preset

# rung -> (iterations, chunk)
RUNGS = {
    "cartpole": (300, 50),
    "pendulum": (300, 50),
    "cartpole-po": (200, 40),
    "catch": (200, 40),
    "pong-sim": (900, 25),   # Atari-scale 84×84×4 conv FVP
    "halfcheetah-sim": (300, 50),
    "humanoid-sim": (200, 25),
}


def train(preset: str, iters: int, chunk: int, device="cuda") -> list:
    """Train ``preset`` for ``iters`` iterations in chunks of ``chunk``,
    print the rung's row, and return the per-iteration stats rows."""
    cfg = get_preset(preset).replace(fuse_iterations=chunk)
    agent = TRPOAgent(cfg.env, cfg, device=device)
    state = agent.init_state(seed=0)
    t0 = time.perf_counter()
    first = last = None
    done = 0
    rows = []
    while done < iters:
        k = min(chunk, iters - done)
        t = time.perf_counter()
        state, stats = agent.run_iterations(state, k)
        chunk_rows = _host_rows(stats)
        ms = (time.perf_counter() - t) * 1e3 / k
        for row in chunk_rows:
            row["iteration_ms"] = ms
        rows += chunk_rows
        r = np.asarray([row["mean_episode_reward"] for row in chunk_rows],
                       np.float64)
        r = r[np.isfinite(r)]
        if r.size:
            if first is None:
                first = float(r[0])
            last = float(r[-1])
        done += k
    dt = time.perf_counter() - t0
    print(
        f"| {preset} | {iters} | {dt:.1f} s | "
        f"{first:.0f} → {last:.0f} |"
    )
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.learning_evidence")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rungs", default=",".join(RUNGS))
    args = ap.parse_args(argv)
    print("| rung | iterations | wall | mean episode reward |")
    print("|---|---|---|---|")
    for name in args.rungs.split(","):
        iters, chunk = RUNGS[name.strip()]
        train(name.strip(), iters, chunk, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
