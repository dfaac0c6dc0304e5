#!/usr/bin/env python
"""Seed (× GAE λ) sweep with the Population API
(counterpart: the reference's ``examples/population_sweep.py``).

Seed sweep:   python -m trpo_torch.scripts.population_sweep [--device cpu]
Seeds×λ grid: python -m trpo_torch.scripts.population_sweep \\
                  --env humanoid-sim --lam-grid 0.9,0.97,1.0 --seeds 2 \\
                  --chunks 4 --iters-per-chunk 50 --out sweep.json

``trpo_torch.population.Population`` trains N members in lockstep; with
``--lam-grid`` each member also carries its own GAE λ, so a seeds×λ grid
(every cell a full TRPO run: rollout → GAE(λ_member) → critic fit →
natural-gradient update) is one batched run, read on the host once per
chunk. ``--device`` (default ``cuda``) replaces the reference's
``--platform``; every other flag, line and ``--out`` key is the
reference's.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from trpo_torch.agent import TRPOAgent
from trpo_torch.config import get_preset
from trpo_torch.population import Population


def _chunk_scores(pop, stats):
    """Per-member episode-weighted mean reward over one chunk (the
    library's own scoring, ``Population.member_scores``), with -inf
    mapped to NaN for display, as the reference's script does."""
    s = pop.member_scores(stats).double().cpu().numpy()
    return np.where(np.isinf(s), np.nan, s)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m trpo_torch.scripts.population_sweep")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--env", default="cartpole")
    p.add_argument("--members", type=int, default=4,
                   help="seed count when no --lam-grid is given")
    p.add_argument("--lam-grid", default=None,
                   help="comma-separated GAE λ values — members become "
                   "the seeds×λ product")
    p.add_argument("--seeds", type=int, default=2,
                   help="seeds per λ cell (with --lam-grid)")
    p.add_argument("--chunks", type=int, default=5)
    p.add_argument("--iters-per-chunk", type=int, default=20)
    p.add_argument("--out", default=None, help="write a JSON evidence row")
    args = p.parse_args(argv)
    if args.members < 1 or args.chunks < 1 or args.iters_per_chunk < 1:
        p.error("--members, --chunks, --iters-per-chunk must be >= 1")

    cfg = get_preset(args.env)
    if args.env == "cartpole":
        cfg = cfg.replace(n_envs=8, batch_timesteps=1024,
                          policy_hidden=(32,), vf_train_steps=20)
    agent = TRPOAgent(cfg.env, cfg, device=args.device)

    lams = None
    if args.lam_grid:
        grid = [float(v) for v in args.lam_grid.split(",") if v.strip()]
        if not grid:
            p.error("--lam-grid must list at least one λ")
        seeds = [s for _ in grid for s in range(args.seeds)]
        lams = [lam for lam in grid for _ in range(args.seeds)]
        pop = Population(agent, seeds=seeds, lam=lams)
        labels = [f"λ={lam:g}/s{s}" for lam, s in zip(lams, seeds)]
    else:
        pop = Population(agent, seeds=list(range(args.members)))
        labels = [f"s{s}" for s in pop.seeds]

    t0 = time.perf_counter()
    history = []
    for chunk in range(args.chunks):
        stats = pop.run_iterations(args.iters_per_chunk)
        scores = _chunk_scores(pop, stats)
        history.append(scores)
        print(
            f"iter {(chunk + 1) * args.iters_per_chunk:>4}  "
            + "  ".join(
                f"{lab}:{v:8.1f}" for lab, v in zip(labels, scores)
            )
        )
    dt = time.perf_counter() - t0
    total = args.chunks * args.iters_per_chunk
    n_members = len(pop.seeds)
    print(
        f"{n_members} members x {total} iterations in {dt:.1f}s "
        f"({n_members * total / dt:.1f} member-updates/s); "
        f"best member: {labels[pop.best_member(stats)]}"
    )

    if args.lam_grid:
        # per-λ summary over seeds, final chunk
        final = history[-1]
        print("final-chunk reward by λ (mean over seeds ± spread):")
        for i, lam in enumerate(grid):
            cell = final[i * args.seeds:(i + 1) * args.seeds]
            print(
                f"  λ={lam:g}: {np.nanmean(cell):8.1f} "
                f"± {np.nanmax(cell) - np.nanmin(cell):6.1f}"
            )

    if args.out:
        row = {
            "env": args.env,
            "members": n_members,
            "labels": labels,
            "iterations": total,
            "wall_s": round(dt, 2),
            "member_updates_per_sec": round(n_members * total / dt, 2),
            "final_chunk_scores": [
                None if np.isnan(v) else round(float(v), 2)
                for v in history[-1]
            ],
        }
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
