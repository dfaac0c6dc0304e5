#!/usr/bin/env python
"""TRPO written the reference's way, on the port's compat surface
(counterpart: the reference's ``examples/reference_style.py``).

    python -m trpo_torch.scripts.reference_style            # on the card
    python -m trpo_torch.scripts.reference_style --device cpu

The reference composes its training loop by hand from its ``utils.py``
toolbox: host rollouts, ``discount`` for returns, a lazily built ``VF``
baseline, flat-vector gradients, a host-loop ``conjugate_gradient`` over
a Fisher-vector-product closure, and a host-loop ``linesearch``. This
script is that workflow, every helper from ``trpo_torch.compat``, on
cartpole stepped by the port's native C++ stepper one env at a time.
Returns go through ``compat.discount``, so on the card every path's
returns launch the reverse-scan kernel.

It is also a demonstration of why the fused path exists: every CG
iteration and line-search probe is a host↔device round trip (the
reference's execution model). Each iteration prints its wall ms, the CG
host loop's iterations and the line search's probes beside the mean
reward; ``python -m trpo_torch.train`` runs the whole update on the
device instead.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

CONFIG = {
    "max_pathlength": 200,
    "timesteps_per_batch": 1000,
    "gamma": 0.95,
    "cg_damping": 0.1,
    "max_kl": 0.01,
    "iterations": 5,
}


class SingleEnv:
    """Classic-gym facade (``reset() -> ob``, ``step(a) -> (ob, r, done,
    info)``) over the batched native stepper at batch size 1 — the
    reference's serial env protocol."""

    def __init__(self, max_pathlength: int):
        from trpo_torch.envs.native import NativeVecEnv

        self.vec = NativeVecEnv("cartpole", n_envs=1, seed=0,
                                max_episode_steps=max_pathlength)

    def reset(self):
        return self.vec.reset_all()[0]

    def step(self, action):
        nxt, rew, term, trunc, _final = self.vec.host_step(
            np.asarray([action])
        )
        return nxt[0], float(rew[0]), bool(term[0] or trunc[0]), {}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "trpo_torch.scripts.reference_style")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--iterations", type=int, default=CONFIG["iterations"])
    args = p.parse_args(argv)

    from trpo_torch import compat
    from trpo_torch.envs.native import native_available
    from trpo_torch.models import DiscreteSpec, make_policy
    from trpo_torch.ops.flat import tree_map

    if not native_available():
        raise SystemExit("the native env library failed to build")
    dev = torch.device(args.device)
    gen = compat.seed_everything(1, device=dev)

    env = SingleEnv(CONFIG["max_pathlength"])
    policy = make_policy((4,), DiscreteSpec(2), hidden=(64,))
    params = tree_map(lambda t: t.to(dev),
                      policy.init(torch.Generator().manual_seed(0)))
    gf = compat.GetFlat(params)
    sff = compat.SetFromFlat(params)
    vf = compat.VF(device=dev)

    def probs(p, obs):
        return torch.softmax(policy.apply(p, obs)["logits"], dim=-1)

    def act(ob, generator):
        with torch.no_grad():
            prob = probs(params, torch.as_tensor(ob, dtype=torch.float32,
                                                 device=dev)[None])
        action = compat.cat_sample(prob, generator=generator)[0]
        return int(action), prob[0].cpu().numpy()

    for iteration in range(args.iterations):
        t0 = time.perf_counter()
        paths = compat.rollout(env, act, CONFIG["max_pathlength"],
                               CONFIG["timesteps_per_batch"], generator=gen)
        for path in paths:
            path["returns"] = compat.discount(path["rewards"],
                                              CONFIG["gamma"], device=dev)
            path["baseline"] = vf.predict(path)
            path["advant"] = path["returns"] - path["baseline"]

        obs = torch.as_tensor(np.concatenate([q["obs"] for q in paths]),
                              dtype=torch.float32, device=dev)
        actions = torch.as_tensor(
            np.concatenate([q["actions"] for q in paths]), device=dev)
        old_dist = torch.as_tensor(
            np.concatenate([q["action_dists"] for q in paths]), device=dev)
        advant = np.concatenate([q["advant"] for q in paths])
        advant = torch.as_tensor((advant - advant.mean())
                                 / (advant.std() + 1e-8), device=dev)
        vf.fit(paths)

        n = len(actions)
        idx = torch.arange(n, device=dev)

        def surrogate(theta):
            new_dist = probs(sff(theta), obs)
            ratio = (compat.slice_2d(new_dist, idx, actions)
                     / compat.slice_2d(old_dist, idx, actions))
            return -torch.mean(ratio * advant)

        def kl(theta):
            new_dist = probs(sff(theta), obs)
            return torch.sum(old_dist * torch.log(
                (old_dist + 1e-8) / (new_dist + 1e-8))) / n

        theta_prev = torch.as_tensor(gf(params), device=dev)
        g = torch.func.grad(surrogate)(theta_prev).cpu().numpy()
        grad_kl = torch.func.grad(kl)
        counts = {"fvp": 0, "surrogate": 0}

        def fisher_vector_product(v):
            counts["fvp"] += 1
            v = torch.as_tensor(v, dtype=torch.float32, device=dev)
            hv = torch.func.jvp(grad_kl, (theta_prev,), (v,))[1]
            return (hv + CONFIG["cg_damping"] * v).cpu().numpy()

        stepdir = compat.conjugate_gradient(fisher_vector_product, -g)
        cg_iters = counts["fvp"]
        shs = 0.5 * stepdir.dot(fisher_vector_product(stepdir))
        fullstep = stepdir * np.sqrt(2 * CONFIG["max_kl"] / shs)

        def probe(th):
            counts["surrogate"] += 1
            with torch.no_grad():
                return float(surrogate(torch.as_tensor(
                    th, dtype=torch.float32, device=dev)))

        theta_new = compat.linesearch(probe, theta_prev.cpu().numpy(),
                                      fullstep, -g.dot(fullstep))
        params = sff(theta_new)

        mean_reward = float(np.mean([q["rewards"].sum() for q in paths]))
        ev = compat.explained_variance(
            np.concatenate([vf.predict(q) for q in paths]),
            np.concatenate([q["returns"] for q in paths]), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"iter {iteration} mean_reward={mean_reward:.1f} "
              f"explained_variance={ev:.3f} paths={len(paths)} "
              f"cg_iters={cg_iters} ls_probes={counts['surrogate']} "
              f"ms={ms:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
