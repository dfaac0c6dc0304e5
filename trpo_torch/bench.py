"""CG-solve ms/iter and policy updates/s at the humanoid 50k shape: the
port's counterpart of the headline of ``bench.py`` (the repository's JAX
benchmark).

    python -m trpo_torch.bench                     # one CUDA card
    python -m trpo_torch.bench --device cpu --batch 512   # a CPU smoke

The metric is BASELINE.json's: the natural-gradient solve (conjugate
gradient, forced to 10 iterations with ``residual_tol=0``) over
Fisher-vector products at 376-dim observations → 256 → 256 → 17-dim
diagonal Gaussian, batch 50,000, damping 0.1. The solves are chained, each
right-hand side depending on the last solution, and timed by CUDA events
after a warm-up; each path reports the median over the repetitions of
ms per CG iteration. Paths:

* ``k1_f32``: the default operator, the fused FVP kernel K1 (the headline
  ``value``);
* ``k1_bf16``: the fused FVP kernel at bf16 (K1-bf16);
* ``ggn_torch_func``: ``ops/fvp.make_ggn_fvp``, the ``torch.func``
  Gauss-Newton operator on cuBLAS.

Beside them, the whole unaudited ``humanoid-sim`` update (head-block
preconditioned CG on the ¾ curvature subsample, line search, KL rollback)
chained on its own output: ``update_ms`` and ``updates_per_s``.

``vs_baseline`` is ``bench.py``'s own baseline over ``value``: the
reference's execution (a host NumPy CG loop, one round trip per iteration
to a full-batch FVP, damping added on the host), here the plain GGN on the
CPU, one repetition.

Prints one JSON line: ``{"metric": "cg_solve_ms_per_iter", "value": ...,
"unit": "ms/iter", "vs_baseline": ..., "paths": {...}, "update_ms": ...,
"updates_per_s": ..., "device": ..., "power_limit_w": ...}``. Without
CUDA it raises, unless ``--device cpu`` is given with a small ``--batch``
(the test path; its numbers are CPU times, named so by ``device``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from trpo_torch.config import get_preset
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops.cg import conjugate_gradient
from trpo_torch.ops.flat import flatten_params, tree_map
from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
from trpo_torch.ops.fvp import make_ggn_fvp
from trpo_torch.ops.precond import init_gaussian_head_precond
from trpo_torch.trpo import TRPOBatch, make_trpo_update

__all__ = ["main", "run"]

OBS_DIM = 376
ACT_DIM = 17
HIDDEN = (256, 256)
BATCH = 50_000
CG_ITERS = 10
DAMPING = 0.1
# chained solves per timed run and timed runs per path: each run is
# 0.1-0.5 s of card time; on the CPU test path one of each
CHAIN = {"cuda": 20, "cpu": 1}
REPS = {"cuda": 5, "cpu": 1}
UPDATE_CHAIN = {"cuda": 10, "cpu": 1}


def _progress(msg: str) -> None:
    print(f"[trpo_torch.bench] {msg}", file=sys.stderr, flush=True)


def _card() -> tuple:
    """(name, power limit in W) from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in out.rsplit(",", 1))
    return name, float(limit.split()[0])


def _elapsed_ms(fn: Callable, device: torch.device):
    """(ms, result) of ``fn()``: CUDA events on a card, the host clock on
    the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


class _Problem:
    """The policy at seed 0, ``batch`` observations from numpy, and a unit
    right-hand side, on ``device``."""

    def __init__(self, device: torch.device, batch: int):
        self.device = device
        self.policy = make_policy((OBS_DIM,), BoxSpec(ACT_DIM),
                                  hidden=HIDDEN)
        self.params = tree_map(
            lambda t: t.to(device),
            self.policy.init(torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(0)
        self.obs = torch.as_tensor(
            rng.standard_normal((batch, OBS_DIM), dtype=np.float32),
            device=device)
        self.weight = torch.ones(batch, device=device)
        self.flat0, self.unravel = flatten_params(self.params)
        g = rng.standard_normal(self.flat0.numel()).astype(np.float32)
        self.g = torch.as_tensor(g / np.linalg.norm(g), device=device)

    def fused(self, dtype) -> Callable:
        return make_fused_gaussian_mlp_fvp(
            self.params["net"], self.obs, self.weight,
            self.params["log_std"], DAMPING, compute_dtype=dtype).flat

    def ggn(self, damping: float = DAMPING) -> Callable:
        return make_ggn_fvp(
            lambda x: self.policy.apply(self.unravel(x), self.obs),
            self.policy.dist.fisher_weight, self.flat0, self.weight,
            damping=damping)


def time_solve(op: Callable, g: torch.Tensor, device: torch.device):
    """Median ms per CG iteration over chained 10-iteration solves, and
    the last solution."""
    chain, reps = CHAIN[device.type], REPS[device.type]

    def chained():
        x = torch.zeros_like(g)
        for _ in range(chain):
            # 1e-30·x is float noise but a data dependency: each solve
            # waits for the last
            x = conjugate_gradient(op, -(g + 1e-30 * x), CG_ITERS,
                                   residual_tol=0.0).x
        return x

    with torch.no_grad():
        _elapsed_ms(chained, device)  # warm-up
        runs = []
        for _ in range(reps):
            ms, x = _elapsed_ms(chained, device)
            runs.append(ms / (chain * CG_ITERS))
    return statistics.median(runs), x


def time_update(prob: _Problem) -> float:
    """Median ms of one unaudited ``humanoid-sim`` update, chained on its
    own output with the preconditioner state threaded through."""
    device, batch = prob.device, prob.obs.shape[0]
    cfg = get_preset("humanoid-sim").replace(cg_residual_tol=0.0)
    update = make_trpo_update(prob.policy, cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    with torch.no_grad():
        dist = prob.policy.apply(prob.params, prob.obs)
        actions = prob.policy.dist.sample(dist, generator=gen)
    advantages = torch.randn(batch, generator=gen, device=device)
    tb = TRPOBatch(prob.obs, actions, advantages, dist, prob.weight)
    state = [prob.params, init_gaussian_head_precond(prob.params)]
    chain, reps = UPDATE_CHAIN[device.type], REPS[device.type]

    def chained():
        for _ in range(chain):
            params, stats = update(state[0], tb, None, state[1], None)
            state[:] = [params, stats.precond_next]
        return state[0]

    _elapsed_ms(chained, device)  # warm-up
    return statistics.median(_elapsed_ms(chained, device)[0] / chain
                             for _ in range(reps))


def _host_cg_loop(fvp_host: Callable, b: np.ndarray) -> np.ndarray:
    """The reference's host NumPy CG recurrence."""
    x = np.zeros_like(b)
    r = b.copy()
    p = b.copy()
    rdotr = r.dot(r)
    for _ in range(CG_ITERS):
        z = fvp_host(p)
        alpha = rdotr / p.dot(z)
        x += alpha * p
        r -= alpha * z
        new_rdotr = r.dot(r)
        p = r + (new_rdotr / rdotr) * p
        rdotr = new_rdotr
    return x


def time_baseline(batch: int):
    """``bench.py``'s baseline: host CG, one CPU GGN round trip per
    iteration, damping on the host; (ms per iteration, solution)."""
    prob = _Problem(torch.device("cpu"), batch)
    op = prob.ggn(damping=0.0)

    def fvp_host(p):
        with torch.no_grad():
            return op(torch.from_numpy(p)).numpy() + DAMPING * p

    b = -prob.g.numpy()
    fvp_host(b)  # warm-up
    t0 = time.perf_counter()
    x = _host_cg_loop(fvp_host, b)
    return (time.perf_counter() - t0) / CG_ITERS * 1e3, x


def run(device="cuda", batch: Optional[int] = None) -> dict:
    """The benchmark's result dict (see the module docstring)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trpo_torch.bench needs a CUDA card; "
                               "--device cpu --batch N is the CPU test path")
        name, power = _card()
        batch = BATCH if batch is None else batch
    elif batch is None:
        raise ValueError("--device cpu is a test path: give a small --batch")
    else:
        name, power = "cpu", None
    prob = _Problem(device, batch)
    paths, solutions = {}, {}
    for key, make in (("k1_f32", lambda: prob.fused(torch.float32)),
                      ("k1_bf16", lambda: prob.fused(torch.bfloat16)),
                      ("ggn_torch_func", prob.ggn)):
        _progress(f"{key}: timing")
        paths[key], solutions[key] = time_solve(make(), prob.g, device)
    _progress("update: timing")
    update_ms = time_update(prob)
    _progress("baseline (host CG over the CPU GGN): timing")
    base_ms, base_x = time_baseline(batch)
    x = solutions["k1_f32"].cpu().numpy().astype(np.float64)
    cos = float(x.dot(base_x) / (np.linalg.norm(x) * np.linalg.norm(base_x)))
    if not cos > 0.99:
        raise RuntimeError(f"K1 and the baseline solve different systems: "
                           f"solution cosine {cos}")
    return {
        "metric": "cg_solve_ms_per_iter",
        "value": paths["k1_f32"],
        "unit": "ms/iter",
        "vs_baseline": base_ms / paths["k1_f32"],
        "baseline_ms_per_iter": base_ms,
        "solution_cosine_vs_baseline": cos,
        "paths": paths,
        "update_ms": update_ms,
        "updates_per_s": 1e3 / update_ms,
        "batch": batch,
        "device": name,
        "power_limit_w": power,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--batch", type=int,
                   help=f"rows (default {BATCH}; required with --device cpu)")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(args.device, args.batch)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
