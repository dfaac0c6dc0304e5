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

``--serving-scale`` runs the serving control plane's block instead (the
counterpart of ``bench.py``'s ``serving_scale``): closed-loop actions/s
and p50/p99 through a :class:`~trpo_torch.serve.Router` over 1, 2 and 4
in-process replicas, and the scaling efficiency ``aps_N / (N × aps_1)``,
twice: behind ``SimulatedCostEngine`` at the reference's 60 ms (a
GIL-free sleep per dispatch: it isolates the router), and behind real
``InferenceEngine``s at ``humanoid-sim``'s width (what the card gives).
One JSON line, ``{"metric": "serving_scale", "simulated": {...},
"humanoid": {...}, ...}``.
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


def _router_load(router_url: str, body: bytes, clients: int,
                 per_client: int) -> dict:
    """``clients`` closed-loop clients, each on its own keep-alive
    connection (TCP_NODELAY), POST ``body`` to ``/act`` ``per_client``
    times after one untimed request; the clock starts when every client
    is connected. Actions/s, p50/p99 ms and the errors."""
    import http.client
    import socket
    import threading
    import urllib.parse

    from trpo_torch.utils.metrics import quantile_nearest_rank

    netloc = urllib.parse.urlsplit(router_url).netloc
    lats, errors, start = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(
        clients, action=lambda: start.append(time.perf_counter()))

    def post(conn):
        conn.request("POST", "/act", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        if resp.status != 200:
            raise RuntimeError(f"status {resp.status}")

    def client():
        conn = http.client.HTTPConnection(netloc, timeout=60.0)
        mine = []
        try:
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            post(conn)
            barrier.wait(timeout=120)
            for _ in range(per_client):
                t0 = time.perf_counter()
                post(conn)
                mine.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # counted, never silently dropped
            barrier.abort()
            with lock:
                errors.append(repr(e))
        finally:
            conn.close()
        with lock:
            lats.extend(mine)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - start[0] if start else float("nan")
    return {"requests": len(lats), "errors": errors,
            "actions_per_sec": len(lats) / wall,
            "p50_ms": quantile_nearest_rank(lats, 0.5),
            "p99_ms": quantile_nearest_rank(lats, 0.99)}


# closed-loop load per engine, (clients, timed requests per client):
# the reference's 8 x 8 for the 60 ms sleep, which 8 clients saturate
# at 4 replicas; 64 x 20 for the real engines (~1 ms of service), the
# load of chip_smoke.py's [control] scaling legs
SERVING_SCALE_LOAD = {"simulated": (8, 8), "humanoid": (64, 20)}


def serving_scale(device="cuda", engine: str = "simulated",
                  replica_counts=(1, 2, 4), clients: Optional[int] = None,
                  per_client: Optional[int] = None,
                  sim_cost_ms: float = 60.0) -> dict:
    """Closed-loop actions/s and p50/p99 through the router at each
    replica count, with the scaling efficiency against the first row.
    ``engine="simulated"``: the reference's block — a cartpole MLP-16
    engine at rung 1 behind a ``sim_cost_ms`` GIL-free sleep, so each
    replica is capacity-bound at ~1/sim_cost dispatches/s and the
    measurement isolates the router. ``engine="humanoid"``: real
    ``InferenceEngine``s at ``humanoid-sim``'s width (376→256→256→17,
    rungs 1/8/64), random weights from seed 0. ``clients`` and
    ``per_client`` default to the engine's ``SERVING_SCALE_LOAD``."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.serve import (InProcessReplica, MicroBatcher,
                                  PolicyServer, ReplicaSet, Router,
                                  SimulatedCostEngine)

    device = torch.device(device)
    if engine == "simulated":
        cfg = get_preset("cartpole").replace(
            n_envs=4, batch_timesteps=32, policy_hidden=(16,),
            vf_hidden=(16,), serve_batch_shapes=(1,))
    elif engine == "humanoid":
        cfg = get_preset("humanoid-sim")
    else:
        raise ValueError(f"engine must be simulated or humanoid: {engine}")
    clients = clients or SERVING_SCALE_LOAD[engine][0]
    per_client = per_client or SERVING_SCALE_LOAD[engine][1]
    agent = TRPOAgent(cfg.env, cfg, device=device)
    state = agent.init_state(seed=0)
    body = json.dumps({"obs": [0.0] * int(np.prod(agent.obs_shape))}
                      ).encode()

    def factory():
        eng = agent.serve_engine()
        eng.load(state.policy_params, state.obs_norm, step=0)
        if engine == "simulated":
            eng = SimulatedCostEngine(eng, cost_ms=sim_cost_ms)
        batcher = MicroBatcher(eng, deadline_ms=cfg.serve_deadline_ms,
                               adaptive_deadline=cfg.serve_adaptive_deadline)
        return PolicyServer(eng, batcher, port=0), [batcher]

    rows = []
    for n in replica_counts:
        replicaset = ReplicaSet(lambda rid: InProcessReplica(factory), n,
                                health_interval=0.25)
        router = None
        try:
            replicaset.start()
            if not replicaset.wait_healthy(n, timeout=300.0):
                raise RuntimeError(f"{n}-replica set never became healthy")
            router = Router(replicaset, port=0, max_inflight=256)
            load = _router_load(router.url, body, clients, per_client)
            if load["errors"]:
                raise RuntimeError(f"{n} replicas: {load['errors'][:3]}")
            rows.append({"replicas": n, "clients": clients,
                         "requests": load["requests"],
                         "actions_per_sec": load["actions_per_sec"],
                         "p50_ms": load["p50_ms"], "p99_ms": load["p99_ms"],
                         "retried": router.retried_total})
        finally:
            if router is not None:
                router.close()
            replicaset.close()
    base = rows[0]["actions_per_sec"] / rows[0]["replicas"]
    for row in rows:
        row["scaling_efficiency"] = (
            row["actions_per_sec"] / row["replicas"] / base)
    return {"engine": engine, "sim_cost_ms":
            sim_cost_ms if engine == "simulated" else None,
            "batch_shapes": list(cfg.serve_batch_shapes), "rows": rows}


def run_serving_scale(device="cuda") -> dict:
    """The ``--serving-scale`` JSON: both engines on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trpo_torch.bench needs a CUDA card; "
                               "--device cpu is the CPU test path")
        name, power = _card()
    else:
        name, power = "cpu", None
    out = {"metric": "serving_scale"}
    for engine in ("simulated", "humanoid"):
        _progress(f"serving_scale: {engine}")
        out[engine] = serving_scale(device, engine)
    out.update(device=name, power_limit_w=power)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--batch", type=int,
                   help=f"rows (default {BATCH}; required with --device cpu)")
    p.add_argument("--serving-scale", action="store_true",
                   help="run the router's replica-scaling block instead")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.serving_scale:
        res = run_serving_scale(args.device)
    else:
        res = run(args.device, args.batch)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
