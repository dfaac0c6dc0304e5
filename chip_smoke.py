#!/usr/bin/env python3
"""Chip smoke for trpo_torch: build the hand-written Hopper kernels, hold
each against its plain PyTorch version on the card, drive full-width
``humanoid-sim`` training iterations through them, and check the result.

    python3 chip_smoke.py                 # needs one CUDA card
    python3 chip_smoke.py --kernels-only  # phases 1-3 only

Phases:
  1. build ``trpo_torch/csrc`` (nvcc, sm_90a) and name the card;
  2. the reverse affine scan kernel against its plain version;
  3. the fused Gauss-Newton FVP kernel against its plain version and the
     ``torch.func`` GGN operator, at the training shape and small ragged
     ones, with the device time of each of its sub-kernels (profiler);
  4. the main path: 3 ``TRPOAgent.run_iteration`` calls on ``humanoid-sim``
     at full width, with every kernel's launch count read around them;
  5. one update on a small input, on the card against the CPU.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device times by
CUDA-graph replay: ``iters`` calls captured in one graph and replayed
between two events, so no host launch cost falls in the window. The
host-issued figure (events around ``iters`` calls launched from Python)
is printed beside each as ``host_issued_ms``.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before the last line. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Peak rates of one H100 (NVIDIA data sheets, dense): f32 outside the
# tensor cores, TF32 on the tensor cores, and device-memory bandwidth.
_PEAKS = {
    "sxm": {"f32_flops": 67e12, "tf32_flops": 495e12, "bytes": 3.35e12},
    "pcie": {"f32_flops": 51e12, "tf32_flops": 378e12, "bytes": 2.0e12},
}
K1_PASSES = 3   # 3xTF32: hi·lo + lo·hi + hi·hi tensor-core products
K2_TOL = 2e-5   # the reference's scan tolerance (tests/test_pallas_scan.py:32)
K1_RTOL = 1e-5  # the reference's FVP tolerance (tests/test_fused_fvp.py:73)


class SmokeFailure(RuntimeError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def _host_issued_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls launched from Python, by CUDA
    events: the device time plus whatever host cost the launches expose."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters: int, replays: int = 3) -> float:
    """Mean device ms per call by CUDA-graph replay: ``iters`` calls
    captured in one graph, replayed ``replays`` times between events.
    Captures on the current stream, which must not be the default one (the
    GGN's pullback runs its backward on the stream its forward ran on)."""
    stream = torch.cuda.current_stream()
    _check(stream != torch.cuda.default_stream(),
           "graph timing needs a non-default current stream")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def _times(torch, fn, iters: int) -> tuple:
    """(graph-replayed device ms, host-issued ms) per call."""
    return _graph_ms(torch, fn, iters), _host_issued_ms(torch, fn, iters)


def _bound_ms(flops: float, nbytes: float, peaks,
              rate: str = "f32_flops") -> tuple:
    t_ops = flops / peaks[rate] * 1e3
    t_bytes = nbytes / peaks["bytes"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _kernel_phases(torch, fn, reps: int = 5) -> tuple:
    """Device µs of each kernel ``fn`` launches, from ``torch.profiler``
    over ``reps`` calls: per name [(name, launches/call, µs/call)], and the
    last call's launches in order [(name, µs)]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    def short(key):
        key = key.replace("(anonymous namespace)::", "")
        return key.split("(")[0].replace("void ", "").strip()

    by_name = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0:
            by_name.append((short(evt.key), evt.count / reps, us / reps))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    per_call = len(kernels) // reps if reps else 0
    last = [(short(e.name), e.time_range.elapsed_us())
            for e in kernels[len(kernels) - per_call:]]
    return sorted(by_name, key=lambda r: -r[2]), last


def _k1_design_bytes(rows: int, dims, splits: int) -> tuple:
    """Bytes one fused FVP call moves in device memory by its design, as a
    model from the shapes (each launch reads its row operands and writes
    its output once): (phase A, phase B). Phase A: per sweep, its A
    operands, the stored activation of its epilogue and its output;
    phase B: every layer's activations and cotangents, the split partials
    written and read back, v and the result."""
    L = len(dims) - 2
    h = [rows * d for d in dims[1:-1]]  # activations h_k, tangents t_k
    obs, c = rows * dims[0], rows * dims[-1]
    a = obs + 2 * h[0]                                  # obs @ V0 -> t0
    for k in range(1, L):
        a += 2 * h[k - 1] + 2 * h[k]                    # [h, t] -> t_k
    a += 2 * h[L - 1] + c                               # Fisher -> c
    a += c + 2 * h[L - 1]                               # c W^T -> g
    for k in range(L - 1, 0, -1):
        a += h[k] + 2 * h[k - 1]                        # g W^T -> g
    params = sum(x * y + y for x, y in zip(dims[:-1], dims[1:]))
    b = obs + 2 * sum(h) + c + 2 * splits * params + 2 * params
    return 4.0 * a, 4.0 * b


def phase_build(torch):
    from trpo_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    print(f"[build] {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = (lib.parent / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("Used" in line or "spill" in line
                    or line.startswith("==")):
                print(f"[build] {line.strip()}")
    print(f"[build] card: {_card_line()}", flush=True)


def phase_scan(torch, np, peaks, dev):
    from trpo_torch.ops import _build
    from trpo_torch.ops.reverse_scan import (
        reverse_affine_scan,
        reverse_affine_scan_plain,
    )

    rec = {}
    timed = ((391, 128), (1000, 300))
    for T, N in ((391, 128), (1000, 300), (1, 1), (17, 1), (392, 33)):
        rng = np.random.default_rng(T * 7 + N)
        c = torch.as_tensor(rng.uniform(0, 1, (T, N)), dtype=torch.float32,
                            device=dev)
        x = torch.as_tensor(rng.normal(size=(T, N)), dtype=torch.float32,
                            device=dev)
        y = reverse_affine_scan(c, x)
        ref = reverse_affine_scan_plain(c, x)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        scale = 1.0 + ref.abs().max().item()
        _check(err <= K2_TOL * scale,
               f"reverse scan ({T}, {N}): max |err| {err} > {K2_TOL}")
        line = f"[scan] ({T}, {N}) max_abs_err={err:.3e}"
        if (T, N) in timed:
            ms, host_ms = _times(torch, lambda: reverse_affine_scan(c, x), 50)
            plain_ms, plain_host_ms = _times(
                torch, lambda: reverse_affine_scan_plain(c, x), 3)
            bound, by = _bound_ms(2.0 * T * N, 12.0 * T * N, peaks)
            line += (f" kernel_ms={ms:.5f} host_issued_ms={host_ms:.5f} "
                     f"plain_ms={plain_ms:.3f} "
                     f"plain_host_issued_ms={plain_host_ms:.3f} "
                     f"bound_ms={bound:.5f} ({by})")
            if (T, N) == (391, 128):
                rec = {"max_abs_err": err, "ms": ms, "host_issued_ms": host_ms,
                       "plain_ms": plain_ms,
                       "plain_host_issued_ms": plain_host_ms,
                       "bound_ms": bound, "bound_by": by, "library_ms": None}
            else:
                rec[f"ms_{T}x{N}"] = ms
        print(line, flush=True)
    _build.reset_launches()
    return rec


def _fvp_problem(torch, np, dev, rows, dims, activation, zero_tail, seed):
    from trpo_torch.models.policy import BoxSpec, make_policy
    from trpo_torch.ops.flat import flatten_params

    policy = make_policy((dims[0],), BoxSpec(dims[-1]), hidden=dims[1:-1],
                         activation=activation)
    params = policy.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    params["log_std"] = torch.as_tensor(
        rng.uniform(-0.5, 0.2, dims[-1]), dtype=torch.float32)
    params = {"net": {"layers": [{k: t.to(dev) for k, t in layer.items()}
                                 for layer in params["net"]["layers"]]},
              "log_std": params["log_std"].to(dev)}
    obs = torch.as_tensor(rng.normal(size=(rows, dims[0])),
                          dtype=torch.float32, device=dev)
    weight = torch.ones(rows, device=dev)
    if zero_tail:
        weight[-zero_tail:] = 0.0
    flat0, unravel = flatten_params(params)
    v = torch.as_tensor(rng.normal(size=flat0.shape[0]), dtype=torch.float32,
                        device=dev)
    return policy, params, obs, weight, flat0, unravel, v


def phase_fvp(torch, np, peaks, dev):
    from trpo_torch.ops import _build
    from trpo_torch.ops.fused_fvp import (
        fused_fvp_net_plain,
        make_fused_gaussian_mlp_fvp,
    )
    from trpo_torch.ops.fvp import make_ggn_fvp
    from trpo_torch.trpo import _fvp_keep_indices

    damping = 0.1
    flagship_rows = len(_fvp_keep_indices(50_048, 0.75))
    cases = [
        (flagship_rows, (376, 256, 256, 17), "tanh", 0),
        (300, (11, 96, 160, 5), "tanh", 50),
        (300, (11, 96, 160, 5), "relu", 50),
        (257, (7, 33, 5), "elu", 17),
    ]
    rec, phases = {}, []
    for rows, dims, activation, zero_tail in cases:
        policy, params, obs, weight, flat0, unravel, v = _fvp_problem(
            torch, np, dev, rows, dims, activation, zero_tail, seed=rows)
        op = make_fused_gaussian_mlp_fvp(
            params["net"], obs, weight, params["log_std"], damping,
            activation=activation)
        ggn = make_ggn_fvp(lambda x: policy.apply(unravel(x), obs),
                           policy.dist.fisher_weight, flat0, weight,
                           damping=damping)

        def plain():
            net = fused_fvp_net_plain(op.obs, op.hs, op.ws, v, op.wn, op.m,
                                      damping, activation)
            sigma = (2.0 * op.sum_wn + damping) * v[:dims[-1]]
            return torch.cat([sigma, net])

        out = op.flat(v)
        ref = plain()
        oracle = ggn(v)
        torch.cuda.synchronize()
        rel_plain = ((out - ref).norm() / ref.norm()).item()
        rel_ggn = ((out - oracle).norm() / oracle.norm()).item()
        err = (out - ref).abs().max().item()
        _check(torch.isfinite(out).all().item(), f"fused FVP {dims}: nonfinite")
        _check(rel_plain < K1_RTOL,
               f"fused FVP {dims} {activation}: rel err vs plain {rel_plain}")
        _check(rel_ggn < K1_RTOL,
               f"fused FVP {dims} {activation}: rel err vs GGN {rel_ggn}")
        line = (f"[fvp] {rows}x{'->'.join(map(str, dims))} {activation} "
                f"rel_err_plain={rel_plain:.3e} rel_err_ggn={rel_ggn:.3e} "
                f"max_abs_err={err:.3e}")
        if rows == flagship_rows:
            again = op.flat(v)
            _check(torch.equal(out, again),
                   "fused FVP: two calls on the same v differ")
            ms, host_ms = _times(torch, lambda: op.flat(v), 20)
            plain_ms, plain_host_ms = _times(torch, plain, 20)
            ggn_ms, ggn_host_ms = _times(torch, lambda: ggn(v), 20)
            macs = rows * (2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
                           + sum(a * b for a, b in zip(dims[1:-1], dims[2:]))
                           + sum(a * b for a, b in zip(dims[1:-1], dims[2:])))
            nbytes = 4.0 * (rows * (dims[0] + sum(dims[1:-1]) + 1)
                            + 2 * flat0.numel() + dims[-1]
                            + sum(a * b for a, b in zip(dims[1:-1], dims[2:])))
            bound, by = _bound_ms(K1_PASSES * 2.0 * macs, nbytes, peaks,
                                  "tf32_flops")
            f32_bound, _ = _bound_ms(2.0 * macs, nbytes, peaks)
            line += (f" kernel_ms={ms:.4f} host_issued_ms={host_ms:.4f} "
                     f"plain_ms={plain_ms:.4f} "
                     f"plain_host_issued_ms={plain_host_ms:.4f} "
                     f"ggn_ms={ggn_ms:.4f} ggn_host_issued_ms={ggn_host_ms:.4f}"
                     f" bound_ms={bound:.4f} ({by}: {K1_PASSES}x "
                     f"{2.0 * macs / 1e9:.2f} GFLOP at the TF32 tensor rate, "
                     f"{nbytes / 1e6:.1f} MB) f32_cuda_core_bound_ms="
                     f"{f32_bound:.4f} share_of_bound={bound / ms:.3f}")
            rec = {"max_abs_err": err, "ms": ms, "host_issued_ms": host_ms,
                   "plain_ms": plain_ms, "plain_host_issued_ms": plain_host_ms,
                   "bound_ms": bound, "bound_by": by,
                   "f32_cuda_core_bound_ms": f32_bound, "library_ms": ggn_ms,
                   "library_host_issued_ms": ggn_host_ms}
            phases, order = _kernel_phases(torch, lambda: op.flat(v))
            # by the split count of the operator's launch plan, if it has one
            plan = getattr(op, "_plan", None)
            design = (_k1_design_bytes(rows, dims, plan.splits)
                      if hasattr(plan, "splits") else None)
        print(line, flush=True)
    if phases:
        split = {"A": 0.0, "B": 0.0, "other": 0.0}
        for name, _, us in phases:
            key = ("A" if "sweep" in name else
                   "B" if ("wgrad" in name or "reduce" in name) else "other")
            split[key] += us
        print("[fvp] phases (torch.profiler, device µs per call at "
              f"{flagship_rows}x376->256->256->17): "
              + "; ".join(f"{n} x{c:g} = {us:.1f}" for n, c, us in phases)
              + f" | phase A (sweeps) {split['A']:.1f}, phase B (weight "
              f"gradients + reduce) {split['B']:.1f}, other "
              f"{split['other']:.1f}", flush=True)
        print("[fvp] launches in order (µs): "
              + ", ".join(f"{n} {us:.1f}" for n, us in order), flush=True)
        if design is not None:
            print(f"[fvp] bytes per call by design (model from the shapes): "
                  f"phase A {design[0] / 1e6:.1f} MB, phase B "
                  f"{design[1] / 1e6:.1f} MB, total "
                  f"{sum(design) / 1e6:.1f} MB = "
                  f"{sum(design) / peaks['bytes'] * 1e3:.4f} ms at "
                  f"{peaks['bytes'] / 1e12:.2f} TB/s", flush=True)
    else:
        print("[fvp] phases: the profiler reported no device time",
              flush=True)
    _build.reset_launches()
    return rec


def _finite(torch, value) -> bool:
    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value.float()).all().item())
    return math.isfinite(float(value))


def phase_main_path(torch, dev):
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build

    cfg = get_preset("humanoid-sim").replace(solve_audit_every=0)
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    n_iter = 3
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(n_iter):
        t0 = time.perf_counter()
        state, stats = agent.run_iteration(state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        vals = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in stats.items()}
        print(f"[main] iter {state.iteration} ms={ms:.1f} "
              + json.dumps(vals), flush=True)
        episodes = vals["episodes_in_batch"] > 0
        for k, v in vals.items():
            if k in ("mean_episode_reward", "mean_episode_length") \
                    and not episodes:
                continue  # NaN by contract when no episode ended
            _check(_finite(torch, v), f"stat {k} = {v} is not finite")
        _check(vals["kl_old_new"] <= 2 * cfg.max_kl,
               f"kl_old_new {vals['kl_old_new']} > 2·max_kl")
    counts = dict(_build.LAUNCHES)
    print(f"[main] launches over {n_iter} iterations: {counts}", flush=True)
    _check(counts.get("fused_fvp", 0) >= 11 * n_iter,
           f"fused FVP launched {counts.get('fused_fvp', 0)} times")
    _check(counts.get("reverse_scan", 0) >= n_iter,
           f"reverse scan launched {counts.get('reverse_scan', 0)} times")
    _check(counts.get("fused_fvp_plain", 0) == 0
           and counts.get("reverse_scan_plain", 0) == 0,
           f"a plain version ran on the main path: {counts}")
    _stage_breakdown(torch, agent, state)
    return counts


def _stage_breakdown(torch, agent, state):
    """One more iteration, stage by stage, each stage ended by a
    synchronize: where the iteration's wall time goes (host clock)."""
    from trpo_torch.rollout import device_rollout

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (carry, traj), roll_ms = timed(lambda: device_rollout(
        agent.env, agent.policy, state.policy_params, state.env_carry,
        state.rng, agent.n_steps))
    state = state._replace(env_carry=carry)
    _, gae_ms = timed(lambda: agent._advantages(state.vf_state, traj))
    (state, pack), policy_ms = timed(lambda: agent._policy_phase(state, traj))
    _, vf_ms = timed(lambda: agent._vf_stats_phase(state.vf_state, pack))
    print(f"[main] stage ms: rollout={roll_ms:.1f} gae={gae_ms:.2f} "
          f"policy_phase(gae+update)={policy_ms:.1f} "
          f"update≈{policy_ms - gae_ms:.1f} vf_fit+stats={vf_ms:.1f}",
          flush=True)


def phase_small_reference(torch, dev):
    """One update on the same small trajectory, on the card (kernels) and
    on the CPU (plain versions): the new params must agree."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops.flat import flatten_params, tree_map
    from trpo_torch.rollout import device_rollout

    cfg = get_preset("humanoid-sim").replace(
        solve_audit_every=0, n_envs=8, batch_timesteps=512,
        policy_hidden=(32, 48))
    cpu = TRPOAgent(cfg.env, cfg, device="cpu")
    gpu = TRPOAgent(cfg.env, cfg, device=dev)
    s_cpu = cpu.init_state(seed=3)
    _, traj = device_rollout(cpu.env, cpu.policy, s_cpu.policy_params,
                             s_cpu.env_carry, s_cpu.rng, cpu.n_steps)
    s_gpu = gpu.init_state(seed=3)
    s_gpu = s_gpu._replace(policy_params=tree_map(
        lambda t: t.to(dev), s_cpu.policy_params))
    traj_gpu = tree_map(lambda t: t.to(dev), traj)
    new_cpu, st_cpu = cpu._process_trajectory(s_cpu, traj)
    new_gpu, st_gpu = gpu._process_trajectory(s_gpu, traj_gpu)
    a = flatten_params(new_cpu.policy_params)[0]
    b = flatten_params(new_gpu.policy_params)[0].cpu()
    rel = ((a - b).norm() / a.norm()).item()
    kl_gap = abs(st_cpu["kl_old_new"].item() - st_gpu["kl_old_new"].item())
    print(f"[small] card vs CPU update: params rel_err={rel:.3e} "
          f"kl cpu={st_cpu['kl_old_new'].item():.6g} "
          f"gpu={st_gpu['kl_old_new'].item():.6g}", flush=True)
    # CG amplifies f32 roundoff between the two operators' sum orders
    _check(rel < 1e-4, f"card vs CPU params rel err {rel}")
    _check(kl_gap < 1e-4, f"card vs CPU kl gap {kl_gap}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peaks = _PEAKS["pcie" if "PCIe" in name else "sxm"]
    print(f"[card] {name}; peaks used for bounds: {peaks}", flush=True)

    kernels_only = "--kernels-only" in sys.argv[1:]
    phase_build(torch)
    with torch.cuda.stream(torch.cuda.Stream()):  # capturable for graphs
        scan = phase_scan(torch, np, peaks, dev)
        fvp = phase_fvp(torch, np, peaks, dev)
    torch.cuda.synchronize()
    if kernels_only:
        counts = {}
    else:
        counts = phase_main_path(torch, dev)
        phase_small_reference(torch, dev)

    kernels = [
        {"name": "fused_gauss_newton_fvp", "route": "cuda",
         "source": "trpo_torch/csrc/fused_fvp.cu",
         "replaces": "trpo_tpu/ops/fused_fvp.py:298",
         "launches": counts.get("fused_fvp", 0), **fvp},
        {"name": "reverse_affine_scan", "route": "cuda",
         "source": "trpo_torch/csrc/reverse_scan.cu",
         "replaces": "trpo_tpu/ops/pallas_scan.py:75",
         "launches": counts.get("reverse_scan", 0), **scan},
    ]
    print(json.dumps({"kernels": kernels}))
    print(_card_line(), flush=True)
    if kernels_only:
        return 0  # the main path was not driven: no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
