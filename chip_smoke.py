#!/usr/bin/env python3
"""Chip smoke for trpo_torch: build the hand-written Hopper kernels, hold
each against its plain PyTorch version on the card, drive the flagship and
the other device-env presets through them as published, and check the
result.

    python3 chip_smoke.py                 # needs one CUDA card
    python3 chip_smoke.py --kernels-only  # phases 1-4 only

Phases:
  1. build ``trpo_torch/csrc`` (nvcc, sm_90a) and name the card;
  2. ``[scan]`` the reverse affine scan kernel (K2) against its plain
     version;
  3. ``[fvp]`` the fused Gauss-Newton FVP kernel (K1, f32) against its
     plain version and the ``torch.func`` GGN operator, at the training
     shape and small ragged ones (one 9 hidden layers deep), with the
     device time of each of its sub-kernels (profiler);
  4. ``[fvp-bf16]`` K1-bf16 against its plain bf16 version and against
     K1, at the same shapes and at torsos past 256 wide, beside the
     ``torch.func`` GGN at bf16, with its phase split and bytes by design;
     at the flagship shape it must be faster than both that GGN and f32
     K1;
  5. ``[main]`` the main path: 3 ``TRPOAgent.run_iteration`` calls on the
     ``humanoid-sim`` preset unchanged (its ¾ curvature subsample audited
     every 25 updates), with every kernel's launch count read around them,
     and the stage times of an audited and of an unaudited update, with
     the device's idle share in each;
  6. ``[bf16]`` the same preset on the ladder's bf16 rung, 3 iterations,
     and its unaudited update timed against ``[main]``'s (main, bf16,
     bf16, main);
  7. ``[fleet]`` ``humanoid-sim-fleet`` unchanged (1,024 envs, 49-step
     windows in 7-step chunks), 2 iterations;
  8. ``[cartpole]`` ``cartpole`` and ``cartpole-fleet``, 2 iterations each;
  9. ``[small]`` one audited update on a small input, on the card against
     the CPU;
 10. ``[pixel]`` ``catch`` (2 iterations) and ``pong-sim`` (3: 8 envs ×
     256 steps of 84×84×4 uint8 frames, a 1.7M-parameter conv policy) as
     published, from torch's cuDNN defaults; pong-sim's stage times, its
     GGN CG ms/iter at 2,048 rows, and its GGN FVP against the CPU's;
 11. ``[recurrent]`` ``cartpole-po`` (GRU 64) and its LSTM variant, 2
     iterations each, with stage times and GGN CG ms/iter;
 12. ``[moe]`` ``cartpole`` with 4 experts, 2 iterations;
 13. ``[learn]`` the trainer as users run it, ``train.main`` in this
     process on ``humanoid-sim`` as published: 4 iterations with a
     checkpoint every 2, a JSONL log and a greedy evaluation, then a
     second run resumed from step 2 for 2 iterations, whose step-4 state
     must equal the first run's leaf by leaf (bitwise) and whose rows 3-4
     must equal the first run's; the checkpoint's save and restore ms, and
     ``learn``'s iteration against a bare ``run_iteration`` from one state
     (bare, learn, learn, bare); then ``cartpole``, ``cartpole-po`` and
     ``pong-sim`` each resumed from step 1 of 2, bitwise;
 14. ``[norm]`` ``halfcheetah-sim`` with ``normalize_obs``, 2 iterations:
     the update still goes through K1;
 15. ``[overlap]`` ``humanoid-sim-fleet`` as published with
     ``train_overlap=1``: one overlapped iteration bitwise equal to one
     serial iteration; 4 overlapped iterations (K1 exactly
     Σ(cg_iterations + 1), K2 once an iteration, every stale update's KL
     within 1.5·max_kl); iteration ms, thread CPU and the device's idle
     share, serial against overlapped (serial, overlap, overlap, serial),
     with the learner's stage times; ``train.main --overlap`` with a
     checkpoint and a resume;
 16. ``[population]`` 8 members of ``humanoid-sim`` as published, 2
     lockstep iterations (K1 exactly, K2 16 times); member 5 bitwise
     equal to a solo run of seed 5; member-updates/s and env-steps/s
     beside 8 × a solo iteration, and the idle share;
 17. ``[host]`` the host envs (``native:``; the card's machine has no
     gymnasium, so ``gym:`` is held against the reference on the CPU and
     must refuse here): the C++ toolchain and the native library under
     ``build/``; native:cartpole/pendulum step for step against the device
     envs on the card; ``pendulum`` as published on ``native:pendulum``
     (16 envs x 250 steps, 3 iterations, stage times and idle share);
     ``cartpole`` on ``native:cartpole`` (2 iterations); rollout ms by
     ``host_pipeline_groups`` 1, 2, 4 at pendulum's window and at
     cartpole-fleet's width (2,048 x 4; mode-policy trajectories pipelined
     == serial bitwise); ``host_inference`` device against cpu;
     ``train.main`` serial against ``--host-async-pipeline`` on 1 and 2
     groups (bitwise) and a resume from step 1 (state and sidecar
     bitwise); one
     ``jacobi`` update (K1 Σ(cg_iterations + 1) + probes) and one
     ``jvp_grad`` update (step cosine with K1's ≥ 0.999);
 18. ``[preempt]`` ``python -m trpo_torch.train`` in a child process, sent
     SIGTERM after its first checkpoint: it must exit 75 with its last
     finished iteration as the newest complete checkpoint;
 19. ``[serve]`` the serving data plane (``trpo_torch.serve``) at full
     width: ``humanoid-sim`` (the engine's rungs 1/8/64 and n = 70
     chunked against eager ``act``; ``PolicyServer`` on TCP and a Unix
     socket, JSON and binary; ``/act`` p50/p99 and requests/s at 1 and
     64 clients; a hot reload from step 2 to step 4 under 16 clients, 0
     failed or mislabelled), ``pong-sim`` (84×84×4 uint8), ``cartpole-po``
     GRU and LSTM (the session engine against ``act(policy_carry=...)``,
     64 concurrent HTTP sessions × 20 steps) and the 4-expert
     ``cartpole``; per rung the host-clock p50/p99 and the graph
     replay's device ms; 0 graph captures on the request path and 0
     launches of any kernel or plain version;
 20. ``[control]`` the serving control plane at full width (``humanoid-sim``
     rungs 1/8/64, ``cartpole-po`` GRU 64): ``/act`` p50/p99 and
     requests/s at 64 clients x 20 on one bare replica and through the
     router (async core) over 1, 2 and 4 in-process replicas and over 2
     and 4 ``python -m trpo_torch.serve`` children placed by
     ``TemplateTransport`` on hosts h0/h1 (their startup seconds and device
     memory), the load from client threads here and from a load process;
     one engine's ``infer`` while another captures; a replica killed under
     16 clients (0 client errors, retried, relaunched); 16 sessions x 20
     steps with the replica pinned by half of them killed at step 10
     (resumed from the journal, actions identical, carries within 1e-6);
     a canary promoted (step 4) and a NaN step rolled back under 8
     clients; the autoscaler's one scale-out under load and one lossless
     scale-in; ``python -m trpo_torch.serve --replicas 2`` SIGTERMed (exit
     0). 0 launches, 0 captures on the request path, device memory back
     within 1% once every in-process replica is closed;
 21. ``[obs]`` the run-event bus, the tracer and live telemetry:
     ``python -m trpo_torch.train --preset humanoid-sim`` (4 iterations)
     with ``--metrics-jsonl``, ``--health-checks``, ``--status-port 0``,
     ``--memory-accounting``, ``--run-descriptor`` and a profiler window
     on iteration 3, scraped by a thread (every event valid, one
     iteration event per iteration, the card in the manifest, the
     ``/metrics`` iteration gauge advancing, 0 unexpected builds or
     captures, K1's and K2's symbols in the trace); in process,
     ``cg_iters_total`` + updates against K1's launches (exact) and
     ``learn``'s iteration ms with telemetry off and on; the replicated
     server over 2 children at trace rates 0, 0.01 and 1 (``/act``
     requests/s and p50/p99 at 64 clients x 20, every span valid, every
     trace rooted, a child killed at rate 0 still traced);
 22. ``[bench]`` ``trpo_torch.bench``'s JSON line at the 50k shape.
Each path (5-8, 10-17, 19-21) is driven with the launch counts set to 0
just before it and read just after. The fused kernel's launches on each path
are checked exactly: Σ(cg_iterations + 1) over its updates (see
``_exact_fvp_launches``); the pixel, recurrent and MoE paths launch
neither fused kernel nor any plain version, and K2 once per iteration.
``[main]`` also times the unaudited update with the CG's exit read every
0 (the masked loop), 1 and 2 iterations.

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

import contextlib
import io
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Peak rates of one H100 (NVIDIA data sheets, dense): f32 outside the
# tensor cores, TF32 on the tensor cores, and device-memory bandwidth.
_PEAKS = {
    "sxm": {"f32_flops": 67e12, "tf32_flops": 495e12, "bf16_flops": 989e12,
            "bytes": 3.35e12},
    "pcie": {"f32_flops": 51e12, "tf32_flops": 378e12, "bf16_flops": 756e12,
             "bytes": 2.0e12},
}
K1_PASSES = 3   # 3xTF32: hi·lo + lo·hi + hi·hi tensor-core products
K2_TOL = 2e-5   # the reference's scan tolerance (tests/test_pallas_scan.py:32)
K1_RTOL = 1e-5  # the reference's FVP tolerance (tests/test_fused_fvp.py:73)
# K1-bf16 against its plain bf16 version: the same rounding points, sums in
# another order, so a value may land one bf16 ulp away
K1_BF16_RTOL = 1e-2
# ... and a tighter limit on the rounding points themselves: sound runs read
# 1e-5 or less, f32 K1 on the same inputs (it rounds nowhere) 1e-3 or more,
# and that control must fail it
K1_BF16_TIGHT = 1e-4
# a bf16 torso past one accumulator's 256 columns, at the flagship's rows:
# K1-bf16 runs its chain product by product there
WIDE_DIMS = (376, 512, 512, 17)
# a torso deeper than one launch's 7 hidden layers (any depth runs: the
# launches take the layers in groups), at a small ragged row count
DEEP_DIMS = (11,) + (40,) * 9 + (5,)


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


def _k1_bf16_design_bytes(rows: int, dims, splits: int) -> tuple:
    """The same model for K1-bf16's design: (phase A with the tangent
    unpack, phase B with the reduce). Phase A reads ``obs`` and each ``h_k``
    once in bf16 (an epilogue's re-read of a tile the block has just
    streamed is counted as an L2 hit), the bf16 weight and tangent blocks,
    and writes the rounded ``g_k`` and ``c`` (bf16) and its per-tile column
    sums (f32); the unpack reads the f32 weight tangents and writes them in
    bf16. Phase B reads ``obs``, the ``h_k``, ``g_k``, ``c`` and the column
    sums again and writes its split partials, which the reduce reads back
    with ``v`` before writing the result."""
    h = sum(rows * d for d in dims[1:-1])
    obs, c = rows * dims[0], rows * dims[-1]
    weights = sum(x * y for x, y in zip(dims[:-1], dims[1:]))
    total = weights + sum(dims[1:]) + dims[-1]
    colsum = 4 * -(-rows // 128) * sum(dims[1:])
    a = (2 * (obs + h) + 2 * 2 * weights + 2 * (h + c) + colsum
         + (4 + 2) * weights)
    b = (2 * (obs + 2 * h + c) + colsum + 2 * 4 * splits * (total - dims[-1])
         + 2 * 4 * total)
    return float(a), float(b)


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
    import importlib.util

    found = {m: importlib.util.find_spec(m) is not None
             for m in ("gymnasium", "mujoco")}
    print(f"[build] host simulators importable here: {found}", flush=True)


def phase_scan(torch, np, peaks, dev):
    from trpo_torch.ops import _build
    from trpo_torch.ops.reverse_scan import (
        reverse_affine_scan,
        reverse_affine_scan_plain,
    )

    rec = {}
    timed = ((391, 128), (1000, 300))
    # then the host paths' windows: native:pendulum, native:cartpole and
    # the cartpole-fleet width on native:cartpole
    for T, N in ((391, 128), (1000, 300), (1, 1), (17, 1), (392, 33),
                 (250, 16), (125, 8), (4, 2048)):
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
    from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
    from trpo_torch.ops.fvp import make_ggn_fvp
    from trpo_torch.trpo import _fvp_keep_indices

    damping = 0.1
    flagship_rows = len(_fvp_keep_indices(50_048, 0.75))
    cases = [
        (flagship_rows, (376, 256, 256, 17), "tanh", 0),
        (300, (11, 96, 160, 5), "tanh", 50),
        (300, (11, 96, 160, 5), "relu", 50),
        (257, (7, 33, 5), "elu", 17),
        (203, DEEP_DIMS, "tanh", 17),
        (4000, (3, 64, 64, 1), "tanh", 0),  # native:pendulum's update
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

        out = op.flat(v)
        ref = op.plain(v)
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
            plain_ms, plain_host_ms = _times(torch, lambda: op.plain(v), 20)
            ggn_ms, ggn_host_ms = _times(torch, lambda: ggn(v), 20)
            macs = _fvp_macs(rows, dims)
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


def _fvp_macs(rows, dims) -> int:
    """Multiply-adds of one FVP call: the tangent sweep (2 products a
    layer but the first), the backward dgrads and the weight gradients."""
    pairs = list(zip(dims[:-1], dims[1:]))
    inner = sum(a * b for a, b in zip(dims[1:-1], dims[2:]))
    return rows * (2 * sum(a * b for a, b in pairs) + 2 * inner)


def phase_fvp_bf16(torch, np, peaks, dev, k1_ms):
    """K1-bf16 against its plain bf16 version (same inputs, the card), and
    against f32 K1; timed beside the ``torch.func`` GGN over the bf16
    ``apply_cast`` forward (the library yardstick). At the flagship shape
    it must be faster than that GGN and than f32 K1 (``k1_ms``, the same
    run)."""
    from trpo_torch.ops import _build
    from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
    from trpo_torch.ops.fvp import make_ggn_fvp
    from trpo_torch.trpo import _fvp_keep_indices

    damping = 0.1
    flagship_rows = len(_fvp_keep_indices(50_048, 0.75))
    cases = [
        (flagship_rows, (376, 256, 256, 17), "tanh", 0),
        (300, (11, 96, 160, 5), "tanh", 50),
        (300, (11, 96, 160, 5), "relu", 50),
        (257, (7, 33, 5), "elu", 17),
        (129, (376, 33, 33, 17), "tanh", 20),
        (300, (376, 512, 17), "tanh", 50),  # past 256: product by product
        (203, DEEP_DIMS, "tanh", 17),  # past 7 hidden: product by product
        (flagship_rows, WIDE_DIMS, "tanh", 0),
    ]
    rec, wide = {}, {}
    for rows, dims, activation, zero_tail in cases:
        policy, params, obs, weight, flat0, unravel, v = _fvp_problem(
            torch, np, dev, rows, dims, activation, zero_tail, seed=rows)
        op = make_fused_gaussian_mlp_fvp(
            params["net"], obs, weight, params["log_std"], damping,
            activation=activation, compute_dtype=torch.bfloat16)
        op32 = make_fused_gaussian_mlp_fvp(
            params["net"], obs, weight, params["log_std"], damping,
            activation=activation)
        out = op.flat(v)
        ref = op.plain(v)
        out32 = op32.flat(v)
        torch.cuda.synchronize()
        _check(torch.isfinite(out).all().item(),
               f"K1-bf16 {dims}: nonfinite")
        rel_plain = ((out - ref).norm() / ref.norm()).item()
        rel_f32 = ((out - out32).norm() / out32.norm()).item()
        control = ((out32 - ref).norm() / ref.norm()).item()
        err = (out - ref).abs().max().item()
        again = op.flat(v)
        bitwise = bool(torch.equal(out, again))
        _check(rel_plain <= K1_BF16_RTOL,
               f"K1-bf16 {dims} {activation}: rel err vs plain {rel_plain}")
        _check(rel_plain <= K1_BF16_TIGHT,
               f"K1-bf16 {dims} {activation}: rel err vs plain {rel_plain} "
               f"past the rounding-point limit {K1_BF16_TIGHT}")
        _check(control > K1_BF16_TIGHT,
               f"K1-bf16 {dims} {activation}: f32 K1 reads {control} "
               f"against the bf16 plain version, within {K1_BF16_TIGHT}")
        _check(bitwise, f"K1-bf16 {dims}: two calls on the same v differ")
        line = (f"[fvp-bf16] {rows}x{'->'.join(map(str, dims))} {activation}"
                f" rel_err_plain={rel_plain:.3e} max_abs_err={err:.3e} "
                f"rel_err_vs_f32_k1={rel_f32:.3e} "
                f"f32_k1_vs_plain={control:.3e} bitwise_repeat={bitwise}")
        if rows == flagship_rows and dims == WIDE_DIMS:
            ggn = make_ggn_fvp(
                lambda x: policy.apply_cast(unravel(x), obs, torch.bfloat16),
                policy.dist.fisher_weight, flat0, weight, damping=damping)
            ggn(v)
            ms, _ = _times(torch, lambda: op.flat(v), 20)
            ggn_ms, _ = _times(torch, lambda: ggn(v), 20)
            macs = _fvp_macs(rows, dims)
            wide = {"ms_wide": ms, "library_ms_wide": ggn_ms}
            line += (f" kernel_ms={ms:.4f} ggn_bf16_ms={ggn_ms:.4f} "
                     f"achieved {2.0 * macs / ms / 1e9:.1f} TFLOP/s")
            phases, _ = _kernel_phases(torch, lambda: op.flat(v))
            if phases:
                print("[fvp-bf16] wide phases (torch.profiler, device µs per "
                      "call): " + "; ".join(f"{n} x{c:g} = {us:.1f}"
                                            for n, c, us in phases),
                      flush=True)
            del ggn
        elif rows == flagship_rows:
            ggn = make_ggn_fvp(
                lambda x: policy.apply_cast(unravel(x), obs, torch.bfloat16),
                policy.dist.fisher_weight, flat0, weight, damping=damping)
            ggn(v)
            ms, host_ms = _times(torch, lambda: op.flat(v), 20)
            plain_ms, plain_host_ms = _times(torch, lambda: op.plain(v), 20)
            ggn_ms, ggn_host_ms = _times(torch, lambda: ggn(v), 20)
            macs = _fvp_macs(rows, dims)
            nbytes = (2.0 * rows * (dims[0] + sum(dims[1:-1])) + 4.0 * rows
                      + 4.0 * (2 * flat0.numel() + dims[-1])
                      + 2.0 * sum(a * b for a, b in zip(dims[1:-1],
                                                        dims[2:])))
            bound, by = _bound_ms(2.0 * macs, nbytes, peaks, "bf16_flops")
            design = _k1_bf16_design_bytes(rows, dims, op._plan.splits)
            tflops = 2.0 * macs / ms / 1e9
            gbps = sum(design) / ms / 1e6
            line += (f" kernel_ms={ms:.4f} host_issued_ms={host_ms:.4f} "
                     f"plain_ms={plain_ms:.4f} "
                     f"plain_host_issued_ms={plain_host_ms:.4f} "
                     f"ggn_bf16_ms={ggn_ms:.4f} "
                     f"ggn_bf16_host_issued_ms={ggn_host_ms:.4f} "
                     f"bound_ms={bound:.4f} ({by}: {2.0 * macs / 1e9:.2f} "
                     f"GFLOP at the bf16 tensor rate, {nbytes / 1e6:.1f} MB)"
                     f" share_of_bound={bound / ms:.3f} achieved "
                     f"{tflops:.1f} TFLOP/s, {gbps:.0f} GB/s by design | "
                     f"f32_k1_ms={k1_ms:.4f} | bytes per call by "
                     f"design (model from the shapes): phase A "
                     f"{design[0] / 1e6:.1f} MB, phase B "
                     f"{design[1] / 1e6:.1f} MB, total "
                     f"{sum(design) / 1e6:.1f} MB = "
                     f"{sum(design) / peaks['bytes'] * 1e3:.4f} ms")
            rec = {"max_abs_err": err, "rel_err_plain": rel_plain,
                   "rel_err_vs_f32_k1": rel_f32, "ms": ms,
                   "tflops": tflops, "design_mb": sum(design) / 1e6,
                   "host_issued_ms": host_ms, "plain_ms": plain_ms,
                   "plain_host_issued_ms": plain_host_ms,
                   "bound_ms": bound, "bound_by": by, "library_ms": ggn_ms,
                   "library_host_issued_ms": ggn_host_ms}
            phases, _ = _kernel_phases(torch, lambda: op.flat(v))
            if phases:
                split = {"A": 0.0, "B": 0.0, "other": 0.0}
                for name, _, us in phases:
                    key = ("A" if "phase_a" in name else
                           "B" if ("phase_b" in name or "reduce" in name)
                           else "other")
                    split[key] += us
                print("[fvp-bf16] phases (torch.profiler, device µs per "
                      "call): " + "; ".join(f"{n} x{c:g} = {us:.1f}"
                                            for n, c, us in phases)
                      + f" | phase A (the chain) {split['A']:.1f}, phase B "
                      f"(weight gradients + reduce) {split['B']:.1f}, other "
                      f"{split['other']:.1f}", flush=True)
            del ggn
        print(line, flush=True)
        del op, op32
    _build.reset_launches()
    rec.update(wide)
    _check(rec["ms"] < rec["library_ms"],
           f"K1-bf16 {rec['ms']:.4f} ms is not below the bf16 GGN "
           f"{rec['library_ms']:.4f} ms")
    _check(rec["ms"] < k1_ms,
           f"K1-bf16 {rec['ms']:.4f} ms is not below f32 K1 {k1_ms:.4f} ms")
    return rec


def _finite(torch, value) -> bool:
    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value.float()).all().item())
    return math.isfinite(float(value))


@contextlib.contextmanager
def _updates():
    """Record every TRPO update of every agent built inside (the staged
    update of the overlapped loop too): its launches of K1 and K1-bf16, and its stats' cg_iterations_cheap, cg_iterations
    and solve_fallback (device scalars, read after the run: the recorder
    adds no sync)."""
    import trpo_torch.agent as agent_mod
    from trpo_torch.ops import _build

    real = agent_mod.make_trpo_update
    real_staged = agent_mod.make_staged_trpo_update
    log = []

    def launches():
        return {k: _build.LAUNCHES[k] for k in _FVP_KERNELS}

    def record(before, stats):
        log.append(({k: _build.LAUNCHES[k] - n for k, n in before.items()},
                    stats.cg_iterations_cheap, stats.cg_iterations,
                    stats.solve_fallback))

    def make(policy, cfg):
        update = real(policy, cfg)

        def recorded(*args, **kw):
            before = launches()
            params, stats = update(*args, **kw)
            record(before, stats)
            return params, stats

        return recorded

    def make_staged(policy, cfg):
        """The overlap's (solve, finish): one update spans both calls,
        made in turn by its one learner thread."""
        solve, finish = real_staged(policy, cfg)
        pending = []

        def solve_recorded(*args, **kw):
            pending.append(launches())
            return solve(*args, **kw)

        def finish_recorded(*args, **kw):
            params, stats = finish(*args, **kw)
            record(pending.pop(), stats)
            return params, stats

        return solve_recorded, finish_recorded

    agent_mod.make_trpo_update = make
    agent_mod.make_staged_trpo_update = make_staged
    try:
        yield log
    finally:
        agent_mod.make_trpo_update = real
        agent_mod.make_staged_trpo_update = real_staged


_FVP_KERNELS = ("fused_fvp", "fused_fvp_bf16")


def _exact_fvp_launches(tag, kernel, rows, log, counts) -> None:
    """The fused kernel's launches over a run, exactly. From
    ``trpo._solve_stage``: every update runs its cheap solve on ``kernel``
    (K1, or K1-bf16 on the bf16 rung) unless the ladder is pinned; the
    audit's full solve runs the torch.func GGN. ``ops/cg.py`` calls the
    operator once per CG iteration that takes effect, and the solve calls
    it once more for sᵀFs. So the launches are Σ (cg_iterations + 1) over
    the run's stat rows, except that a row that used the full solution
    (``solve_fallback``; its cg_iterations are the full solve's) counts
    its cheap solve's ``cg_iterations_cheap`` instead, and a pinned
    update's cheap solve (cg_iterations_cheap = -1) counts 0."""
    _check(len(log) == len(rows),
           f"[{tag}] {len(log)} updates recorded for {len(rows)} rows")
    expected = 0
    for i, (row, (launched, cheap, used, fallback)) in enumerate(
            zip(rows, log)):
        cheap = int(cheap)
        _check(int(used) == row["cg_iterations"],
               f"[{tag}] update {i + 1}: the row says {row['cg_iterations']}"
               f" CG iterations, the update {int(used)}")
        if not bool(fallback) and cheap >= 0:
            _check(cheap == row["cg_iterations"],
                   f"[{tag}] update {i + 1}: cheap solve {cheap} iterations,"
                   f" row {row['cg_iterations']}")
        _check(launched[kernel] == cheap + 1,
               f"[{tag}] update {i + 1} launched {kernel} "
               f"{launched[kernel]} times; its cheap solve ran {cheap} "
               "iterations")
        expected += cheap + 1
    _check(counts.get(kernel, 0) == expected,
           f"[{tag}] {kernel} launched {counts.get(kernel, 0)} times, "
           f"expected exactly {expected}")
    print(f"[{tag}] {kernel} launches {expected} = Σ(cg_iterations + 1) "
          f"over {len(rows)} updates (cg_iterations "
          f"{[r['cg_iterations'] for r in rows]}, fallbacks "
          f"{[bool(f) for *_, f in log]})", flush=True)


def _drive(torch, dev, tag, cfg, n_iter, kernel="fused_fvp"):
    """``n_iter`` ``run_iteration`` calls on a fresh agent (seed 0), every
    launch count set to 0 just before and read just after; checks the
    stats, and the launches of ``kernel`` (the cheap operator's fused
    kernel) exactly, or with ``kernel=None`` (a policy the fused kernels
    do not cover) that neither fused kernel ran. Returns (agent, state,
    per-iteration stats, counts)."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.ops import _build

    with _updates() as log:
        agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    rows = []
    torch.cuda.synchronize()
    _build.reset_launches()
    for _ in range(n_iter):
        t0 = time.perf_counter()
        state, stats = agent.run_iteration(state)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        vals = {k: (v.item() if isinstance(v, torch.Tensor) else v)
                for k, v in stats.items()}
        rows.append(vals)
        print(f"[{tag}] iter {state.iteration} ms={ms:.1f} "
              + json.dumps(vals), flush=True)
        episodes = vals["episodes_in_batch"] > 0
        for k, v in vals.items():
            if k in ("mean_episode_reward", "mean_episode_length") \
                    and not episodes:
                continue  # NaN by contract when no episode ended
            if k == "solve_cosine" and not vals["solve_audited"]:
                continue  # NaN by contract on an unaudited update
            _check(_finite(torch, v), f"[{tag}] stat {k} = {v} is not finite")
        _check(vals["kl_old_new"] <= 2 * cfg.max_kl,
               f"[{tag}] kl_old_new {vals['kl_old_new']} > 2·max_kl")
    counts = dict(_build.LAUNCHES)
    print(f"[{tag}] launches over {n_iter} iterations: {counts}", flush=True)
    _check(counts.get("reverse_scan", 0) == n_iter,
           f"[{tag}] reverse scan launched {counts.get('reverse_scan', 0)} "
           f"times over {n_iter} iterations")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[{tag}] a plain version ran: {plain}")
    if kernel is None:
        fused = {k: counts.get(k, 0) for k in _FVP_KERNELS}
        _check(not any(fused.values()),
               f"[{tag}] a fused FVP kernel ran on a GGN path: {fused}")
    else:
        _exact_fvp_launches(tag, kernel, rows, log[:n_iter], counts)
    return agent, state, rows, counts


def phase_main_path(torch, dev):
    """``humanoid-sim`` as published: the audit fires on update 1."""
    from trpo_torch.config import get_preset

    cfg = get_preset("humanoid-sim")
    n_iter = 3
    agent, state, rows, counts = _drive(torch, dev, "main", cfg, n_iter)
    _check(bool(rows[0]["solve_audited"]), "[main] update 1 was not audited")
    _check(math.isfinite(rows[0]["solve_cosine"]),
           f"[main] solve_cosine {rows[0]['solve_cosine']} is not finite")
    print(f"[main] update 1 audit: solve_cosine={rows[0]['solve_cosine']:.6f}"
          f" fallback={rows[0]['solve_fallback']}", flush=True)
    # the next update is unaudited (step 3 of 25); the audited one runs on
    # the ladder advanced to the next audit step
    plain_ms = _stage_breakdown(torch, agent, state, "main", "unaudited")
    # the early exit's saving shows on a solve that converges: update 1's
    # (5 iterations on seed 0), here unaudited with its ladder one step on
    fresh = agent.init_state(seed=0)
    lad = fresh.ladder
    fresh = fresh._replace(ladder=lad._replace(
        step=torch.ones_like(lad.step), step_host=1))
    _cg_cadence(torch, agent, {"update 1 unaudited": fresh,
                               "update 4": state})
    lad = state.ladder
    step = -(-lad.step_host // cfg.solve_audit_every) * cfg.solve_audit_every
    audited = state._replace(ladder=lad._replace(
        step=torch.full_like(lad.step, step), step_host=step))
    audit_ms = _stage_breakdown(torch, agent, audited, "main", "audited")
    return counts, {"unaudited": plain_ms, "audited": audit_ms}, (agent, state)


def _cg_cadence(torch, agent, states) -> None:
    """The unaudited update's policy phase (GAE and the update) with the
    CG's exit mask read by the host every k iterations
    (``ops/cg.CHECK_EVERY``): k = 0, the masked loop that always runs 10
    iterations (the CG before its early exit), against k = 1 (the
    default) and k = 2, in the order 0, 1, 2, 2, 1, 0, from each of
    ``states`` (label -> state) on one rollout window each: the host-clock
    median of 7 runs of the phase, and one more under the profiler for K1's
    launches and device time."""
    from trpo_torch.ops import _build, cg
    from trpo_torch.rollout import device_rollout

    for label, state in states.items():
        _, traj = device_rollout(agent.env, agent.policy,
                                 state.policy_params, state.env_carry,
                                 state.rng, agent.n_steps)
        agent._policy_phase(state, traj)  # warm-up
        runs = {}
        try:
            for k in (0, 1, 2, 2, 1, 0):
                cg.CHECK_EVERY = k
                ms = []
                for _ in range(7):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    agent._policy_phase(state, traj)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                before = _build.LAUNCHES["fused_fvp"]
                _, launches = _kernel_phases(
                    torch, lambda: agent._policy_phase(state, traj), reps=1)
                runs.setdefault(k, []).append({
                    "ms": sorted(ms)[3],
                    "k1": (_build.LAUNCHES["fused_fvp"] - before) // 2,
                    "k1_device": sum(us for n, us in launches
                                     if n.startswith("fvp")) / 1e3,
                    "device": sum(us for _, us in launches) / 1e3})
        finally:
            cg.CHECK_EVERY = 1

        def line(k):
            mean = {key: sum(r[key] for r in runs[k]) / len(runs[k])
                    for key in runs[k][0]}
            passes = ", ".join(f"{r['ms']:.2f}" for r in runs[k])
            return (f"k={k}{' (masked, no early exit)' if k == 0 else ''}: "
                    f"K1 launches {runs[k][0]['k1']}, K1 device ms "
                    f"{mean['k1_device']:.3f}, policy phase ms "
                    f"{mean['ms']:.2f} (passes {passes}), device idle "
                    f"{1.0 - mean['device'] / mean['ms']:.2f}")

        print(f"[main] CG exit read every k iterations, {label} (order 0, "
              "1, 2, 2, 1, 0; policy phase = GAE + the unaudited update, "
              "median of 7, mean of the two passes): "
              + "; ".join(line(k) for k in (0, 1, 2)), flush=True)


def phase_bf16(torch, dev, main_run):
    """``humanoid-sim`` on the ladder's bf16 rung: the cheap solve runs on
    K1-bf16, the audit on the f32 ``torch.func`` GGN. Its unaudited update
    is then timed against ``[main]``'s (``main_run``: that path's agent and
    state) in the order main, bf16, bf16, main: the host clock drifts over
    a process, and the update is host-bound."""
    from trpo_torch.config import get_preset

    cfg = get_preset("humanoid-sim").replace(fvp_dtype="bf16")
    n_iter = 3
    agent, state, rows, counts = _drive(torch, dev, "bf16", cfg, n_iter,
                                        kernel="fused_fvp_bf16")
    print(f"[bf16] update 1 audit: solve_cosine={rows[0]['solve_cosine']:.6f}"
          f" fallback={rows[0]['solve_fallback']} (floor "
          f"{cfg.solve_cosine_floor})", flush=True)
    _check(counts.get("fused_fvp", 0) == 0,
           f"[bf16] f32 K1 ran in the cheap solve: {counts}")
    runs = [("main", *main_run), ("bf16", agent, state)]
    update = {"main": [], "bf16": []}
    for tag, run_agent, run_state in runs + runs[::-1]:
        update[tag].append(_stage_breakdown(
            torch, run_agent, run_state, tag, "unaudited")["update"])
    mean = {k: sum(v) / len(v) for k, v in update.items()}
    print(f"[bf16] unaudited update ms in the order main, bf16, bf16, main:"
          f" bf16 {mean['bf16']:.1f} (medians "
          f"{', '.join(f'{x:.1f}' for x in update['bf16'])}) against main "
          f"{mean['main']:.1f} (medians "
          f"{', '.join(f'{x:.1f}' for x in update['main'])})", flush=True)
    return counts


def phase_fleet(torch, dev, main_stages):
    """``humanoid-sim-fleet`` as published: 1,024 envs, 49-step windows,
    rollout in 7-step chunks."""
    from trpo_torch.config import get_preset

    cfg = get_preset("humanoid-sim-fleet")
    agent, state, _, counts = _drive(torch, dev, "fleet", cfg, 2)
    _check(agent.n_envs == 1024 and agent.n_steps == 49,
           f"[fleet] window {agent.n_steps}x{agent.n_envs}")
    stages = _stage_breakdown(torch, agent, state, "fleet", "")
    print(f"[fleet] rollout {agent.n_steps}x{agent.n_envs} "
          f"ms={stages['rollout']:.1f} against the 391x128 rollout "
          f"ms={main_stages['unaudited']['rollout']:.1f}", flush=True)
    return counts


def phase_cartpole(torch, dev):
    from trpo_torch.config import get_preset

    counts = {}
    for name in ("cartpole", "cartpole-fleet"):
        counts = _add(counts, _drive(torch, dev, "cartpole",
                                     get_preset(name), 2, kernel=None)[3])
    return counts


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _stage_breakdown(torch, agent, state, tag, label, reps: int = 3):
    """One more iteration, stage by stage, each stage ended by a
    synchronize: where the iteration's wall time goes (host clock). The
    same iteration runs ``reps`` times from the same state, and each stage
    reads the median: one host-clock sample spreads by several ms on a
    shared host, as much as the update's kernels differ between rungs.
    Then one more policy phase (GAE + update) under the profiler: the
    device time of its kernels, against the phase's median host time,
    gives the device's idle share there."""
    from trpo_torch.ops import _build
    from trpo_torch.rollout import device_rollout

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    samples = []
    for _ in range(reps):
        (carry, traj), roll_ms = timed(lambda: device_rollout(
            agent.env, agent.policy, state.policy_params, state.env_carry,
            state.rng, agent.n_steps, chunk=agent.cfg.rollout_chunk))
        st = state._replace(env_carry=carry)
        _, gae_ms = timed(lambda: agent._advantages(st.vf_state, traj))
        (st, pack), policy_ms = timed(lambda: agent._policy_phase(st, traj))
        _, vf_ms = timed(lambda: agent._vf_stats_phase(st.vf_state, pack))
        samples.append({"rollout": roll_ms, "gae": gae_ms,
                        "update": policy_ms - gae_ms, "policy": policy_ms,
                        "vf_fit": vf_ms})
    med = {k: sorted(x[k] for x in samples)[reps // 2] for k in samples[0]}
    st = state._replace(env_carry=carry)
    before = _build.LAUNCHES["fused_fvp"]
    _, launches = _kernel_phases(
        torch, lambda: agent._policy_phase(st, traj), reps=1)
    # _kernel_phases runs the phase twice (a warm-up, then the profiled one)
    med["k1_launches"] = (_build.LAUNCHES["fused_fvp"] - before) // 2
    med["policy_device"] = sum(us for _, us in launches) / 1e3
    med["k1_device"] = sum(us for name, us in launches
                           if name.startswith("fvp")) / 1e3
    updates = ", ".join(f"{x['update']:.1f}" for x in samples)
    print(f"[{tag}] stage ms{' (' + label + ' update)' if label else ''}, "
          f"median of {reps}: rollout={med['rollout']:.1f} "
          f"gae={med['gae']:.2f} update≈{med['update']:.1f} "
          f"(runs: {updates}) vf_fit+stats={med['vf_fit']:.1f} | policy "
          f"phase {med['policy']:.1f}, its kernels' device time "
          f"{med['policy_device']:.1f} (profiler), device idle "
          f"{1.0 - med['policy_device'] / med['policy']:.2f}", flush=True)
    return med


def phase_small_reference(torch, dev):
    """One update on the same small trajectory, on the card (kernels) and
    on the CPU (plain versions), with the preset's audit armed (update 1
    is audited): the new params must agree."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops.flat import flatten_params, tree_map
    from trpo_torch.rollout import device_rollout

    cfg = get_preset("humanoid-sim").replace(
        n_envs=8, batch_timesteps=512, policy_hidden=(32, 48))
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
          f"gpu={st_gpu['kl_old_new'].item():.6g} audit cosine cpu="
          f"{st_cpu['solve_cosine'].item():.6f} gpu="
          f"{st_gpu['solve_cosine'].item():.6f}", flush=True)
    _check(bool(st_gpu["solve_audited"]) and bool(st_cpu["solve_audited"]),
           "[small] the update was not audited")
    _check(bool(st_gpu["solve_fallback"]) == bool(st_cpu["solve_fallback"]),
           "[small] card and CPU audits disagree")
    # CG amplifies f32 roundoff between the two operators' sum orders
    _check(rel < 1e-4, f"card vs CPU params rel err {rel}")
    _check(kl_gap < 1e-4, f"card vs CPU kl gap {kl_gap}")


ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"   # .gitignore lists build/


def _state_diff(torch, a, b) -> list:
    """Paths of the leaves where two states differ (NaN equals NaN; the
    rollout generator by its state bytes)."""
    from trpo_torch.ops.flat import tree_leaves

    def leaves(state):
        return [x.get_state() if isinstance(x, torch.Generator) else x
                for x in tree_leaves(state)]

    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return [f"leaf count {len(la)} != {len(lb)}"]
    bad = []
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            same = x.dtype == y.dtype and x.shape == y.shape and (
                torch.equal(x, y) or (x.is_floating_point() and torch.equal(
                    torch.isnan(x), torch.isnan(y)) and torch.equal(
                        torch.nan_to_num(x), torch.nan_to_num(y))))
            if not same:
                err = ((x.double() - y.double()).abs().max().item()
                       if x.shape == y.shape else float("nan"))
                bad.append(f"leaf {i} {tuple(x.shape)} max|diff|={err:.3e}")
        elif x != y:
            bad.append(f"leaf {i}: {x!r} != {y!r}")
    return bad


def _main_quiet(argv) -> tuple:
    """``trpo_torch.train.main(argv)`` with its stdout captured: (exit
    code, the lines a reader needs)."""
    from trpo_torch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = train.main(argv)
    keep = [line for line in buf.getvalue().splitlines()
            if line.startswith(("trpo_torch:", "resumed from", "iter ",
                                "done:", "greedy eval:", "preempted"))]
    return code, keep


def phase_learn(torch, dev):
    """``humanoid-sim`` through ``train.main``: 4 iterations, then a
    resumed run from step 2 that must land on the same state."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.ops.flat import tree_leaves
    from trpo_torch.resilience.recovery import copy_state
    from trpo_torch.utils.checkpoint import Checkpointer
    from trpo_torch.utils.metrics import StatsLogger

    work = WORK / "learn"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck_a, ck_b = work / "a", work / "b"
    base = ["--preset", "humanoid-sim", "--device", str(dev),
            "--checkpoint-every", "2"]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with _updates() as log:
        code, lines = _main_quiet(base + [
            "--iterations", "4", "--checkpoint-dir", str(ck_a),
            "--log-jsonl", str(work / "a.jsonl"), "--evaluate", "500"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    for line in lines:
        print(f"[learn] {line}", flush=True)
    _check(code == 0, f"[learn] train.main exited {code}")
    rows_a = [json.loads(x) for x in
              (work / "a.jsonl").read_text().splitlines()]
    print(f"[learn] launches during learn (4 iterations + eval, {wall:.1f} s"
          f"): {counts}; JSONL rows {len(rows_a)}; per-iteration ms "
          f"{[round(r['iteration_ms'], 1) for r in rows_a]}", flush=True)
    _check([r["iteration"] for r in rows_a] == [1, 2, 3, 4],
           f"[learn] JSONL iterations {[r['iteration'] for r in rows_a]}")
    # exact, from the JSONL rows (see _exact_fvp_launches)
    _exact_fvp_launches("learn", "fused_fvp", rows_a, log, counts)
    _check(counts.get("reverse_scan", 0) == 4,
           f"[learn] K2 launched {counts.get('reverse_scan', 0)} times")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[learn] a plain version ran: {plain}")
    _check(any(line.startswith("greedy eval:") for line in lines),
           "[learn] no greedy eval line")
    _check(Checkpointer(str(ck_a)).all_steps() == [2, 4],
           f"[learn] steps {Checkpointer(str(ck_a)).all_steps()}")

    # the second run starts from a directory that holds step 2 only
    ck_b.mkdir()
    shutil.copytree(ck_a / "step_2", ck_b / "step_2")
    for name in ("step_2.complete", ".markers_enabled"):
        shutil.copy(ck_a / name, ck_b / name)
    code, lines = _main_quiet(base + [
        "--iterations", "2", "--checkpoint-dir", str(ck_b), "--resume",
        "--log-jsonl", str(work / "b.jsonl")])
    for line in lines:
        print(f"[learn] resumed run: {line}", flush=True)
    _check(code == 0 and "resumed from step 2" in lines,
           f"[learn] the resumed run exited {code}: {lines}")

    cfg = get_preset("humanoid-sim")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final_a = Checkpointer(str(ck_a)).restore(agent.init_state())
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    final_b = Checkpointer(str(ck_b)).restore(agent.init_state())
    diff = _state_diff(torch, final_a, final_b)
    rows_b = [json.loads(x) for x in
              (work / "b.jsonl").read_text().splitlines()]
    clock = ("time_elapsed_min", "iteration_ms", "reward_running")
    row_diff = [
        (ra["iteration"], k) for ra, rb in zip(rows_a[2:], rows_b)
        for k in ra if k not in clock and ra[k] != rb[k]
        and not (ra[k] != ra[k] and rb[k] != rb[k])]
    print(f"[learn] resume from step 2 against the uninterrupted run at "
          f"step 4: {'bitwise equal' if not diff else diff} over "
          f"{len(tree_leaves(final_a))} leaves; rows 3-4 "
          f"{'equal' if not row_diff else row_diff}", flush=True)
    _check(not diff, f"[learn] resumed state differs: {diff}")
    _check(len(rows_b) == 2 and not row_diff,
           f"[learn] resumed rows differ: {row_diff}")

    t0 = time.perf_counter()
    Checkpointer(str(work / "timing")).save(4, final_a)
    save_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(work / "timing" / "step_4" / "tensors.pt")

    # learn's iteration against a bare run_iteration, from one state, in
    # the order bare, learn, learn, bare (the host clock drifts)
    def bare():
        st = copy_state(final_a)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(2):
            st, _ = agent.run_iteration(st)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / 2

    every = TRPOAgent(cfg.env, cfg.replace(checkpoint_every=1), device=dev)

    def learned(tag):
        st = copy_state(final_a)
        ck = Checkpointer(str(work / f"cadence_{tag}"))
        logger = StatsLogger(jsonl_path=str(work / f"cadence_{tag}.jsonl"),
                             stream=io.StringIO())
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            every.learn(n_iterations=2, state=st, logger=logger,
                        checkpointer=ck)
        finally:
            logger.close()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / 2

    times = [bare(), learned("1"), learned("2"), bare()]
    print(f"[learn] checkpoint of the flagship state ({nbytes / 1e6:.2f} MB "
          f"of tensors): save {save_ms:.1f} ms, restore {restore_ms:.1f} ms"
          f" | iteration ms, bare run_iteration against learn() with JSONL "
          f"and a checkpoint every iteration (bare, learn, learn, bare): "
          f"{', '.join(f'{x:.1f}' for x in times)}; learn adds "
          f"{(times[1] + times[2] - times[0] - times[3]) / 2:.1f} ms",
          flush=True)
    for preset in ("cartpole", "cartpole-po", "pong-sim"):
        _resume_leg(torch, dev, preset)
    return counts


def _resume_leg(torch, dev, preset) -> None:
    """``preset`` as published through ``train.main``: 2 iterations with a
    checkpoint at each, then a run resumed from a copy of step 1 for 1
    iteration; its step-2 state must equal the first run's, every leaf
    bitwise (the categorical head's gather backward, the recurrent carry
    (h, prev_done), cuDNN's convolutions)."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops.flat import tree_leaves
    from trpo_torch.utils.checkpoint import Checkpointer

    work = WORK / f"resume_{preset}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    a, b = work / "a", work / "b"
    base = ["--preset", preset, "--device", str(dev), "--checkpoint-every",
            "1"]
    t0 = time.perf_counter()
    code, _ = _main_quiet(base + ["--iterations", "2", "--checkpoint-dir",
                                  str(a)])
    _check(code == 0, f"[learn] {preset}: train.main exited {code}")
    b.mkdir()
    shutil.copytree(a / "step_1", b / "step_1")
    for name in ("step_1.complete", ".markers_enabled"):
        shutil.copy(a / name, b / name)
    code, lines = _main_quiet(base + ["--iterations", "1", "--resume",
                                      "--checkpoint-dir", str(b)])
    _check(code == 0 and "resumed from step 1" in lines,
           f"[learn] {preset}: the resumed run exited {code}: {lines}")
    cfg = get_preset(preset)
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    want = Checkpointer(str(a)).restore(agent.init_state(), step=2)
    got = Checkpointer(str(b)).restore(agent.init_state(), step=2)
    diff = _state_diff(torch, want, got)
    print(f"[learn] {preset} resumed from step 1 against the uninterrupted "
          f"run at step 2: {'bitwise equal' if not diff else diff} over "
          f"{len(tree_leaves(want))} leaves "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _check(not diff, f"[learn] {preset}: resumed state differs: {diff}")


def phase_norm(torch, dev):
    """``halfcheetah-sim`` with running observation normalization: the
    update replays normalized observations through the raw policy, so it
    must still launch K1."""
    from trpo_torch.config import get_preset

    cfg = get_preset("halfcheetah-sim").replace(normalize_obs=True)
    agent, state, _, counts = _drive(torch, dev, "norm", cfg, 2)
    stats = state.obs_norm
    batch = agent.n_steps * agent.n_envs
    _check(float(stats.count) == 2 * batch,
           f"[norm] obs_norm count {float(stats.count)} != {2 * batch}")
    finite = all(bool(torch.isfinite(t).all()) for t in stats)
    _check(finite, "[norm] obs_norm statistics are not finite")
    std = torch.sqrt(stats.m2 / stats.count)
    print(f"[norm] obs_norm after 2 iterations: count {float(stats.count):g}"
          f", |mean| max {stats.mean.abs().max().item():.4g}, std range "
          f"[{std.min().item():.4g}, {std.max().item():.4g}]", flush=True)
    return counts


def _device_busy_ms(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: (ms the device ran anything, as
    the union of its kernel and copy intervals over every stream; the sum
    of those intervals). The sum above the union is work that ran
    concurrently on two streams."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    union = total = 0.0
    end = None
    for a, b in spans:
        total += b - a
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    return union / 1e3, total / 1e3


def _serial_iters(torch, agent, state, n, cpu=None):
    """``n`` serial iterations, each ended by a synchronize: (state, ms
    of each); with ``cpu`` (a dict), the calling thread's CPU ms of each
    under ``cpu["serial"]``."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        state, _ = agent.run_iteration(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if cpu is not None:
            cpu.setdefault("serial", []).append(
                (time.thread_time() - c0) * 1e3)
    return state, ms


@contextlib.contextmanager
def _thread_cpu(agent, names, cpu):
    """Wrap the agent's methods ``names`` so that each call adds the CPU ms
    of the thread it ran on to ``cpu[name]``."""
    def wrap(name):
        real = getattr(agent, name)

        def timed(*args, **kw):
            c0 = time.thread_time()
            try:
                return real(*args, **kw)
            finally:
                cpu.setdefault(name, []).append(
                    (time.thread_time() - c0) * 1e3)
        return timed

    for name in names:
        setattr(agent, name, wrap(name))
    try:
        yield
    finally:
        for name in names:
            delattr(agent, name)


def _overlap_iters(torch, agent, state, n, timer=None, cpu=None):
    """``n`` overlapped iterations: (state, ms of each, from the learner's
    submission to its join, the next window collected meanwhile); with
    ``cpu`` (a dict), each learner step's and each window's thread CPU ms
    under their method names."""
    ms = []

    def on_row(k, st, row, iter_ms):
        ms.append(iter_ms)
        return False

    torch.cuda.synchronize()
    with (_thread_cpu(agent, ("_overlap_learner_step", "_overlap_collect"),
                      cpu) if cpu is not None else contextlib.nullcontext()):
        state, _ = agent._overlap_run(state, n, timer=timer, on_row=on_row)
    torch.cuda.synchronize()
    return state, ms


def phase_overlap(torch, dev):
    """Queue 1 item 15: ``humanoid-sim-fleet`` as published with
    ``train_overlap=1``. (a) one overlapped iteration against one serial
    one from seed 0, bitwise on every state leaf; (b) 4 overlapped
    iterations with K1 exactly Σ(cg_iterations + 1), K2 once an
    iteration, no plain version, and every stale update's KL within
    1.5·max_kl; (c) iteration ms and the device's idle share, serial
    against overlapped in the order serial, overlap, overlap, serial
    (median of the 3 iterations after one warm-up, each leg from seed 0;
    the device's busy time from 2 more iterations of each under the
    profiler, from (b)'s state), with the learner's stage times; (d)
    ``train.main --overlap``, 2 iterations with a checkpoint at 2, then 1
    more resumed from it."""
    from trpo_torch.agent import TRPOAgent, _host_rows
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.resilience.recovery import copy_state
    from trpo_torch.utils.timers import PhaseTimer

    cfg = get_preset("humanoid-sim-fleet")
    serial = TRPOAgent(cfg.env, cfg, device=dev)
    with _updates() as log:
        over = TRPOAgent(cfg.env, cfg.replace(train_overlap=1), device=dev)
    _check(over.n_envs == 1024 and over.n_steps == 49,
           f"[overlap] window {over.n_steps}x{over.n_envs}")

    # (a) the fill window is the plain synchronous batch
    want, _ = serial.run_iterations(serial.init_state(seed=0), 1)
    got, _ = over.run_iterations(over.init_state(seed=0), 1)
    torch.cuda.synchronize()
    diff = _state_diff(torch, want, got)
    print(f"[overlap] one overlapped iteration against one serial from seed"
          f" 0: {'bitwise equal' if not diff else diff}", flush=True)
    _check(not diff, f"[overlap] first iteration differs: {diff}")

    # (b) the main path, its launches counted
    n_iter = 4
    del log[:]
    torch.cuda.synchronize()
    _build.reset_launches()
    state, stack = over.run_iterations(over.init_state(seed=0), n_iter)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    rows = _host_rows(stack)
    for i, row in enumerate(rows):
        print(f"[overlap] iter {i + 1} {'stale' if i else 'fill'} "
              + json.dumps(row), flush=True)
        for k, v in row.items():
            if k in ("mean_episode_reward", "mean_episode_length") \
                    and not row["episodes_in_batch"]:
                continue
            if k == "solve_cosine" and not row["solve_audited"]:
                continue
            _check(math.isfinite(v), f"[overlap] stat {k} = {v}")
    print(f"[overlap] launches over {n_iter} iterations: {counts}",
          flush=True)
    _check(counts.get("reverse_scan", 0) == n_iter,
           f"[overlap] reverse scan launched {counts.get('reverse_scan', 0)}"
           f" times over {n_iter} iterations")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[overlap] a plain version ran: {plain}")
    _check(counts.get("fused_fvp_bf16", 0) == 0,
           f"[overlap] K1-bf16 ran: {counts}")
    _exact_fvp_launches("overlap", "fused_fvp", rows, log, counts)
    kl = [r["kl_old_new"] for r in rows[1:]]
    print(f"[overlap] stale updates' kl_old_new {kl} against 1.5·max_kl = "
          f"{1.5 * cfg.max_kl:g}", flush=True)
    _check(all(x <= 1.5 * cfg.max_kl for x in kl),
           f"[overlap] a stale update's kl_old_new {kl} > 1.5·max_kl")
    _check(state.iteration == n_iter
           and state.total_timesteps == n_iter * 49 * 1024,
           f"[overlap] accounting: {state.iteration} iterations, "
           f"{state.total_timesteps} timesteps")

    # (c) serial against overlapped
    legs = {"serial": [], "overlap": []}
    timer, cpu = PhaseTimer(), {}
    for tag in ("serial", "overlap", "overlap", "serial"):
        if tag == "serial":
            _, ms = _serial_iters(torch, serial, serial.init_state(seed=0), 4,
                                  cpu)
            del cpu["serial"][-4]  # the warm-up
        else:
            _, ms = _overlap_iters(torch, over, over.init_state(seed=0), 4,
                                   timer, cpu)
        legs[tag].append(sorted(ms[1:])[1])
    # the same work on each side: 2 windows and 2 unaudited updates
    busy = {
        "serial": _device_busy_ms(torch, lambda: _serial_iters(
            torch, serial, copy_state(state), 2)),
        "overlap": _device_busy_ms(torch, lambda: _overlap_iters(
            torch, over, copy_state(state), 2)),
    }
    card = _card_line()
    for tag in ("serial", "overlap"):
        med = sum(legs[tag]) / len(legs[tag])
        union, total = busy[tag]
        print(f"[overlap] {tag}: iteration ms {med:.1f} (medians "
              f"{', '.join(f'{x:.1f}' for x in legs[tag])}), device busy "
              f"{union / 2:.1f} ms an iteration (kernel sum {total / 2:.1f}"
              f"), idle {1.0 - union / 2 / med:.2f} ({card})", flush=True)
    med_cpu = {k: sorted(v)[len(v) // 2] for k, v in cpu.items()}
    print(f"[overlap] thread CPU ms (median of calls; the card machine's "
          f"thread clock ticks coarsely): serial iteration "
          f"{med_cpu['serial']:.1f} on its one thread; overlap: learner step "
          f"{med_cpu['_overlap_learner_step']:.1f} on the learner thread, "
          f"window {med_cpu['_overlap_collect']:.1f} on the calling thread",
          flush=True)
    summary = timer.summary()
    stages = ", ".join(
        f"{name} {summary[name]['mean_ms']:.2f}"
        for name in ("update", "update/advantage", "update/fvp_cg_solve",
                     "update/linesearch", "update/vf_fit", "rollout_chunk")
        if name in summary)
    print(f"[overlap] learner stage ms (mean over both overlap legs, each "
          f"stage ended on the learner's stream): {stages}; chunks of "
          f"{cfg.rollout_chunk} steps on the actor's stream", flush=True)
    return _add(counts, _overlap_cli(torch, dev))


def _overlap_cli(torch, dev) -> dict:
    """``train.main --overlap`` on ``humanoid-sim-fleet``: 2 iterations with
    a checkpoint at 2, K1 and K2 counted exactly, then 1 iteration resumed
    from the checkpoint (a fresh fill window)."""
    from trpo_torch.ops import _build

    work = WORK / "overlap"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = ["--preset", "humanoid-sim-fleet", "--overlap", "--device",
            str(dev), "--checkpoint-dir", str(work / "ck"),
            "--checkpoint-every", "2"]
    torch.cuda.synchronize()
    _build.reset_launches()
    with _updates() as log:
        code, lines = _main_quiet(base + [
            "--iterations", "2", "--log-jsonl", str(work / "a.jsonl")])
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    for line in lines:
        print(f"[overlap] {line}", flush=True)
    _check(code == 0, f"[overlap] train.main --overlap exited {code}")
    rows = [json.loads(x) for x in
            (work / "a.jsonl").read_text().splitlines()]
    _check([r["iteration"] for r in rows] == [1, 2],
           f"[overlap] JSONL iterations {[r['iteration'] for r in rows]}")
    _exact_fvp_launches("overlap", "fused_fvp", rows, log, counts)
    _check(counts.get("reverse_scan", 0) == 2,
           f"[overlap] K2 launched {counts.get('reverse_scan', 0)} times")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[overlap] a plain version ran: {plain}")
    code, lines = _main_quiet(base + ["--iterations", "1", "--resume"])
    for line in lines:
        print(f"[overlap] resumed: {line}", flush=True)
    _check(code == 0 and any(x.startswith("resumed from step 2")
                             for x in lines)
           and any(x.startswith("done: 3 iterations") for x in lines),
           f"[overlap] the resumed train.main --overlap: {code} {lines}")
    return counts


def phase_population(torch, dev):
    """8 members of ``humanoid-sim`` as published (the reference's
    evidence row, ``scripts/population_row_r04.py``), 2 lockstep
    iterations: K1 exactly Σ(cg_iterations + 1) over every member's
    updates, K2 16 times; member 5 bitwise equal to a solo run of seed 5;
    member-updates/s and env-steps/s beside 8 × a solo iteration."""
    from trpo_torch.agent import TRPOAgent, _host_rows
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.population import Population
    from trpo_torch.resilience.recovery import copy_state

    cfg = get_preset("humanoid-sim")
    members, n_iter = 8, 2
    with _updates() as log:
        agent = TRPOAgent(cfg.env, cfg, device=dev)
    pop = Population(agent, seeds=range(members))
    torch.cuda.synchronize()
    _build.reset_launches()
    steps, pop_ms = [], []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        steps.append(pop.run_iteration())
        torch.cuda.synchronize()
        pop_ms.append((time.perf_counter() - t0) * 1e3)
    counts = dict(_build.LAUNCHES)
    # rows in the order the updates ran: iteration-major, then member
    rows = _host_rows({k: torch.stack([s[k] for s in steps]).reshape(-1)
                       for k in steps[0]})
    print(f"[population] launches over {n_iter} iterations of {members} "
          f"members: {counts}", flush=True)
    _check(counts.get("reverse_scan", 0) == members * n_iter,
           f"[population] reverse scan launched "
           f"{counts.get('reverse_scan', 0)} times")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[population] a plain version ran: {plain}")
    _exact_fvp_launches("population", "fused_fvp", rows, log, counts)
    for i, row in enumerate(rows):
        _check(math.isfinite(row["entropy"])
               and row["kl_old_new"] <= 2 * cfg.max_kl,
               f"[population] update {i + 1}: {row}")
    scores = pop.member_scores({k: torch.stack([s[k] for s in steps], dim=1)
                                for k in steps[0]})
    print(f"[population] member scores after {n_iter} iterations: "
          f"{[round(float(x), 3) for x in scores]}, best member "
          f"{int(torch.argmax(scores))}", flush=True)

    solo, solo_ms = _serial_iters(torch, agent, agent.init_state(seed=5),
                                  n_iter)
    diff = _state_diff(torch, pop.member_state(5), solo)
    print(f"[population] member 5 against a solo run of seed 5 after "
          f"{n_iter} iterations: {'bitwise equal' if not diff else diff}",
          flush=True)
    _check(not diff, f"[population] member 5 differs: {diff}")
    # the members step one after another, so the population's device time
    # is the sum of theirs: one member's next iteration under the profiler
    # (the whole population's would take the profiler minutes)
    union, total = _device_busy_ms(
        torch, lambda: agent.run_iteration(copy_state(pop.member_state(0))))
    steps_per_member = agent.n_steps * agent.n_envs
    print(f"[population] iteration ms {', '.join(f'{x:.1f}' for x in pop_ms)}"
          f" (update 1 audited) against 8 × the solo iteration "
          f"{', '.join(f'{8 * x:.1f}' for x in solo_ms)}; at iteration 2: "
          f"{members / pop_ms[-1] * 1e3:.2f} member-updates/s, "
          f"{members * steps_per_member / pop_ms[-1] * 1e3:.0f} env-steps/s;"
          f" member 0's iteration 3: device busy {union:.1f} ms (kernel sum "
          f"{total:.1f}), idle {1.0 - members * union / pop_ms[-1]:.2f} "
          f"against an eighth of iteration 2's ms ({_card_line()})",
          flush=True)
    return counts


def _host_build_lines(torch) -> None:
    """[build]: the C++ toolchain, the native library under build/, the
    host's cores, and the gym: family's refusal on this machine."""
    from trpo_torch import envs
    from trpo_torch.envs import native_build

    info = native_build.compiler_info()
    t0 = time.perf_counter()
    lib = native_build.build()
    print(f"[build] native envs: {info['cxx']} (CXX="
          f"{os.environ.get('CXX', 'unset')}), {info['version']}; OpenMP "
          f"probed (-fopenmp builds); {lib} in "
          f"{time.perf_counter() - t0:.1f} s; host cores {os.cpu_count()}, "
          f"OMP_NUM_THREADS={os.environ.get('OMP_NUM_THREADS', 'unset')}",
          flush=True)
    _check(lib.parent.parent == ROOT / "build" / "trpo_torch_native",
           f"[build] the native library is not under build/: {lib}")
    import importlib.util

    if importlib.util.find_spec("gymnasium") is None:
        try:
            envs.make("gym:HalfCheetah-v4", n_envs=1)
        except ImportError as e:
            _check("gymnasium is required" in str(e),
                   f"[build] gym: refused with another error: {e}")
            print(f"[build] gym: is not driven on this machine: "
                  f"make('gym:HalfCheetah-v4') raises {e!r}", flush=True)
        else:
            raise SmokeFailure("[build] gym: constructed without gymnasium")
    else:
        print("[build] gymnasium is importable here; gym: is still not "
              "driven by this smoke", flush=True)


def _host_physics(torch, np, dev) -> None:
    """native:cartpole and native:pendulum step for step against the
    device CartPole/Pendulum on the card, from the same states, on the
    same actions, at the reference's tolerances."""
    from trpo_torch.envs.cartpole import CartPole, CartPoleState
    from trpo_torch.envs.native import NativeVecEnv
    from trpo_torch.envs.pendulum import Pendulum, PendulumState

    n, steps = 4096, 20
    rng = np.random.default_rng(0)
    errs = {"cartpole": 0.0, "pendulum": 0.0}
    for kind, cls, tol in (("cartpole", CartPole, (1e-5, 1e-6)),
                           ("pendulum", Pendulum, (1e-4, 1e-5))):
        env = NativeVecEnv(kind, n_envs=n, seed=1, max_episode_steps=10 ** 9)
        dev_env = cls(max_episode_steps=10 ** 9, device=dev)
        for _ in range(steps):
            s = torch.as_tensor(env._state.copy(), device=dev)
            zero = torch.zeros(n, dtype=torch.int32, device=dev)
            if kind == "cartpole":
                a = rng.integers(0, 2, size=n).astype(np.int32)
                st = CartPoleState(s[:, 0], s[:, 1], s[:, 2], s[:, 3], zero)
                act = torch.as_tensor(a, device=dev)
            else:
                a = rng.uniform(-3, 3, size=n).astype(np.float32)
                st = PendulumState(s[:, 0], s[:, 1], zero)
                act = torch.as_tensor(a, device=dev)[:, None]
            _, rew, term, _, final_obs = env.host_step(a)
            _, obs, r, dterm, _ = dev_env.step(st, act)
            obs, r, dterm = obs.cpu().numpy(), r.cpu().numpy(), \
                dterm.cpu().numpy()
            close = np.allclose(final_obs, obs, rtol=tol[0], atol=tol[1]) \
                and np.allclose(rew, r, rtol=tol[0], atol=tol[1])
            _check(close, f"[host] native:{kind} disagrees with the card")
            _check(np.array_equal(term, dterm),
                   f"[host] native:{kind} terminations differ")
            errs[kind] = max(errs[kind], float(np.abs(final_obs - obs).max()))
    print(f"[host] physics, {steps} steps x {n} envs on the same actions: "
          f"native vs device max |obs err| cartpole {errs['cartpole']:.3e} "
          f"(rtol 1e-5, atol 1e-6, terminations equal), pendulum "
          f"{errs['pendulum']:.3e} (rtol 1e-4, atol 1e-5)", flush=True)


def _host_stage_breakdown(torch, agent, state, tag, reps: int = 3):
    """The host iteration stage by stage (median of ``reps`` from one
    state): rollout (host stepping + per-step inference), GAE, the update,
    the critic fit; then the policy phase under the profiler for the
    device's idle share there."""
    from trpo_torch.ops import _build

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    snap = agent.snapshot_host_env()
    samples = []
    for _ in range(reps):
        agent.restore_host_env(snap)
        (st, traj), roll_ms = timed(lambda: agent._host_collect(state))
        _, gae_ms = timed(lambda: agent._advantages(st.vf_state, traj))
        (st2, pack), policy_ms = timed(lambda: agent._policy_phase(st, traj))
        _, vf_ms = timed(lambda: agent._vf_stats_phase(st2.vf_state, pack))
        samples.append({"rollout": roll_ms, "gae": gae_ms,
                        "update": policy_ms - gae_ms, "policy": policy_ms,
                        "vf_fit": vf_ms})
    med = {k: sorted(x[k] for x in samples)[reps // 2] for k in samples[0]}
    _, launches = _kernel_phases(
        torch, lambda: agent._policy_phase(st, traj), reps=1)
    med["policy_device"] = sum(us for _, us in launches) / 1e3
    med["idle"] = 1.0 - med["policy_device"] / med["policy"]
    print(f"[{tag}] stage ms, median of {reps} ({agent.n_steps}x"
          f"{agent.n_envs} window): rollout={med['rollout']:.1f} "
          f"gae={med['gae']:.2f} update={med['update']:.1f} "
          f"vf_fit+stats={med['vf_fit']:.1f} | policy phase "
          f"{med['policy']:.1f}, its kernels' device time "
          f"{med['policy_device']:.2f} (profiler), device idle "
          f"{med['idle']:.2f}", flush=True)
    agent.restore_host_env(snap)
    return med


def _host_rollout_ms(torch, agent, state, reps: int = 3) -> float:
    """Median ms of ``agent._host_collect`` from one env snapshot."""
    snap = agent.snapshot_host_env()
    ms = []
    for _ in range(reps):
        agent.restore_host_env(snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent._host_collect(state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    agent.restore_host_env(snap)
    return sorted(ms)[reps // 2]


def _act_latency_ms(torch, act, params, obs, gen, calls: int = 200):
    act(params, obs, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        act(params, obs, gen)
    return (time.perf_counter() - t0) * 1e3 / calls


def _host_fleet_groups(torch, np, dev) -> dict:
    """cartpole-fleet's width (2,048 envs x 4 steps) on native:cartpole
    with host_pipeline_groups 1, 2, 4: the rollout's ms each (sampled);
    under the mode policy the pipelined trajectories must equal the serial
    one bitwise."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.envs.native import NativeVecEnv
    from trpo_torch.ops import _build
    from trpo_torch.rollout import host_rollout, pipelined_host_rollout

    pcfg = get_preset("pendulum").replace(env="native:pendulum")
    cfg = get_preset("cartpole-fleet").replace(env="native:cartpole",
                                               rollout_chunk=None)
    counts = {}
    ms = {}
    for c, tag in ((pcfg, "pendulum"), (cfg, "fleet")):
        for groups in (1, 2, 4):
            agent = TRPOAgent(c.env, c.replace(host_pipeline_groups=groups),
                              device=dev)
            state = agent.init_state(seed=0)
            torch.cuda.synchronize()
            _build.reset_launches()
            state, stats = agent.run_iteration(state)
            torch.cuda.synchronize()
            counts = _add(counts, dict(_build.LAUNCHES))
            _check(_finite(torch, stats["entropy"]),
                   f"[host] {tag} groups={groups}: entropy not finite")
            ms[tag, groups] = _host_rollout_ms(torch, agent, state)
    params = state.policy_params
    serial = host_rollout(NativeVecEnv("cartpole", 2048, seed=5), agent.policy,
                          params, None, 4, deterministic=True, device=dev)
    same = {}
    for groups in (2, 4):
        piped = pipelined_host_rollout(
            NativeVecEnv("cartpole", 2048, seed=5), agent.policy, params,
            torch.Generator(device=dev), 4, n_groups=groups,
            deterministic=True, stage_to_device=True, device=dev)
        same[groups] = all(
            torch.equal(getattr(serial, f), getattr(piped, f))
            for f in ("obs", "actions", "rewards", "terminated", "done",
                      "next_obs", "episode_return", "episode_length"))
        _check(same[groups], f"[host] pipelined groups={groups} differs "
               "from serial under the mode policy")
    print("[host] rollout ms by host_pipeline_groups, cartpole-fleet width "
          f"on native:cartpole ({agent.n_steps}x{agent.n_envs}): "
          + ", ".join(f"G={g} {v:.2f}" for (t, g), v in ms.items()
                      if t == "fleet")
          + "; pendulum on native:pendulum (250x16): "
          + ", ".join(f"G={g} {v:.2f}" for (t, g), v in ms.items()
                      if t == "pendulum")
          + f" (host cores {os.cpu_count()}, OMP_NUM_THREADS="
          f"{os.environ.get('OMP_NUM_THREADS', 'unset')}); mode-policy "
          f"trajectories pipelined == serial bitwise: {same}", flush=True)
    return counts


def _host_group_breakdown(torch, np, dev) -> None:
    """Where pendulum's window (16 envs x 250 steps) goes with one group,
    with 4 groups on worker threads (``pipelined_host_rollout``), and with
    the same 4 groups stepped one after another on the calling thread:
    the wall and CPU time of each thread's pieces, summed over the window
    (acts on the calling thread; the env steps and their bookkeeping,
    ``rollout._record_step``, on the workers when threaded). A piece's
    wall minus its CPU time is time its thread was off a core: waiting
    for the GIL, for a device sync that sleeps, or descheduled."""
    import threading

    from trpo_torch import rollout
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.envs.native import NativeVecEnv

    cfg = get_preset("pendulum").replace(env="native:pendulum")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    params = agent.init_state(seed=0).policy_params
    T, G = agent.n_steps, 4
    clock, lock = {}, threading.Lock()

    def timed(name, fn):
        def run(*args, **kw):
            w0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*args, **kw)
            finally:
                w = time.perf_counter() - w0
                c = time.thread_time() - c0
                with lock:
                    e = clock.setdefault(name, [0, 0.0, 0.0])
                    e[0] += 1
                    e[1] += w * 1e3
                    e[2] += c * 1e3
        return run

    def inline(env, act, gens):
        cuts = np.linspace(0, env.n_envs, G + 1).round().astype(int)
        groups = list(zip(cuts[:-1], cuts[1:]))
        obs0 = env.current_obs()
        obs = [obs0[lo:hi] for lo, hi in groups]
        bufs = [rollout._Buffers(T, dev) for _ in groups]
        for t in range(T):
            for g, (lo, hi) in enumerate(groups):
                a, d = act(params, obs[g], gens[g])
                nxt, r, te, tr, fin = env.host_step_slice(a, lo, hi)
                rollout._record_step(
                    bufs[g], t, obs[g], a, d, fin, r, te, tr,
                    env.last_episode_returns[lo:hi].copy(),
                    env.last_episode_lengths[lo:hi].copy())
                obs[g] = nxt
        return [b.to_device() for b in bufs]

    legs = {
        "G=1": lambda env, act: rollout.host_rollout(
            env, agent.policy, params, torch.Generator(device=dev), T,
            act_fn=act, device=dev),
        "G=4 threads": lambda env, act: rollout.pipelined_host_rollout(
            env, agent.policy, params, torch.Generator(device=dev), T,
            n_groups=G, act_fn=act, stage_to_device=True, device=dev),
        "G=4 inline": lambda env, act: inline(
            env, act, [torch.Generator(device=dev).manual_seed(g)
                       for g in range(G)]),
    }
    record = rollout._record_step
    parts = []
    try:
        rollout._record_step = timed("record", record)
        for name, leg in legs.items():
            for rep in range(2):  # the first warms the pinned-buffer cache
                env = NativeVecEnv("pendulum", n_envs=16, seed=7,
                                   max_episode_steps=200)
                env.host_step_slice = timed("env_step", env.host_step_slice)
                act = timed("act", rollout.make_host_act_fn(agent.policy))
                clock.clear()
                torch.cuda.synchronize()
                w0, c0 = time.perf_counter(), time.thread_time()
                leg(env, act)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w0) * 1e3
                cpu = (time.thread_time() - c0) * 1e3
            parts.append(
                f"{name}: {wall:.1f} ms (calling thread CPU {cpu:.1f}); "
                + ", ".join(f"{k} x{n} wall {w:.1f} cpu {c:.1f}"
                            for k, (n, w, c) in sorted(clock.items())))
    finally:
        rollout._record_step = record
    print(f"[host] group breakdown, pendulum {T}x16 window (ms summed over "
          f"the window; host cores {os.cpu_count()}, OMP_NUM_THREADS="
          f"{os.environ.get('OMP_NUM_THREADS', 'unset')}, switch interval "
          f"{sys.getswitchinterval() * 1e3:.1f} ms): " + " | ".join(parts),
          flush=True)


def _host_inference_legs(torch, np, dev) -> dict:
    """host_inference "device" against "cpu" on native:pendulum: the
    rollout's ms and the per-step act latency of each; cartpole's mode
    actions must agree exactly between the two."""
    from trpo_torch.agent import TRPOAgent, _to
    from trpo_torch.config import get_preset
    from trpo_torch.envs.native import NativeVecEnv
    from trpo_torch.ops import _build
    from trpo_torch.rollout import make_host_act_fn

    cfg = get_preset("pendulum").replace(env="native:pendulum")
    counts, line = {}, []
    window = f"{cfg.n_envs} envs x {cfg.batch_timesteps // cfg.n_envs} steps"
    for where in ("device", "cpu"):
        agent = TRPOAgent(cfg.env, cfg.replace(host_inference=where),
                          device=dev)
        state = agent.init_state(seed=0)
        torch.cuda.synchronize()
        _build.reset_launches()
        state, _ = agent.run_iteration(state)
        torch.cuda.synchronize()
        counts = _add(counts, dict(_build.LAUNCHES))
        roll = _host_rollout_ms(torch, agent, state)
        params, gen = agent._rollout_inputs(state)
        lat = _act_latency_ms(torch, agent._make_host_act(), params,
                              agent.env.current_obs(), gen)
        line.append(f"{where}: rollout {roll:.1f} ms, act {lat:.3f} "
                    "ms/step")
    ccfg = get_preset("cartpole").replace(env="native:cartpole")
    agent = TRPOAgent(ccfg.env, ccfg, device=dev)
    params = agent.init_state(seed=0).policy_params
    obs = NativeVecEnv("cartpole", 1000, seed=3).current_obs()
    act = make_host_act_fn(agent.policy, deterministic=True)
    a_dev, _ = act(params, obs, None)
    a_cpu, _ = act(_to(params, "cpu"), obs, None)
    _check(np.array_equal(a_dev, a_cpu),
           "[host] cartpole mode actions differ between card and CPU")
    print(f"[host] host_inference on native:pendulum ({window}): "
          + "; ".join(line) + "; cartpole mode actions card == CPU over "
          "1,000 observations", flush=True)
    return counts


def _host_train_legs(torch, dev) -> dict:
    """train.main on --env native:pendulum: 4 iterations serial and 4 on
    the async driver, on one env group and on 2 (the groups draw their own
    generators, so the 2-group serial run groups too, with one transfer at
    the end); each pair's rows and final state bitwise equal, and its
    median iteration ms. Then a resume from step 1 of 2, bitwise over the
    state and the sidecar."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.utils.checkpoint import Checkpointer

    work = WORK / "host"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.synchronize()
    _build.reset_launches()
    base = ["--preset", "pendulum", "--env", "native:pendulum", "--device",
            str(dev)]
    skip = {"iteration_ms", "time_elapsed_min"}

    def same_rows(a, b):
        return len(a) == len(b) and all(
            set(x) == set(y) and all(
                k in skip or x[k] == y[k] or (x[k] != x[k] and y[k] != y[k])
                for k in x) for x, y in zip(a, b))

    for groups, serial_flags in ((1, []), (2, ["--no-host-staged-transfers"])):
        flags = base + ["--host-pipeline-groups", str(groups)]
        runs = {"serial": serial_flags, "async": ["--host-async-pipeline"]}
        rows = {}
        for name, extra in runs.items():
            tag = f"{name}{groups}"
            code, _ = _main_quiet(flags + extra + [
                "--iterations", "4", "--checkpoint-dir", str(work / tag),
                "--checkpoint-every", "4", "--log-jsonl",
                str(work / f"{tag}.jsonl")])
            _check(code == 0, f"[host] train.main {tag} exited {code}")
            rows[name] = [json.loads(x) for x in
                          (work / f"{tag}.jsonl").read_text().splitlines()]
        cfg = get_preset("pendulum").replace(env="native:pendulum",
                                             host_pipeline_groups=groups)
        agent = TRPOAgent(cfg.env, cfg, device=dev)
        states = {n: Checkpointer(str(work / f"{n}{groups}")).restore(
            agent.init_state(), step=4) for n in runs}
        diff = _state_diff(torch, states["serial"], states["async"])
        equal = same_rows(rows["serial"], rows["async"])
        med = {n: sorted(r["iteration_ms"] for r in rows[n])[2]
               for n in rows}
        print(f"[host] train.main native:pendulum 4 iterations, {groups} "
              f"group(s): serial vs async rows "
              f"{'bitwise equal' if equal else 'DIFFER'}, final state "
              f"{'bitwise equal' if not diff else diff}; median iteration "
              f"ms serial {med['serial']:.1f}, async {med['async']:.1f} "
              f"(per-iteration: serial "
              f"{[round(r['iteration_ms'], 1) for r in rows['serial']]}, "
              f"async {[round(r['iteration_ms'], 1) for r in rows['async']]})",
              flush=True)
        _check(equal, "[host] async rows differ from serial")
        _check(not diff, f"[host] async state differs from serial: {diff}")

    a, b = work / "ra", work / "rb"
    flags = base + ["--host-pipeline-groups", "2", "--host-async-pipeline",
                    "--checkpoint-every", "1"]
    code, _ = _main_quiet(flags + ["--iterations", "2", "--checkpoint-dir",
                                   str(a)])
    _check(code == 0, f"[host] train.main (resume leg) exited {code}")
    b.mkdir()
    shutil.copytree(a / "step_1", b / "step_1")
    for name in ("step_1.complete", ".markers_enabled"):
        shutil.copy(a / name, b / name)
    code, lines = _main_quiet(flags + ["--iterations", "1", "--resume",
                                       "--checkpoint-dir", str(b)])
    _check(code == 0 and "resumed from step 1" in lines,
           f"[host] the resumed run exited {code}: {lines}")
    want = Checkpointer(str(a)).restore(agent.init_state(), step=2)
    got = Checkpointer(str(b)).restore(agent.init_state(), step=2)
    diff = _state_diff(torch, want, got)
    side_a = Checkpointer(str(a)).restore_host_env(step=2)
    side_b = Checkpointer(str(b)).restore_host_env(step=2)
    keys = ("state", "t", "rng", "obs", "running_returns",
            "running_lengths", "last_returns", "last_lengths")
    side_diff = [k for k in keys if not (
        side_a[k].dtype == side_b[k].dtype
        and (side_a[k] == side_b[k]).all())]
    print(f"[host] resumed from step 1 against the uninterrupted run at "
          f"step 2: state {'bitwise equal' if not diff else diff}, sidecar "
          f"{'bitwise equal' if not side_diff else side_diff} over "
          f"{', '.join(keys)} (rng {side_a['rng'].dtype})", flush=True)
    _check(not diff, f"[host] resumed state differs: {diff}")
    _check(not side_diff, f"[host] resumed sidecar differs: {side_diff}")
    torch.cuda.synchronize()
    return dict(_build.LAUNCHES)


def _host_item3(torch, dev) -> dict:
    """On native:pendulum: one update with cg_precondition="jacobi" (K1
    launches Σ(cg_iterations + 1) + cg_precond_probes), and one with
    fvp_mode="jvp_grad" whose step must have a cosine >= 0.999 with the K1
    solution's (the ladder's own floor)."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.ops.flat import flatten_params

    cfg = get_preset("pendulum").replace(env="native:pendulum")
    counts = {}
    agent = TRPOAgent(cfg.env, cfg.replace(cg_precondition="jacobi"),
                      device=dev)
    state = agent.init_state(seed=0)
    torch.cuda.synchronize()
    _build.reset_launches()
    _, stats = agent.run_iteration(state)
    torch.cuda.synchronize()
    counts = _add(counts, dict(_build.LAUNCHES))
    it = int(stats["cg_iterations"])
    want = it + 1 + cfg.cg_precond_probes
    _check(_build.LAUNCHES["fused_fvp"] == want,
           f"[host] jacobi: K1 launched {_build.LAUNCHES['fused_fvp']}, "
           f"expected {want}")
    steps = {}
    for mode in ("auto", "jvp_grad"):
        ag = TRPOAgent(cfg.env, cfg.replace(fvp_mode=mode), device=dev)
        st = ag.init_state(seed=0)
        st, traj = ag._host_collect(st)
        torch.cuda.synchronize()
        _build.reset_launches()
        new, pack = ag._policy_phase(st, traj)
        torch.cuda.synchronize()
        counts = _add(counts, dict(_build.LAUNCHES))
        steps[mode] = (flatten_params(new.policy_params)[0]
                       - flatten_params(st.policy_params)[0]).double()
        if mode == "jvp_grad":
            _check(_build.LAUNCHES["fused_fvp"] == 0,
                   "[host] jvp_grad launched K1")
    a, b = steps["auto"], steps["jvp_grad"]
    cos = float(a @ b / (a.norm() * b.norm()))
    print(f"[host] item 3: jacobi update K1 launches {want} = "
          f"(cg_iterations {it} + 1) + {cfg.cg_precond_probes} probes; "
          f"jvp_grad step vs K1 step cosine {cos:.6f}", flush=True)
    _check(cos >= 0.999, f"[host] jvp_grad step cosine {cos} < 0.999")
    return counts


def phase_host(torch, np, dev):
    """Queue 1 item 13 on the card: the native: envs behind the host
    rollout, K1 and K2 on the update (see the module docstring)."""
    from trpo_torch.config import get_preset

    _host_build_lines(torch)
    _host_physics(torch, np, dev)
    cfg = get_preset("pendulum").replace(env="native:pendulum")
    agent, state, _, counts = _drive(torch, dev, "host", cfg, 3)
    _check(agent.n_envs == 16 and agent.n_steps == 250,
           f"[host] pendulum window {agent.n_steps}x{agent.n_envs}")
    _host_stage_breakdown(torch, agent, state, "host")
    ccfg = get_preset("cartpole").replace(env="native:cartpole")
    counts = _add(counts, _drive(torch, dev, "host", ccfg, 2,
                                 kernel=None)[3])
    for leg in (lambda: _host_fleet_groups(torch, np, dev),
                lambda: _host_group_breakdown(torch, np, dev) or {},
                lambda: _host_inference_legs(torch, np, dev),
                lambda: _host_train_legs(torch, dev),
                lambda: _host_item3(torch, dev)):
        leg_counts = leg()
        plain = {k: v for k, v in leg_counts.items()
                 if k.endswith("_plain") and v}
        _check(not plain, f"[host] a plain version ran: {plain}")
        counts = _add(counts, leg_counts)
    print(f"[host] launches over the driven host paths: {counts}",
          flush=True)
    return counts


def phase_preempt(torch, dev):
    """A child ``python -m trpo_torch.train`` is sent SIGTERM once its
    first checkpoint is complete: it finishes the iteration in flight,
    writes a final checkpoint and exits 75."""
    from trpo_torch.utils.checkpoint import Checkpointer

    work = WORK / "preempt"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck, jsonl = work / "ck", work / "run.jsonl"
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.train", "--preset",
         "humanoid-sim", "--iterations", "1000", "--device", str(dev),
         "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
         "--log-jsonl", str(jsonl)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 300
        while not (ck / "step_1.complete").exists():
            _check(child.poll() is None,
                   f"[preempt] the child exited {child.returncode} early")
            _check(time.monotonic() < deadline,
                   "[preempt] no checkpoint within 300 s")
            time.sleep(0.05)
        t0 = time.perf_counter()
        child.send_signal(signal.SIGTERM)
        out, _ = child.communicate(timeout=300)
        exit_s = time.perf_counter() - t0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    step = Checkpointer(str(ck)).latest_step()
    rows = [json.loads(x) for x in jsonl.read_text().splitlines()]
    said = [line for line in out.splitlines()
            if line.startswith("preempted")]
    print(f"[preempt] exit code {child.returncode} {exit_s:.2f} s after "
          f"SIGTERM; newest complete checkpoint {step}; last JSONL row "
          f"{rows[-1]['iteration']}; {said}", flush=True)
    _check(child.returncode == 75,
           f"[preempt] exit code {child.returncode}:\n{out[-3000:]}")
    _check(step == rows[-1]["iteration"] and step >= 1,
           f"[preempt] checkpoint {step} against last row "
           f"{rows[-1]['iteration']}")


def _ggn_cg_ms(torch, op, g, chain: int, reps: int = 5) -> float:
    """Median ms per CG iteration, timed as ``trpo_torch.bench`` times CG:
    ``chain`` chained solves forced to 10 iterations (``residual_tol=0``),
    CUDA events, after a warm-up; the median of ``reps`` runs."""
    from trpo_torch.bench import CG_ITERS
    from trpo_torch.ops.cg import conjugate_gradient

    def chained():
        x = torch.zeros_like(g)
        for _ in range(chain):
            x = conjugate_gradient(op, -(g + 1e-30 * x), CG_ITERS,
                                   residual_tol=0.0).x
        return x

    runs = []
    with torch.no_grad():
        for i in range(reps + 1):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chained()
            end.record()
            torch.cuda.synchronize()
            if i:  # the first run is the warm-up
                runs.append(start.elapsed_time(end) / (chain * CG_ITERS))
    return sorted(runs)[reps // 2]


def _family_ggn(torch, np, agent, state, seed: int = 0):
    """The damped torch.func GGN of ``agent``'s policy over one rollout
    window from ``state`` (a SeqObs window for a recurrent policy), the
    flat params and a unit right-hand side: (op, x0, unravel, batch obs,
    weight, g)."""
    from trpo_torch.models.recurrent import SeqObs
    from trpo_torch.ops.flat import flatten_params
    from trpo_torch.ops.fvp import make_ggn_fvp
    from trpo_torch.rollout import device_rollout

    _, traj = device_rollout(agent.env, agent.policy, state.policy_params,
                             state.env_carry, state.rng, agent.n_steps)
    T, N = traj.rewards.shape
    if agent.is_recurrent:
        obs = SeqObs(traj.obs, traj.reset, traj.policy_h0)
        weight = torch.ones(T, N, device=traj.rewards.device)
    else:
        obs = traj.obs.reshape((T * N,) + traj.obs.shape[2:])
        weight = torch.ones(T * N, device=traj.rewards.device)
    x0, unravel = flatten_params(state.policy_params)
    op = make_ggn_fvp(lambda x: agent.policy.apply(unravel(x), obs),
                      agent.policy.dist.fisher_weight, x0, weight,
                      damping=agent.cfg.cg_damping)
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(x0.numel()).astype(np.float32)
    g = torch.as_tensor(g / np.linalg.norm(g), device=x0.device)
    return op, x0, unravel, obs, weight, g


def phase_pixel(torch, np, dev):
    """``catch`` and ``pong-sim`` as published. torch's cuDNN defaults
    (TF32 on, benchmark off, nondeterministic algorithms allowed) are
    restored first, so the path sees what a user's process sees: the agent
    must set f32, deterministic convolutions itself."""
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.ops.flat import tree_leaves

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    counts = {}
    for name, n_iter in (("catch", 2), ("pong-sim", 3)):
        cfg = get_preset(name)
        agent, state, rows, c = _drive(torch, dev, "pixel", cfg, n_iter,
                                       kernel=None)
        counts = _add(counts, c)
        _check(not torch.backends.cudnn.allow_tf32
               and torch.backends.cudnn.deterministic,
               "[pixel] the agent left cuDNN on TF32 or nondeterministic "
               "algorithms")
    n_params = sum(t.numel() for t in tree_leaves(state.policy_params))
    _check(agent.obs_shape == (84, 84, 4) and agent.n_steps == 256
           and agent.n_envs == 8 and state.env_carry[1].dtype == torch.uint8,
           f"[pixel] pong-sim ran {agent.n_steps}x{agent.n_envs} over "
           f"{agent.obs_shape} {state.env_carry[1].dtype}")
    print(f"[pixel] pong-sim: {agent.n_steps}x{agent.n_envs} window of "
          f"{agent.obs_shape} uint8 frames, conv policy of {n_params:,} "
          "parameters", flush=True)
    _check(n_params >= 1_000_000, f"[pixel] {n_params} parameters")
    _stage_breakdown(torch, agent, state, "pixel", "pong-sim")

    op, x0, unravel, obs, weight, g = _family_ggn(torch, np, agent, state)
    _build.reset_launches()
    ms = _ggn_cg_ms(torch, op, g, chain=4)
    print(f"[pixel] pong-sim GGN CG ms/iter over {obs.shape[0]} rows "
          f"(10 forced iterations, 4 chained solves a run, median of 5 "
          f"runs, CUDA events; the bench's method): {ms:.4f}", flush=True)
    # the same FVP on the CPU, one fixed v, the same params: an f32 check
    # of the convolutions (a TF32 one reads ~1e-3)
    from trpo_torch.ops.fvp import make_ggn_fvp

    rows = min(512, obs.shape[0])
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(
        x0.numel()).astype(np.float32), device=dev)
    with torch.no_grad():
        fvp_card = make_ggn_fvp(
            lambda x: agent.policy.apply(unravel(x), obs[:rows]),
            agent.policy.dist.fisher_weight, x0, weight[:rows],
            damping=agent.cfg.cg_damping)(v).cpu().double()
        x0_cpu = x0.cpu()
        obs_cpu = obs[:rows].cpu()
        fvp_cpu = make_ggn_fvp(
            lambda x: agent.policy.apply(unravel(x), obs_cpu),
            agent.policy.dist.fisher_weight, x0_cpu, weight[:rows].cpu(),
            damping=agent.cfg.cg_damping)(v.cpu()).double()
    rel = ((fvp_card - fvp_cpu).norm() / fvp_cpu.norm()).item()
    print(f"[pixel] pong-sim GGN FVP on the card against the CPU ({rows} "
          f"rows, one v): rel_err={rel:.3e}", flush=True)
    _check(rel < K1_RTOL, f"[pixel] card vs CPU conv FVP rel err {rel}")
    plain = {k: n for k, n in _build.LAUNCHES.items() if n}
    _check(not plain, f"[pixel] the GGN timing launched {plain}")
    return counts


def phase_recurrent(torch, np, dev):
    """``cartpole-po`` as published (GRU 64), and the same preset with an
    LSTM, 2 iterations each; the GRU's stage times and its GGN CG ms/iter
    (the 125-step window replayed under jvp and vjp at every matvec)."""
    from trpo_torch.config import get_preset

    counts = {}
    runs = {}
    for cell in ("gru", "lstm"):
        cfg = get_preset("cartpole-po").replace(policy_cell=cell)
        agent, state, _, c = _drive(torch, dev, "recurrent", cfg, 2,
                                 kernel=None)
        counts = _add(counts, c)
        runs[cell] = (agent, state)
        _check(agent.is_recurrent and len(state.env_carry) == 6,
               f"[recurrent] {cell}: no recurrent carry")
    agent, state = runs["gru"]
    _stage_breakdown(torch, agent, state, "recurrent", "cartpole-po GRU")
    for cell, (agent, state) in runs.items():
        op, _, _, obs, _, g = _family_ggn(torch, np, agent, state)
        ms = _ggn_cg_ms(torch, op, g, chain=1, reps=1)
        print(f"[recurrent] cartpole-po {cell} GGN CG ms/iter over a "
              f"{tuple(obs.reset.shape)} window (10 forced iterations, one "
              f"solve after a warm-up one, CUDA events): {ms:.3f}",
              flush=True)
    return counts


def phase_moe(torch, dev):
    """``cartpole`` with a 4-expert soft mixture, 2 iterations."""
    from trpo_torch.config import get_preset

    cfg = get_preset("cartpole").replace(policy_experts=4)
    agent, state, _, counts = _drive(torch, dev, "moe", cfg, 2, kernel=None)
    _check(state.policy_params["experts"]["layers"][0]["w"].shape[0] == 4,
           "[moe] the policy is not a 4-expert mixture")
    return counts


# ---------------------------------------------------------------------------
# [serve]: the serving data plane
# ---------------------------------------------------------------------------

# served actions and carries against eager act: the engine's graph and act
# run the same ops, but cuBLAS may pick another kernel at another width
SERVE_ATOL = 1e-5


def _uds_connection(path: str, timeout: float = 30.0):
    """An ``http.client.HTTPConnection`` over an ``AF_UNIX`` socket."""
    import http.client
    import socket

    class Conn(http.client.HTTPConnection):
        def connect(self):
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.settimeout(timeout)
            self.sock.connect(path)

    return Conn("localhost", timeout=timeout)


def _post(conn, path: str, payload=None, binary: bool = False):
    """``(status, answer)`` of one POST on a keep-alive connection: JSON
    (``payload`` may come encoded already), or the wire codec's frames
    with ``binary``. JSON alone imports nothing of the port (a load
    process stays light)."""
    if binary:
        from trpo_torch.serve import wire

        body = wire.encode_frame(None, payload)
        headers = {"Content-Type": wire.WIRE_CONTENT_TYPE,
                   "Accept": wire.WIRE_CONTENT_TYPE}
    else:
        body = (payload if isinstance(payload, bytes) else b""
                if payload is None else json.dumps(payload).encode())
        headers = {"Content-Type": "application/json"}
    conn.request("POST", path, body=body, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    if resp.getheader("Content-Type", "").startswith("application/json"):
        return resp.status, json.loads(data)
    from trpo_torch.serve import wire

    scalars, arrays = wire.decode_frame(data)
    return resp.status, dict(scalars, **arrays)


def _quantiles(ms: list) -> tuple:
    """Nearest-rank (p50, p99)."""
    ms = sorted(ms)
    return ms[len(ms) // 2], ms[min(len(ms) - 1, int(0.99 * len(ms)))]


def _ladder_timing(torch, engine, call, inputs, calls: int = 200) -> dict:
    """Per rung: ``call(*inputs(rung))`` host-clock p50/p99 over ``calls``
    calls, and the rung's graph replayed alone, device ms by CUDA events
    around 100 replays."""
    out = {}
    for rung in engine.batch_shapes:
        args = inputs(rung)
        lat = []
        for _ in range(calls):
            t0 = time.perf_counter()
            call(*args)
            lat.append((time.perf_counter() - t0) * 1e3)
        graph = engine._snapshot.graphs[rung].graph
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(100):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[rung] = _quantiles(lat) + (start.elapsed_time(end) / 100,)
    return out


def _print_ladder(label: str, timing: dict, card: str) -> None:
    line = "; ".join(f"rung {r}: p50 {p50:.4f} p99 {p99:.4f} ms, graph "
                     f"replay {dev:.5f} ms" for r, (p50, p99, dev)
                     in timing.items())
    print(f"[serve] {label}, host clock over 200 calls and graph replay "
          f"device ms: {line} ({card})", flush=True)


def _rungs_vs_eager(torch, agent, state, engine, obs, tag) -> tuple:
    """Actions at every rung and chunked past the top one against eager
    ``act`` at the same batch and at batch 1 row by row: ``(max |engine −
    act at the same batch|, max |engine − act at batch 1|)``. Categorical
    actions must be identical either way."""
    single = np.stack([agent.act(state, o, eval_mode=True)[0].cpu().numpy()
                       for o in obs])
    discrete = np.issubdtype(single.dtype, np.integer)
    err_batch = err_single = 0.0
    for n in engine.batch_shapes + (len(obs),):
        got = engine.infer(obs[:n])
        eager = agent.act(state, obs[:n], eval_mode=True)[0].cpu().numpy()
        if discrete:
            _check(np.array_equal(got, eager)
                   and np.array_equal(got, single[:n]),
                   f"[serve] {tag}: categorical actions at n={n} differ "
                   "from eager act")
        err_batch = max(err_batch, float(np.abs(got - eager).max()))
        err_single = max(err_single, float(np.abs(got - single[:n]).max()))
    _check(err_batch <= SERVE_ATOL and err_single <= SERVE_ATOL,
           f"[serve] {tag}: engine against eager act max err {err_batch}, "
           f"{err_single} > {SERVE_ATOL}")
    return err_batch, err_single


def _http_load(port: int, n_clients: int, n_requests: int, make_obs,
               on_start=None):
    """``n_clients`` threads, each on its own keep-alive connection, POST
    /act ``n_requests`` times: ``(latencies ms, wall s, failures)``. Each
    client encodes its bodies, connects and sends one untimed request
    first, so the server has accepted the connection and started its
    handler thread; the clocks start when every client is ready (then
    ``on_start()`` runs), so a latency is the round trip of an encoded
    request on a warm connection and the decoding of its answer, and the
    wall time covers the timed requests alone."""
    import http.client
    import threading

    lats, fails, start = [], [], []
    lock = threading.Lock()

    def go():
        if on_start is not None:
            on_start()
        start.append(time.perf_counter())

    barrier = threading.Barrier(n_clients, action=go)

    def client(k):
        rng = np.random.default_rng(100 + k)
        bodies = [json.dumps({"obs": make_obs(rng)}).encode()
                  for _ in range(n_requests + 1)]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        mine = []
        try:
            status, _ = _post(conn, "/act", bodies[0])
            if status != 200:
                raise RuntimeError(f"warm-up /act: {status}")
            barrier.wait(timeout=60)
            for body in bodies[1:]:
                t0 = time.perf_counter()
                status, _ = _post(conn, "/act", body)
                mine.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    with lock:
                        fails.append(status)
        except Exception as e:  # collected and checked by the caller
            barrier.abort()
            with lock:
                fails.append(repr(e))
        finally:
            conn.close()
        with lock:
            lats.extend(mine)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - start[0] if start else float("nan")
    return lats, wall, fails


class _NoOpEngine:
    """The engine's interface with an ``infer`` that touches no device: it
    returns a fixed action for every row. /act through it times the HTTP
    front end, the JSON codec and the micro-batcher alone."""

    def __init__(self, engine):
        self._engine = engine
        self._action = engine.infer(
            np.zeros((1,) + engine.obs_shape, engine.obs_dtype))[0]

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def infer(self, obs, return_step: bool = False):
        actions = np.repeat(self._action[None], len(obs), axis=0)
        return (actions, self._engine.loaded_step) if return_step \
            else actions


def _act_load(engine, cfg, clients: int, per: int, make_obs) -> dict:
    """/act on loopback TCP from ``clients`` keep-alive clients x ``per``
    requests, through a fresh MicroBatcher and PolicyServer over
    ``engine``: the client's p50/p99 and requests/s, and the batcher's own
    p50/p99 (enqueue to answer: queue wait + ``infer``) and mean batch
    width over the timed requests alone."""
    from trpo_torch.serve import MicroBatcher, PolicyServer

    batcher = MicroBatcher(engine, deadline_ms=cfg.serve_deadline_ms,
                           adaptive_deadline=cfg.serve_adaptive_deadline,
                           latency_window=clients * per)
    server = PolicyServer(engine, batcher, port=0)
    batches0 = []
    try:
        lats, wall, fails = _http_load(
            server.port, clients, per, make_obs,
            on_start=lambda: batches0.append(batcher.batches_total))
        _check(not fails, f"[serve] /act x{clients}: {fails[:3]}")
        batches = batcher.batches_total - batches0[0]
        q = batcher.latency_quantiles_ms()
    finally:
        server.close()
        batcher.close()
    p50, p99 = _quantiles(lats)
    return {"p50": p50, "p99": p99, "rps": len(lats) / wall,
            "batcher_p50": q[0.5], "batcher_p99": q[0.99],
            "width": len(lats) / batches}


def _hot_reload(torch, agent, cfg, ck, s2, s4, card) -> dict:
    """A PolicyServer watching ``ck`` (step 2) while 16 clients POST /act;
    step 4 lands mid-run. Every response's step must label the params
    that computed it (checked against eager act with each step's params),
    and none may fail."""
    import http.client
    import threading

    from trpo_torch.serve import MicroBatcher, PolicyServer
    from trpo_torch.utils.checkpoint import Checkpointer

    engine = agent.serve_engine()
    batcher = MicroBatcher(engine, deadline_ms=cfg.serve_deadline_ms,
                           adaptive_deadline=cfg.serve_adaptive_deadline)
    server = PolicyServer(engine, batcher, port=0,
                          checkpointer=Checkpointer(ck.directory),
                          template=agent.init_state(), poll_interval=0.05)
    records, fails, lats = [], [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(k):
        r = np.random.default_rng(1000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        try:
            while not stop.is_set():
                o = r.standard_normal(agent.obs_shape).astype(np.float32)
                body = json.dumps({"obs": o.tolist()}).encode()
                t0 = time.perf_counter()
                status, ans = _post(conn, "/act", body)
                with lock:
                    lats.append((time.perf_counter() - t0) * 1e3)
                    if status == 200:
                        records.append((o, np.asarray(ans["action"],
                                                      np.float32),
                                        ans["step"]))
                    else:
                        fails.append((status, ans))
        except Exception as e:  # collected and checked below
            with lock:
                fails.append(repr(e))
        finally:
            conn.close()

    try:
        _check(engine.loaded_step == 2, "[serve] the first load is not "
               "step 2")
        first_ms = server.last_reload_ms
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(16)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        ck.save(4, s4)
        deadline = time.monotonic() + 30
        while engine.loaded_step != 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        _check(engine.loaded_step == 4, "[serve] the reload never landed")
        _check(not fails, f"[serve] reload under load: {fails[:3]}")
        by_step = {2: [], 4: []}
        for o, a, step in records:
            _check(step in by_step, f"[serve] a response labelled {step}")
            by_step[step].append((o, a))
        _check(all(by_step.values()), "[serve] responses per step "
               f"{ {k: len(v) for k, v in by_step.items()} }")
        mislabelled, worst = 0, 0.0
        for step, state, other in ((2, s2, s4), (4, s4, s2)):
            o = np.stack([x for x, _ in by_step[step]])
            a = np.stack([y for _, y in by_step[step]])
            for i in range(0, len(o), 64):
                want = agent.act(state, o[i:i + 64], eval_mode=True)[0]
                alt = agent.act(other, o[i:i + 64], eval_mode=True)[0]
                err = np.abs(a[i:i + 64] - want.cpu().numpy()).max(axis=1)
                err_alt = np.abs(a[i:i + 64] - alt.cpu().numpy()).max(
                    axis=1)
                worst = max(worst, float(err.max()))
                mislabelled += int(((err > SERVE_ATOL)
                                    | (err_alt <= SERVE_ATOL)).sum())
        _check(mislabelled == 0,
               f"[serve] {mislabelled} responses mislabelled")
        _check(engine.captures_total == 6,
               f"[serve] {engine.captures_total} captures over two loads")
        p50, p99 = _quantiles(lats)
        print(f"[serve] humanoid-sim hot reload step 2 -> 4 under 16 "
              f"clients: {len(records)} responses ({len(by_step[2])} at "
              f"step 2, {len(by_step[4])} at step 4), 0 failed, 0 "
              f"mislabelled (each within {SERVE_ATOL} of eager act with "
              f"its step's params, max {worst:.3g}); reload ms (restore + "
              f"capture) {server.last_reload_ms:.2f}, the capture of 3 "
              f"rungs {engine.last_load_ms:.2f}; first load, idle "
              f"{first_ms:.2f} ms; /act over the leg p50 {p50:.3f} p99 "
              f"{p99:.3f} ms ({card})", flush=True)
    finally:
        stop.set()
        server.close()
        batcher.close()
    return engine.captures_total - 6


def _serve_humanoid(torch, dev, card) -> int:
    """humanoid-sim as published: the engine at every rung and chunked,
    PolicyServer on TCP and a Unix socket (JSON and binary), /act under 1
    and 64 clients, and the hot reload from step 2 to step 4."""
    import http.client

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops.flat import tree_map
    from trpo_torch.serve import MicroBatcher, PolicyServer
    from trpo_torch.utils.checkpoint import Checkpointer

    work = WORK / "serve"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = get_preset("humanoid-sim")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    s2 = agent.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    s4 = s2._replace(policy_params=tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=gen,
                                         device=dev), s2.policy_params))
    ck = Checkpointer(str(work / "ck"))
    ck.save(2, s2)

    engine = agent.serve_engine()
    _check(engine.batch_shapes == (1, 8, 64), "[serve] humanoid rungs")
    engine.load(s2.policy_params, s2.obs_norm, step=2)
    _check(engine.captures_total == 3,
           f"[serve] {engine.captures_total} captures for 3 rungs")
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((70,) + agent.obs_shape).astype(np.float32)
    err_b, err_1 = _rungs_vs_eager(torch, agent, s2, engine, obs,
                                   "humanoid-sim")
    print(f"[serve] humanoid-sim engine (376→256→256→17 Gaussian, rungs "
          f"1/8/64, n=70 chunked 64+6): max |engine − eager act| "
          f"{err_b:.3g} at the same batch, {err_1:.3g} against act at "
          f"batch 1 row by row (bitwise: {err_1 == 0.0}; tolerance "
          f"{SERVE_ATOL}); graph capture of 3 rungs "
          f"{engine.last_load_ms:.2f} ms", flush=True)
    timing = _ladder_timing(torch, engine, engine.infer, lambda r: (
        rng.standard_normal((r,) + agent.obs_shape).astype(np.float32),))
    _print_ladder("humanoid-sim infer", timing, card)

    batcher = MicroBatcher(engine, deadline_ms=cfg.serve_deadline_ms,
                           adaptive_deadline=cfg.serve_adaptive_deadline)
    uds = str(work / "s.sock")
    server = PolicyServer(engine, batcher, port=0, uds_path=uds)
    try:
        want = engine.infer(obs[:1])[0]
        for name, conn in (
                ("tcp", http.client.HTTPConnection(
                    "127.0.0.1", server.port, timeout=30)),
                ("uds", _uds_connection(uds))):
            for binary in (False, True):
                status, ans = _post(conn, "/act", {
                    "obs": obs[0] if binary else obs[0].tolist()},
                    binary=binary)
                _check(status == 200 and ans["step"] == 2
                       and np.array_equal(
                           np.asarray(ans["action"], np.float32), want),
                       f"[serve] /act over {name} binary={binary}: "
                       f"{status} {ans}")
            conn.close()
        print("[serve] humanoid-sim PolicyServer: /act over TCP and the "
              "Unix socket, JSON and binary frames, each bitwise equal to "
              "infer", flush=True)
    finally:
        server.close()
        batcher.close()
    def obs_json(r):
        return r.standard_normal(agent.obs_shape).tolist()

    for label, eng in (("", engine),
                       (" through an engine that computes nothing",
                        _NoOpEngine(engine))):
        for clients, per in ((1, 200), (64, 20)):
            r = _act_load(eng, cfg, clients, per, obs_json)
            print(f"[serve] humanoid-sim /act loopback TCP{label}, "
                  f"{clients} client(s) x {per} requests (keep-alive, "
                  f"connected and warmed before the clock): p50 "
                  f"{r['p50']:.3f} ms, p99 {r['p99']:.3f} ms, "
                  f"{r['rps']:.1f} requests/s; in the batcher (queue + "
                  f"infer) p50 {r['batcher_p50']:.3f} ms, p99 "
                  f"{r['batcher_p99']:.3f} ms, mean batch width "
                  f"{r['width']:.2f} ({card})", flush=True)
    on_path = engine.captures_total - 3
    return on_path + _hot_reload(torch, agent, cfg, ck, s2, s4, card)


def _serve_pong(torch, dev, card) -> int:
    """pong-sim as published: 84×84×4 uint8 frames, the 1.69M-parameter
    conv policy, categorical, rungs 1/8/64, /act in JSON and binary."""
    import http.client

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops.flat import tree_leaves
    from trpo_torch.serve import MicroBatcher, PolicyServer

    cfg = get_preset("pong-sim")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    n_params = sum(t.numel() for t in tree_leaves(state.policy_params))
    engine = agent.serve_engine()
    _check(engine.obs_dtype == np.uint8, "[serve] pong-sim is not uint8")
    engine.load(state.policy_params, state.obs_norm, step=0)
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, (70,) + agent.obs_shape, dtype=np.uint8)
    _rungs_vs_eager(torch, agent, state, engine, obs, "pong-sim")
    print(f"[serve] pong-sim engine (84x84x4 uint8, {n_params} parameters, "
          "categorical, rungs 1/8/64, n=70 chunked): actions identical to "
          f"eager act at the same batch and at batch 1; graph capture of 3 "
          f"rungs {engine.last_load_ms:.2f} ms", flush=True)
    captures = engine.captures_total
    timing = _ladder_timing(torch, engine, engine.infer, lambda r: (
        rng.integers(0, 256, (r,) + agent.obs_shape, dtype=np.uint8),))
    _print_ladder("pong-sim infer", timing, card)
    batcher = MicroBatcher(engine, deadline_ms=cfg.serve_deadline_ms,
                           adaptive_deadline=cfg.serve_adaptive_deadline)
    server = PolicyServer(engine, batcher, port=0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        want = engine.infer(obs[:1])[0]
        for binary in (False, True):
            status, ans = _post(conn, "/act", {
                "obs": obs[0] if binary else obs[0].tolist()},
                binary=binary)
            _check(status == 200 and int(np.asarray(ans["action"])) == want,
                   f"[serve] pong-sim /act binary={binary}: {status}")
        conn.close()
    finally:
        server.close()
        batcher.close()
    print("[serve] pong-sim /act in JSON and binary frames equal to infer",
          flush=True)
    return engine.captures_total - captures


def _serve_sessions(torch, dev, card, cell) -> int:
    """cartpole-po with a ``cell`` policy: the session engine at every
    rung against ``act(..., policy_carry=...)`` at batch 1, then 64
    concurrent HTTP sessions x 20 steps, each held against stepping it
    alone through ``act``."""
    import http.client
    import threading

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.serve import PolicyServer

    cfg = get_preset("cartpole-po").replace(policy_cell=cell)
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    engine = agent.serve_session_engine()
    _check(engine.batch_shapes == (1, 8, 64), "[serve] session rungs")
    engine.load(state.policy_params, state.obs_norm, step=0)
    rng = np.random.default_rng(2)
    S = engine.state_size
    carries = (0.5 * rng.standard_normal((70, S))).astype(np.float32)
    obs = rng.standard_normal((70,) + agent.obs_shape).astype(np.float32)
    ref = [agent.act(state, obs[i], eval_mode=True,
                     policy_carry=torch.as_tensor(carries[i], device=dev))
           for i in range(70)]
    ref_a = np.array([int(r[0]) for r in ref])
    ref_c = np.stack([r[2].cpu().numpy() for r in ref])
    err = 0.0
    for n in engine.batch_shapes + (70,):
        a, c = engine.step_batch(carries[:n], obs[:n])
        _check(np.array_equal(a, ref_a[:n]),
               f"[serve] {cell}: session actions at n={n} differ from act")
        err = max(err, float(np.abs(c - ref_c[:n]).max()))
    _check(err <= SERVE_ATOL, f"[serve] {cell}: carries err {err}")
    print(f"[serve] cartpole-po {cell} session engine (state {S}, rungs "
          f"1/8/64, n=70 chunked): actions identical to act(policy_carry) "
          f"at batch 1 row by row, carries max |err| {err:.3g} (bitwise: "
          f"{err == 0.0}; tolerance {SERVE_ATOL}); graph capture of 3 "
          f"rungs {engine.last_load_ms:.2f} ms", flush=True)
    captures = engine.captures_total
    timing = _ladder_timing(torch, engine, engine.step_batch,
                            lambda r: (carries[:r], obs[:r]))
    _print_ladder(f"cartpole-po {cell} step_batch", timing, card)

    server = PolicyServer(engine, None, port=0,
                          session_deadline_ms=cfg.serve_session_deadline_ms)
    n_sess, n_steps = 64, 20
    results, fails = {}, []
    lock = threading.Lock()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=30)
        sids = []
        for _ in range(n_sess):
            status, ans = _post(conn, "/session")
            _check(status == 200, f"[serve] /session: {status}")
            sids.append(ans["session"])
        conn.close()
        sb = server.session_batcher
        start = []  # (clock, epochs) when every client has connected
        barrier = threading.Barrier(n_sess, action=lambda: start.append(
            (time.perf_counter(), sb.epochs_total)))

        def client(k):
            r = np.random.default_rng(500 + k)
            c = http.client.HTTPConnection("127.0.0.1", server.port,
                                           timeout=30)
            mine = []
            try:
                c.connect()
                barrier.wait(timeout=30)
                for t in range(n_steps):
                    o = r.standard_normal(agent.obs_shape).astype(
                        np.float32)
                    status, ans = _post(c, f"/session/{sids[k]}/act",
                                        {"obs": o.tolist(), "seq": t})
                    if status != 200:
                        raise RuntimeError(f"{status} {ans}")
                    mine.append((o, int(ans["action"])))
            except Exception as e:  # collected and checked below
                barrier.abort()
                with lock:
                    fails.append(repr(e))
            finally:
                c.close()
            with lock:
                results[k] = mine

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(n_sess)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _check(not fails, f"[serve] {cell} sessions: {fails[:3]}")
        wall = time.perf_counter() - start[0][0]
        epochs = sb.epochs_total - start[0][1]
        carry_err = 0.0
        for k in range(n_sess):
            carry = None
            for o, a in results[k]:
                a_ref, _, carry = agent.act(state, o, eval_mode=True,
                                            policy_carry=carry)
                _check(int(a_ref) == a,
                       f"[serve] {cell}: session {k}'s action differs")
            live = torch.as_tensor(server.sessions.get(sids[k]).carry,
                                   device=dev)
            carry_err = max(carry_err, float((live - carry).abs().max()))
        _check(carry_err <= SERVE_ATOL,
               f"[serve] {cell}: session carries err {carry_err}")
        acts = n_sess * n_steps
        print(f"[serve] cartpole-po {cell} over HTTP: {n_sess} concurrent "
              f"sessions x {n_steps} steps, every action identical to "
              f"stepping the session alone through act, carries max "
              f"|err| {carry_err:.3g}; {epochs} epochs in {wall:.2f} s = "
              f"{epochs / wall:.1f} epochs/s, mean epoch width "
              f"{acts / epochs:.2f}, {acts / wall:.1f} session acts/s "
              f"({card})", flush=True)
    finally:
        server.close()
    return engine.captures_total - captures


def _serve_moe(torch, dev, card) -> int:
    """``cartpole`` with 4 experts: the engine at every rung."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset

    cfg = get_preset("cartpole").replace(policy_experts=4)
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    engine = agent.serve_engine()
    engine.load(state.policy_params, state.obs_norm, step=0)
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((70,) + agent.obs_shape).astype(np.float32)
    _rungs_vs_eager(torch, agent, state, engine, obs, "moe")
    captures = engine.captures_total
    timing = _ladder_timing(torch, engine, engine.infer, lambda r: (
        rng.standard_normal((r,) + agent.obs_shape).astype(np.float32),))
    print("[serve] cartpole 4-expert MoE engine: actions identical to "
          "eager act at every rung and at batch 1", flush=True)
    _print_ladder("cartpole 4-expert MoE infer", timing, card)
    return engine.captures_total - captures


def phase_serve(torch, dev):
    """The serving data plane at full width: humanoid-sim, pong-sim,
    cartpole-po (GRU and LSTM) and the 4-expert cartpole, with every
    kernel's launch count read around it (all must stay 0: serving is a
    forward pass, on no TPU kernel's path) and the graph captures made on
    the request path (must be 0)."""
    from trpo_torch.ops import _build

    card = _card_line()
    torch.cuda.synchronize()
    _build.reset_launches()
    captures = _serve_humanoid(torch, dev, card)
    captures += _serve_pong(torch, dev, card)
    for cell in ("gru", "lstm"):
        captures += _serve_sessions(torch, dev, card, cell)
    captures += _serve_moe(torch, dev, card)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check(captures == 0,
           f"[serve] {captures} graph captures on the request path")
    _check(not counts, f"[serve] kernels launched while serving: {counts}")
    print(f"[serve] graph captures on the request path: {captures}; "
          "launches of K1, K1-bf16, K2 and every plain version during "
          "[serve]: 0", flush=True)
    return counts


# ---------------------------------------------------------------------------
# [control]: the serving control plane
# ---------------------------------------------------------------------------

# the carries of a session resumed or stepped on another replica, against
# the same session stepped alone: the GEMMs round a row differently at
# another batch width (ROADMAP.md Queue 3)
CONTROL_CARRY_ATOL = 1e-6
# the closed-loop load of the scaling legs, as [serve]'s 64-client leg
CONTROL_CLIENTS, CONTROL_PER = 64, 20
# the canary leg's gate window, in canary requests
CONTROL_CANARY_WINDOW = 200


class _Loads:
    """Every engine the phase builds, with its loads counted: a load on a
    card captures one graph per rung, so captures beyond rungs x loads
    were made on the request path."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.engines = []  # [engine, loads]

    def track(self, engine):
        entry = [engine, 0]
        load = engine.load

        def counted(*args, **kwargs):
            with self._lock:
                entry[1] += 1
            return load(*args, **kwargs)

        engine.load = counted
        with self._lock:
            self.engines.append(entry)
        return engine

    def request_path_captures(self, on_card: bool) -> int:
        with self._lock:
            return sum(e.captures_total - (len(e.batch_shapes) * n
                                           if on_card else 0)
                       for e, n in self.engines)


def _ff_replica(loads, agent, params, **server_kw):
    """``factory()`` of one in-process feedforward replica on ``params``
    (or, with a checkpointer in ``server_kw``, on its checkpoint)."""
    from trpo_torch.serve import MicroBatcher, PolicyServer

    def factory():
        engine = loads.track(agent.serve_engine())
        if params is not None:
            engine.load(params, None, step=0)
        batcher = MicroBatcher(engine,
                               deadline_ms=agent.cfg.serve_deadline_ms,
                               adaptive_deadline=agent.cfg
                               .serve_adaptive_deadline)
        return PolicyServer(engine, batcher, port=0, **server_kw), [batcher]
    return factory


def _in_process_set(factory, n, **kw):
    """``n`` in-process replicas from ``factory`` (a ``rid -> factory()``
    map), healthy, supervised by the set's own thread."""
    from trpo_torch.serve import InProcessReplica, ReplicaSet

    kw.setdefault("health_interval", 0.1)
    kw.setdefault("backoff", 0.2)
    rs = ReplicaSet(lambda rid: InProcessReplica(factory(rid)), n, **kw)
    rs.start()
    _check(rs.wait_healthy(n, timeout=120), f"[control] {n} in-process "
           f"replicas never became healthy: {rs.snapshot()}")
    return rs


def _load_result(lats, wall, fails, what) -> dict:
    _check(not fails, f"[control] /act {what}: {fails[:3]}")
    p50, p99 = _quantiles(lats)
    return {"p50": p50, "p99": p99, "rps": len(lats) / wall}


def _scale_load(port: int, obs_dim: int, what: str) -> dict:
    """The scaling legs' load on ``port``, twice: from client threads in
    this process (as ``[serve]`` measures), then from a child process,
    whose clients share no interpreter with the router or the
    in-process replicas."""
    here = _load_result(*_http_load(
        port, CONTROL_CLIENTS, CONTROL_PER,
        lambda r: r.standard_normal(obs_dim).tolist()), what)
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke as cs\n"
        f"lats, wall, fails = cs._http_load({port}, {CONTROL_CLIENTS}, "
        f"{CONTROL_PER}, lambda r: r.standard_normal({obs_dim}).tolist())\n"
        "print(json.dumps([lats, wall, [repr(f) for f in fails]]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=300)
    _check(out.returncode == 0, f"[control] load process: {out.stderr}")
    child = _load_result(*json.loads(out.stdout.splitlines()[-1]),
                         what + " from a load process")
    return {"here": here, "child": child}


def _print_scale(kind: str, n, r: dict, card: str, base=None,
                 extra: str = "") -> None:
    def one(x, b):
        ratio = f", {x['rps'] / b['rps']:.3f}x the bare replica" if b else ""
        return (f"p50 {x['p50']:.3f} ms, p99 {x['p99']:.3f} ms, "
                f"{x['rps']:.1f} requests/s{ratio}")

    print(f"[control] humanoid-sim /act, {kind}, {n} replica(s), "
          f"{CONTROL_CLIENTS} keep-alive clients x {CONTROL_PER} (connected "
          f"before the clock): clients in this process "
          f"{one(r['here'], base and base['here'])}; clients in a load "
          f"process {one(r['child'], base and base['child'])}{extra} "
          f"({card})", flush=True)


def _control_scaling_in_process(torch, agent, params, loads, card) -> dict:
    """Leg 1: one bare replica, then the router (async core) over 1, 2
    and 4 in-process replicas, under the same closed-loop load."""
    from trpo_torch.serve import MicroBatcher, PolicyServer, Router

    engine = loads.track(agent.serve_engine())
    engine.load(params, None, step=0)
    batcher = MicroBatcher(engine, deadline_ms=agent.cfg.serve_deadline_ms,
                           adaptive_deadline=agent.cfg
                           .serve_adaptive_deadline)
    server = PolicyServer(engine, batcher, port=0)
    try:
        bare = _scale_load(server.port, agent.obs_shape[0], "bare replica")
    finally:
        server.close()
        batcher.close()
    _print_scale("no router (one bare PolicyServer)", 1, bare, card)
    out = {"bare": bare}
    for n in (1, 2, 4):
        rs = _in_process_set(
            lambda rid: _ff_replica(loads, agent, params), n)
        router = Router(rs, port=0)
        try:
            r = _scale_load(router.port, agent.obs_shape[0],
                            f"{n} in-process replicas")
            _check(router.failed_total == 0 and router.retried_total == 0,
                   f"[control] {n} in-process: failed "
                   f"{router.failed_total}, retried {router.retried_total}")
            hops = dict(router.dispatch_transport_total)
        finally:
            router.close()
            rs.close()
        out[n] = r
        _print_scale("router over in-process replicas", n, r, card, bare,
                     f"; hops {hops}")
    return out


def _child_memory(torch, pids) -> str:
    """The device memory of the given child pids as ``nvidia-smi`` lists
    them (it may list none inside a container)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"
    mine = {int(p): m.strip() for p, m in (
        line.split(",", 1) for line in out.splitlines() if "," in line)
        if p.strip().isdigit() and int(p) in pids}
    return ", ".join(f"pid {p}: {m}" for p, m in sorted(mine.items())) \
        or "nvidia-smi lists none of the children"


def _control_scaling_subprocess(torch, dev, ck_dir, bare, card) -> dict:
    """Leg 2: the same load through the router over 2, then 4
    ``python -m trpo_torch.serve`` children that ``TemplateTransport``
    places over hosts h0 and h1. The 4 start together; for the 2-child
    load, r2 and r3 are held out of rotation (``begin_drain``), then put
    back (``abort_drain``)."""
    from trpo_torch.serve import ReplicaSet, Router, TemplateTransport

    work = WORK / "control" / "replicas"
    shutil.rmtree(work, ignore_errors=True)
    template = (f"{sys.executable} -m trpo_torch.serve --device {dev.type} "
                "--port {port} --checkpoint-dir {checkpoint} "
                "--replica-name {replica} --preset humanoid-sim")
    transport = TemplateTransport(template, ("h0", "h1"), checkpoint=ck_dir,
                                  replica_root=str(work))
    free0 = torch.cuda.mem_get_info()[0] if dev.type == "cuda" else 0
    out = {}
    t0, wall0 = time.perf_counter(), time.time()
    rs = ReplicaSet(None, 4, transport=transport, health_interval=0.1,
                    start_timeout=300.0)
    router = None
    try:
        rs.start()
        started = {}

        def wait_for(n, since):
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline:
                for rid, row in rs.snapshot()["replicas"].items():
                    if row["state"] == "healthy" and rid not in started:
                        started[rid] = time.perf_counter() - since
                if len(started) >= n:
                    return
                time.sleep(0.05)
            raise SmokeFailure(f"[control] children never became healthy: "
                               f"{rs.snapshot()}")

        wait_for(4, t0)
        # each child's own start: from the launch to the moment it wrote
        # its descriptor (after its rungs were captured); the set finds
        # the descriptors on its discovery backoff, so it sees them later
        ready = {rec.id: os.path.getmtime(rec.handle.inner.descriptor_path)
                 - wall0 for rec in rs.replicas.values()}
        router = Router(rs, port=0)
        for n in (2, 4):
            for rid in ("r2", "r3"):
                _check((rs.begin_drain if n == 2 else rs.abort_drain)(rid)
                       is not False, f"[control] {rid} rotation")
            _check(len(rs.in_rotation()) == n, "[control] rotation "
                   f"{[r.id for r in rs.in_rotation()]}")
            r = _scale_load(router.port, 376, f"{n} children")
            out[n] = r
            hosts = {rec.id: rec.host for rec in rs.in_rotation()}
            _print_scale("router over subprocess replicas", n, r, card,
                         bare, f"; hosts {hosts}")
        _check(router.failed_total == 0, "[control] subprocess replicas: "
               f"{router.failed_total} failed")
        pids = {rec.handle.inner.proc.pid for rec in rs.replicas.values()}
        used = ((free0 - torch.cuda.mem_get_info()[0]) / 2**20
                if dev.type == "cuda" else float("nan"))
        print(f"[control] children's startup seconds (launch to the "
              f"child's descriptor written: import torch, CUDA context, "
              f"restore, capture of 3 rungs): "
              + ", ".join(f"{rid} {s:.2f}" for rid, s in
                          sorted(ready.items()))
              + "; launch to healthy in the set (its discovery backoff "
              f"included): {max(started.values()):.2f}"
              + f"; device memory taken by the 4 children "
              f"{used:.0f} MiB in all (free memory before and after), "
              f"{_child_memory(torch, pids)} ({card})", flush=True)
        out["startup_s"] = ready
    finally:
        if router is not None:
            router.close()
        rs.close()  # reaps every child through the transport
    for rec in rs.replicas.values():
        proc = rec.handle.inner.proc
        _check(proc.poll() is not None, f"[control] child {proc.pid} alive")
    return out


def _control_failover(torch, agent, params, loads, card) -> None:
    """Leg 3: 16 clients on two in-process replicas; r0 is killed 1 s in.
    No client sees an error, the router retries, and r0 is relaunched and
    answers again."""
    import http.client
    import threading

    from trpo_torch.serve import Router

    rs = _in_process_set(lambda rid: _ff_replica(loads, agent, params), 2)
    router = Router(rs, port=0)
    stop = threading.Event()
    fails, answered = [], [0]
    lock = threading.Lock()

    def client(k):
        r = np.random.default_rng(2000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                          timeout=30)
        try:
            while not stop.is_set():
                status, ans = _post(conn, "/act", json.dumps({
                    "obs": r.standard_normal(agent.obs_shape).tolist()}
                ).encode())
                with lock:
                    if status == 200:
                        answered[0] += 1
                    else:
                        fails.append((status, ans))
        except Exception as e:  # collected and checked below
            with lock:
                fails.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(16)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
        # kill r0 while it holds requests: they are lost with it
        deadline = time.monotonic() + 10
        while (rs.replicas["r0"].inflight == 0
               and time.monotonic() < deadline):
            time.sleep(0.001)
        inflight = rs.replicas["r0"].inflight
        t_kill = time.perf_counter()
        rs.replicas["r0"].handle.kill()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            row = rs.snapshot()["replicas"]["r0"]
            if row["state"] == "healthy" and row["restarts"] == 1:
                break
            time.sleep(0.02)
        back_s = time.perf_counter() - t_kill
        time.sleep(0.5)
        router.reset_replica_latencies()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        row = rs.snapshot()["replicas"]["r0"]
        _check(not fails, f"[control] failover: {len(fails)} client "
               f"errors, {fails[:3]}")
        _check(router.retried_total > 0 and router.failed_total == 0,
               f"[control] failover: retried {router.retried_total}, "
               f"failed {router.failed_total}, {inflight} in flight on r0 "
               f"at the kill, {answered[0]} answers, {row}")
        _check(row["state"] == "healthy" and row["restarts"] == 1,
               f"[control] the killed replica did not come back: {row}")
        r0_after = len(router.replica_latencies_ms("r0"))
        _check(r0_after > 0, "[control] the relaunched replica is not in "
               "rotation")
        print(f"[control] failover: r0 killed under 16 clients with "
              f"{inflight} requests in flight on it; "
              f"{answered[0]} answers, 0 client errors, "
              f"{router.retried_total} retried, 0 failed; r0 relaunched "
              f"and healthy {back_s:.2f} s after the kill "
              f"({row['last_death_reason']!r}), then answered {r0_after} "
              f"requests in 0.5 s ({card})", flush=True)
    finally:
        stop.set()
        router.close()
        rs.close()


def _control_capture_beside_replays(torch, agent, params, loads,
                                    card) -> None:
    """Two engines of one process, as two in-process replicas hold them:
    engine A's ``infer`` (rung 1) alone, then while engine B captures
    new snapshots back to back on another thread. A capture runs on B's
    own side stream in ``thread_local`` mode; whether it holds A's
    replays back is what this measures."""
    import threading

    a = loads.track(agent.serve_engine())
    b = loads.track(agent.serve_engine())
    a.load(params, None, step=0)
    b.load(params, None, step=0)
    obs = np.zeros((1,) + agent.obs_shape, np.float32)

    def timed(n):
        lat = []
        for _ in range(n):
            t0 = time.perf_counter()
            a.infer(obs)
            lat.append((time.perf_counter() - t0) * 1e3)
        return _quantiles(lat)

    timed(50)
    alone = timed(400)
    stop = threading.Event()
    ms = []

    def capture():
        while not stop.is_set():
            b.load(params, None, step=1)
            ms.append(b.last_load_ms)

    thread = threading.Thread(target=capture)
    switch = sys.getswitchinterval()
    thread.start()
    try:
        during = timed(400)
        # the interpreter's switch interval bounds how long A's thread
        # waits for B's to let go of the interpreter lock
        sys.setswitchinterval(0.0005)
        during_fast = timed(400)
    finally:
        sys.setswitchinterval(switch)
        stop.set()
        thread.join(timeout=60)
    print(f"[control] capture beside replays (humanoid-sim, two engines in "
          f"one process): engine A's infer at rung 1 alone p50 "
          f"{alone[0]:.4f} ms, p99 {alone[1]:.4f}; while engine B captured "
          f"{len(ms)} snapshots (3 rungs each, median "
          f"{sorted(ms)[len(ms) // 2]:.2f} ms) p50 {during[0]:.4f} ms, p99 "
          f"{during[1]:.4f} at the {switch * 1e3:g} ms switch interval, "
          f"p50 {during_fast[0]:.4f} ms, p99 {during_fast[1]:.4f} at 0.5 ms "
          f"({card})", flush=True)


def _session_factory(loads, agent, params, jdir):
    from trpo_torch.serve import PolicyServer

    def make(rid):
        def factory():
            engine = loads.track(agent.serve_session_engine())
            engine.load(params, None, step=0)
            return PolicyServer(
                engine, None, port=0, replica_name=rid,
                carry_journal_dir=jdir, carry_sync_every=1,
                session_deadline_ms=agent.cfg.serve_session_deadline_ms), []
        return factory
    return make


def _control_sessions(torch, dev, loads, card) -> None:
    """Leg 4: 16 cartpole-po GRU sessions x 20 steps over two journaled
    replicas; the replica pinned by half of them is killed at step 10.
    The next act resumes from the journal; the rest of each session
    matches the session stepped alone."""
    import threading

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.serve import Router

    cfg = get_preset("cartpole-po")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    jdir = str(WORK / "control" / "journal")
    shutil.rmtree(jdir, ignore_errors=True)
    rs = _in_process_set(_session_factory(loads, agent, state.policy_params,
                                          jdir), 2)
    router = Router(rs, port=0, journal_dir=jdir)
    n_sess, n_steps, cut = 16, 20, 10
    rng = np.random.default_rng(7)
    obs = rng.standard_normal((n_sess, n_steps) + agent.obs_shape).astype(
        np.float32)
    try:
        sids, pins = [], []
        for k in range(n_sess):
            # odd sessions land on r1: a held reservation makes r0 the
            # busier replica for the create (the router's own signal)
            held = router._pick(stateless=False) if k % 2 else None
            status, out = _post_url(router.url + "/session")
            if held is not None:
                router._release(held)
            _check(status == 200, f"[control] /session: {status} {out}")
            sids.append(out["session"])
            pins.append(out["replica"])
        _check(pins.count("r0") == pins.count("r1") == n_sess // 2,
               f"[control] session pins {pins}")
        answers = [[None] * n_steps for _ in range(n_sess)]
        fails = []

        def steps(k, lo, hi):
            for t in range(lo, hi):
                status, out = _post_url(
                    router.url + f"/session/{sids[k]}/act",
                    {"obs": obs[k, t].tolist()})
                if status != 200:
                    fails.append((k, t, status, out))
                    return
                answers[k][t] = out

        def run(lo, hi):
            threads = [threading.Thread(target=steps, args=(k, lo, hi))
                       for k in range(n_sess)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)

        run(0, cut)
        rs.replicas["r0"].handle.server.sessions.journal.drain()
        rs.replicas["r0"].handle.kill()
        run(cut, n_steps)
        _check(not fails, f"[control] sessions: {fails[:3]}")
        carry_err = 0.0
        for k in range(n_sess):
            carry = None
            for t in range(n_steps):
                a, _, carry = agent.act(state, obs[k, t], eval_mode=True,
                                        policy_carry=carry)
                out = answers[k][t]
                _check(int(a) == out["action"], f"[control] session {k} "
                       f"step {t}: action {out['action']} != {int(a)}")
                moved = pins[k] == "r0" and t == cut
                _check(bool(out.get("resumed")) == moved
                       and (not moved or out["resumed_steps"] == cut),
                       f"[control] session {k} step {t}: {out}")
            live = router._affinity[sids[k]].replica
            got = rs.replicas[live].handle.server.sessions.get(
                sids[k]).carry
            carry_err = max(carry_err, float(
                (torch.as_tensor(got, device=dev) - carry).abs().max()))
        _check(carry_err <= CONTROL_CARRY_ATOL,
               f"[control] resumed carries err {carry_err}")
        _check(router.sessions_resumed_total == n_sess // 2,
               f"[control] {router.sessions_resumed_total} resumed")
        print(f"[control] sessions: {n_sess} cartpole-po GRU sessions x "
              f"{n_steps} steps over 2 journaled replicas; r0, pinned by "
              f"{n_sess // 2}, killed at step {cut}: each of those resumed "
              f"from its journal (resumed_steps {cut}) on r1, every action "
              f"identical to the session stepped alone, carries max |err| "
              f"{carry_err:.3g} (tolerance {CONTROL_CARRY_ATOL}) ({card})",
              flush=True)
    finally:
        router.close()
        rs.close()


def _post_url(url, payload=None, timeout=30.0):
    """``(status, answer)`` of one JSON POST on a fresh connection."""
    import urllib.error
    import urllib.request

    data = b"" if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _control_canary(torch, dev, agent, state, loads, card) -> None:
    """Leg 5: three managed replicas serve step 2. Step 4 is published
    and promoted through a canary (canary_fraction 0.25, a parity
    tolerance); a step 6 with NaN params is rolled back. 8 clients see
    no failed answer throughout."""
    import threading

    from trpo_torch.ops.flat import tree_map
    from trpo_torch.serve import CanaryController, Router
    from trpo_torch.utils.checkpoint import Checkpointer

    ck_dir = str(WORK / "control" / "canary_ck")
    shutil.rmtree(ck_dir, ignore_errors=True)
    trainer = Checkpointer(ck_dir)
    trainer.save(2, state)
    incumbent = {"step": None}
    gen = torch.Generator(device=dev).manual_seed(4)

    def make(rid):
        return _ff_replica(loads, agent, None,
                           checkpointer=Checkpointer(ck_dir),
                           template=agent.init_state(), poll_interval=60.0,
                           managed_reload=True,
                           initial_step=incumbent["step"])

    rs = _in_process_set(make, 3)
    router = Router(rs, port=0, canary_fraction=0.25)
    # the controller's p99 budget (50%); a window of 200 canary requests
    # puts its p99 on the third-largest sample, not on one hiccup
    ctrl = CanaryController(rs, router, Checkpointer(ck_dir).latest_step,
                            incumbent=incumbent,
                            window_requests=CONTROL_CANARY_WINDOW,
                            parity_tol=1.0, gate_timeout_s=60.0)
    stop = threading.Event()
    fails, answered = [], [0]
    lock = threading.Lock()

    def client(k):
        import http.client

        r = np.random.default_rng(3000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                          timeout=30)
        try:
            while not stop.is_set():
                status, ans = _post(conn, "/act", json.dumps({
                    "obs": r.standard_normal(agent.obs_shape).tolist()}
                ).encode())
                with lock:
                    if status == 200:
                        answered[0] += 1
                    else:
                        fails.append((status, ans))
        except Exception as e:  # collected and checked below
            with lock:
                fails.append(repr(e))
        finally:
            conn.close()

    def settle(step):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            steps = {row["loaded_step"]
                     for row in rs.snapshot()["replicas"].values()}
            if steps == {step}:
                return steps
            time.sleep(0.05)
        return steps

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(8)]
    try:
        ctrl.tick()
        _check(incumbent["step"] == 2, f"[control] adopted {incumbent}")
        for t in threads:
            t.start()
        time.sleep(0.3)
        trainer.save(4, state._replace(policy_params=tree_map(
            lambda t: t + 0.005 * torch.randn(t.shape, generator=gen,
                                              device=dev),
            state.policy_params)))
        ctrl.tick()
        promote_s, promote_p99 = ctrl.last_decision_s, ctrl.last_p99_ms
        _check(ctrl.last_decision == "promoted" and incumbent["step"] == 4,
               f"[control] step 4: {ctrl.last_decision} "
               f"({ctrl.last_reason})")
        _check(settle(4) == {4}, f"[control] after promotion: "
               f"{rs.snapshot()['replicas']}")
        trainer.save(6, state._replace(policy_params=tree_map(
            lambda t: t * float("nan"), state.policy_params)))
        ctrl.tick()
        _check(ctrl.last_decision == "rolled_back" and ctrl.last_step == 6,
               f"[control] step 6: {ctrl.last_decision}")
        _check(settle(4) == {4}, f"[control] after the rollback: "
               f"{rs.snapshot()['replicas']}")
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        _check(not fails, f"[control] canary: {len(fails)} failed answers "
               f"{fails[:3]}")
        def p99s(pair):
            return ("not reached" if pair is None else
                    f"{pair[0]:.3f} ms against the incumbents' "
                    f"{pair[1]:.3f} ms, {pair[0] / pair[1]:.3f}x")

        print(f"[control] canary: 3 replicas on step 2; step 4 promoted "
              f"through the canary (fraction 0.25, window "
              f"{CONTROL_CANARY_WINDOW}, p99 budget "
              f"{ctrl.p99_budget_pct:g}%, parity tolerance 1.0) in "
              f"{promote_s:.2f} s (canary p99 {p99s(promote_p99)}), every "
              f"replica on step 4; step 6 (NaN params) rolled back in "
              f"{ctrl.last_decision_s:.2f} s ({ctrl.last_reason}; canary "
              f"p99 {p99s(ctrl.last_p99_ms)}), the set on step 4; "
              f"{answered[0]} answers to 8 clients, 0 failed ({card})",
              flush=True)
    finally:
        stop.set()
        ctrl.close()
        router.close()
        rs.close()


def _control_autoscaler(torch, dev, leg1_p99, loads, card) -> None:
    """Leg 6: the autoscaler (min 1, max 3) over journaled cartpole-po
    replicas. 16 session clients load one replica for 1 s; the SLO is set
    to half the lower of that p99 and leg 1's, and the autoscaler scales
    out once. A session created on the new replica is stepped; when the
    load stops the autoscaler scales in once, draining that live session
    onto the survivor (``resumed: true`` on its next act)."""
    import http.client
    import threading

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.serve import Autoscaler, Router

    cfg = get_preset("cartpole-po")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    jdir = str(WORK / "control" / "journal_autoscale")
    shutil.rmtree(jdir, ignore_errors=True)
    rs = _in_process_set(_session_factory(loads, agent, state.policy_params,
                                          jdir), 1)
    router = Router(rs, port=0, journal_dir=jdir)
    asc = None
    stop = threading.Event()
    fails = []
    lock = threading.Lock()

    def client(k):
        r = np.random.default_rng(4000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", router.port,
                                          timeout=30)
        try:
            status, out = _post(conn, "/session")
            path = f"/session/{out['session']}/act"
            while status == 200 and not stop.is_set():
                status, out = _post(conn, path, {
                    "obs": r.standard_normal(agent.obs_shape).tolist()})
            if status != 200:
                with lock:
                    fails.append((status, out))
        except Exception as e:  # collected and checked below
            with lock:
                fails.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(16)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
        warm_p99 = router.latency_window((0.99,))[0][0.99]
        slo_ms = 0.5 * min(warm_p99, leg1_p99)
        # a cooldown well past the time the new replica takes to join and
        # the load to stop: the leg wants exactly one scale-out
        asc = Autoscaler(rs, router, min_replicas=1, max_replicas=3,
                         slo_p99_ms=slo_ms, interval=0.2, cooldown_s=6.0,
                         latency_window_s=1.5)
        t0 = time.perf_counter()
        asc.start()
        deadline = time.monotonic() + 60
        while asc.scale_outs_total == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        out_s = time.perf_counter() - t0
        _check(asc.scale_outs_total == 1, "[control] no scale-out under "
               f"load ({asc.last_reason})")
        new, out_reason = asc.last_replica, asc.last_reason
        _check(rs.wait_healthy(2, timeout=60), "[control] the new replica "
               f"never became healthy: {rs.snapshot()}")
        healthy_s = time.perf_counter() - t0
        # r0 carries the load, so a create lands on the new replica
        deadline = time.monotonic() + 30
        status, out = _post_url(router.url + "/session")
        while out.get("replica") != new and time.monotonic() < deadline:
            status, out = _post_url(router.url + "/session")
        _check(out.get("replica") == new, f"[control] no session on {new}")
        sid = out["session"]
        obs = np.random.default_rng(5).standard_normal(
            (4,) + agent.obs_shape).astype(np.float32)
        for t in range(3):
            status, ans = _post_url(router.url + f"/session/{sid}/act",
                                    {"obs": obs[t].tolist()})
            _check(status == 200, f"[control] {status} {ans}")
        stop.set()
        for t in threads:
            t.join(timeout=60)
        t1 = time.perf_counter()
        deadline = time.monotonic() + 60
        while (asc.drains_completed_total == 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        in_s = time.perf_counter() - t1
        _check(asc.drains_completed_total == 1 and asc.last_replica == new,
               f"[control] scale-in: {asc.last_action} {asc.last_replica} "
               f"({asc.last_reason})")
        _check(asc.last_drain_moved == 1, "[control] the drain moved "
               f"{asc.last_drain_moved} sessions")
        status, ans = _post_url(router.url + f"/session/{sid}/act",
                                {"obs": obs[3].tolist()})
        carry = None
        for o in obs:
            a, _, carry = agent.act(state, o, eval_mode=True,
                                    policy_carry=carry)
        _check(status == 200 and ans.get("resumed") is True
               and ans["resumed_steps"] == 3 and ans["action"] == int(a),
               f"[control] the drained session's next act: {ans}")
        _check(asc.scale_outs_total == 1 and asc.drains_aborted_total == 0,
               f"[control] autoscaler: {asc.scale_outs_total} scale-outs, "
               f"{asc.drains_aborted_total} aborted drains")
        _check(not fails, f"[control] autoscaler load: {fails[:3]}")
        print(f"[control] autoscaler (min 1, max 3, SLO p99 {slo_ms:.3f} "
              f"ms = half the lower of the session load's p99 "
              f"{warm_p99:.3f} and leg 1's {leg1_p99:.3f}): scale-out to "
              f"{new} {out_s:.2f} s after it started under 16 session "
              f"clients ({out_reason}), {new} healthy at {healthy_s:.2f} "
              f"s; after the load stopped, one scale-in {in_s:.2f} s later "
              f"draining {new} in {asc.last_drain_s * 1e3:.1f} ms, its "
              f"live session resumed on the survivor (resumed_steps 3, the "
              f"action of the session stepped alone) ({card})", flush=True)
    finally:
        stop.set()
        if asc is not None:
            asc.close()
        router.close()
        rs.close()


def _control_cli(torch, dev, ck_dir, card) -> None:
    """Leg 7: ``python -m trpo_torch.serve --replicas 2`` in a child,
    answered through its router, SIGTERMed: exit 0 and its routed line."""
    work = WORK / "control" / "cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    desc = work / "run.json"
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.serve", "--device", dev.type,
         "--preset", "humanoid-sim", "--checkpoint-dir", ck_dir,
         "--port", "0", "--replicas", "2", "--health-interval", "0.1",
         "--run-descriptor", str(desc)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 300
        while not desc.exists():
            _check(child.poll() is None and time.monotonic() < deadline,
                   f"[control] the CLI child: {child.poll()}")
            time.sleep(0.1)
        url = json.loads(desc.read_text())["url"]
        while json.loads(_get_url(url + "/status"))["healthy"] < 2:
            _check(time.monotonic() < deadline, "[control] CLI replicas")
            time.sleep(0.1)
        up_s = time.perf_counter() - t0
        rng = np.random.default_rng(6)
        for _ in range(8):
            status, ans = _post_url(url + "/act", {
                "obs": rng.standard_normal(376).tolist()})
            _check(status == 200 and len(ans["action"]) == 17,
                   f"[control] CLI /act: {status} {ans}")
        child.send_signal(signal.SIGTERM)
        text, _ = child.communicate(timeout=120)
        _check(child.returncode == 0, f"[control] CLI exit "
               f"{child.returncode}: {text[-2000:]}")
        routed = [ln for ln in text.splitlines() if ln.startswith("routed ")]
        _check(routed == ["routed 8 requests (0 retried, 0 failed, 0 "
                          "backpressured)"], f"[control] CLI: {routed}")
        print(f"[control] CLI: python -m trpo_torch.serve --replicas 2 "
              f"(humanoid-sim) up with 2 healthy replicas in {up_s:.2f} s, "
              f"8 /act answered through its router, SIGTERM: exit 0, "
              f"{routed[0]!r} ({card})", flush=True)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)


def _get_url(url, timeout=30.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _allocated(torch, clear_workspaces: bool) -> int:
    import gc

    gc.collect()
    torch.cuda.synchronize()
    if clear_workspaces:
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def phase_control(torch, dev):
    """The serving control plane at full width (``humanoid-sim``: 376 →
    256 → 256 → 17, rungs 1/8/64; ``cartpole-po`` GRU 64) from seed 0:
    scaling through the router over in-process and subprocess replicas, a
    failover, sessions resumed from the journal, a canary promoted and
    rolled back, the autoscaler out and in, and the CLI. Every kernel's
    launches (0: serving is a forward pass), the graph captures on the
    request path (0) and the device memory before and after (back within
    1% once every in-process replica is closed) are checked."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.utils.checkpoint import Checkpointer

    on_card = dev.type == "cuda"
    card = _card_line() if on_card else "cpu"
    mem0 = (_allocated(torch, False), _allocated(torch, True)) \
        if on_card else (0, 0)
    _build.reset_launches()
    loads = _Loads()
    t_phase = time.perf_counter()
    cfg = get_preset("humanoid-sim")
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    state = agent.init_state(seed=0)
    ck_dir = str(WORK / "control" / "ck")
    shutil.rmtree(ck_dir, ignore_errors=True)
    Checkpointer(ck_dir).save(2, state)
    seconds = {}

    def leg(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    scale = leg("in-process", lambda: _control_scaling_in_process(
        torch, agent, state.policy_params, loads, card))
    leg("subprocess", lambda: _control_scaling_subprocess(
        torch, dev, ck_dir, scale["bare"], card))
    leg("capture", lambda: _control_capture_beside_replays(
        torch, agent, state.policy_params, loads, card))
    leg("failover", lambda: _control_failover(
        torch, agent, state.policy_params, loads, card))
    leg("sessions", lambda: _control_sessions(torch, dev, loads, card))
    leg("canary", lambda: _control_canary(torch, dev, agent, state, loads,
                                          card))
    leg("autoscaler", lambda: _control_autoscaler(
        torch, dev, scale[1]["here"]["p99"], loads, card))
    leg("cli", lambda: _control_cli(torch, dev, ck_dir, card))
    if on_card:
        torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    captures = loads.request_path_captures(on_card)
    engines = len(loads.engines)
    del agent, state, loads
    _check(not counts, f"[control] kernels launched: {counts}")
    _check(captures == 0,
           f"[control] {captures} graph captures on the request path")
    if on_card:
        mem1 = (_allocated(torch, False), _allocated(torch, True))
        drift = abs(mem1[1] - mem0[1]) / max(mem0[1], 1)
        print(f"[control] device memory allocated before the phase "
              f"{mem0[0] / 2**20:.1f} MiB, after every in-process replica "
              f"closed {mem1[0] / 2**20:.1f} MiB; without cuBLAS's "
              f"per-stream workspaces {mem0[1] / 2**20:.1f} -> "
              f"{mem1[1] / 2**20:.1f} MiB ({100 * drift:.3f}%, limit 1%)",
              flush=True)
        _check(drift <= 0.01, f"[control] device memory {mem0} -> {mem1}")
    print(f"[control] {engines} engines built; graph captures on the "
          f"request path: 0; launches of K1, K1-bf16, K2 and every plain "
          f"version during [control]: 0; seconds by leg: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; phase {time.perf_counter() - t_phase:.1f}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# [obs] the run-event bus, the tracer and live training telemetry
# ---------------------------------------------------------------------------

# the profiler trace must name K1's and K2's kernels (their CUDA symbols)
_K1_SYMBOL, _K2_SYMBOL = "fvp_sweep_kernel", "reverse_affine_scan_kernel"
OBS_TRACE_RATES = (0.0, 0.01, 1.0)


def _obs_train_cli(torch, dev, work: Path, card: str) -> str:
    """Leg 1: ``python -m trpo_torch.train`` on ``humanoid-sim`` as
    published, 4 iterations with every telemetry flag, ``/status`` and
    ``/metrics`` scraped by a thread while it runs. Returns its checkpoint
    directory (step 4), which leg 3 serves."""
    import threading
    import urllib.request

    from trpo_torch.obs.events import validate_event

    ck, ev, desc = work / "ck", work / "train.jsonl", work / "run.json"
    prof = work / "prof"
    argv = [sys.executable, "-m", "trpo_torch.train", "--preset",
            "humanoid-sim", "--iterations", "4", "--device", dev.type,
            "--metrics-jsonl", str(ev), "--health-checks", "--status-port",
            "0", "--memory-accounting", "--run-descriptor", str(desc),
            "--profile-dir", str(prof), "--profile-iteration", "3",
            "--checkpoint-dir", str(ck), "--checkpoint-every", "4"]
    scrapes, stop = [], threading.Event()

    def scrape():
        url = None
        while not stop.is_set():
            if url is None and desc.exists():
                url = json.loads(desc.read_text())["status_url"]
            if url is not None:
                try:
                    with urllib.request.urlopen(url + "/metrics",
                                                timeout=5) as r:
                        text = r.read().decode()
                    with urllib.request.urlopen(url + "/status",
                                                timeout=5) as r:
                        status = json.loads(r.read())
                    it = [ln for ln in text.splitlines()
                          if ln.startswith("trpo_iteration ")]
                    scrapes.append((int(it[0].split()[1]) if it else None,
                                    status["iteration"]))
                except Exception:
                    pass  # the run ended under us, or has not bound yet
            stop.wait(0.2)

    poller = threading.Thread(target=scrape, daemon=True)
    t0 = time.perf_counter()
    child = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    poller.start()
    try:
        out, _ = child.communicate(timeout=600)
    finally:
        stop.set()
        if child.poll() is None:
            child.kill()
            child.wait()
        poller.join(timeout=10)
    wall = time.perf_counter() - t0
    _check(child.returncode == 0,
           f"[obs] train CLI exit {child.returncode}:\n{out[-3000:]}")
    recs = [json.loads(x) for x in ev.read_text().splitlines()]
    bad = [(r.get("kind"), validate_event(r)) for r in recs
           if validate_event(r)]
    _check(not bad, f"[obs] invalid events: {bad[:3]}")
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    iters = [r["iteration"] for r in recs if r["kind"] == "iteration"]
    _check(iters == [1, 2, 3, 4], f"[obs] iteration events {iters}")
    man = recs[0]
    _check(man["kind"] == "run_manifest"
           and man["device_name"] == torch.cuda.get_device_name(0)
           and man["backend"] == "cuda", f"[obs] manifest {man}")
    unexpected = [r for r in recs if r["kind"] == "recompile"
                  and r["unexpected"]]
    _check(not unexpected, f"[obs] builds/captures after steady: "
           f"{unexpected}")
    gauges = [g for g, _ in scrapes if g is not None]
    _check(len(set(gauges)) >= 2 and gauges == sorted(gauges),
           f"[obs] /metrics trpo_iteration over the scrapes: {gauges}")
    traces = sorted(prof.glob("*.json"))
    _check(len(traces) == 1, f"[obs] profiler traces {traces}")
    text = traces[0].read_text()
    syms = {s: text.count(s) for s in (_K1_SYMBOL, _K2_SYMBOL)}
    _check(all(syms.values()), f"[obs] kernel symbols in the trace: {syms}")
    rows = [r["stats"] for r in recs if r["kind"] == "iteration"]
    print(f"[obs] train CLI (humanoid-sim as published, 4 iterations, every "
          f"telemetry flag): exit 0 in {wall:.1f} s; {len(recs)} events, "
          f"every one valid ({kinds}); 1 iteration event per iteration; "
          f"manifest names {man['device_name']!r} (torch "
          f"{man['torch_version']}, CUDA {man['cuda_version']}); "
          f"recompile events {kinds.get('recompile', 0)}, 0 unexpected "
          f"after steady; /metrics trpo_iteration over {len(scrapes)} "
          f"scrapes: {sorted(set(gauges))}; profiler window (iteration 3) "
          f"{traces[0].name} {traces[0].stat().st_size / 2**20:.1f} MiB, "
          f"{_K1_SYMBOL} x{syms[_K1_SYMBOL]}, {_K2_SYMBOL} "
          f"x{syms[_K2_SYMBOL]}; iteration_ms "
          f"{[round(r['iteration_ms'], 1) for r in rows]}; "
          f"cg_iters_total {[r['cg_iters_total'] for r in rows]} ({card})",
          flush=True)
    return str(ck)


def _obs_overhead(torch, dev, work: Path, card: str) -> dict:
    """Leg 2, in this process on the flagship state: ``learn`` with
    telemetry off and on (bus + JSONL + health + status server), runs of 3
    iterations in the order off, on, on, off, twice, after an audited
    warm-up update, and the telemetry's own host time timed directly; the
    solver counter against K1's launches on these unaudited updates,
    exactly."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.obs import Telemetry
    from trpo_torch.ops import _build
    from trpo_torch.utils.metrics import StatsLogger

    agent = TRPOAgent("humanoid-sim", get_preset("humanoid-sim"), device=dev)
    quiet = lambda: StatsLogger(stream=io.StringIO())  # noqa: E731
    state = agent.learn(1, logger=quiet())  # the audit fires on update 1
    c0 = int(state.metrics.cg_iters_total)
    rows = {"off": [], "on": []}
    torch.cuda.synchronize()
    _build.reset_launches()
    # off, on, on, off, twice: the host clock drifts over a process. The
    # telemetry's own host time is also read directly: every bus emit and
    # every on_iteration of the "on" runs, timed
    spent = []

    def timed(fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent.append(time.perf_counter() - t)
        return call

    for mode in ("off", "on", "on", "off") * 2:
        tel = None
        if mode == "on":
            tel = Telemetry(events_jsonl=str(work / "overhead.jsonl"),
                            health_checks=True, status_port=0)
            tel.bus.emit = timed(tel.bus.emit)
            tel.on_iteration = timed(tel.on_iteration)
        logger = quiet()
        keep = logger.log
        logger.log = lambda i, s, keep=keep, m=mode: (
            rows[m].append(dict(s)), keep(i, s))
        try:
            state = agent.learn(3, state=state, logger=logger, telemetry=tel)
        finally:
            if tel is not None:
                tel.close()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    updates = len(rows["off"]) + len(rows["on"])
    cg = int(state.metrics.cg_iters_total) - c0
    _check(not any(r["solve_audited"] for r in rows["off"] + rows["on"]),
           "[obs] an audited update in the timed runs")
    _check(counts.get("fused_fvp", 0) == cg + updates,
           f"[obs] K1 launched {counts.get('fused_fvp', 0)} times; "
           f"cg_iters_total grew {cg} over {updates} updates")
    _check(counts.get("reverse_scan", 0) == updates,
           f"[obs] K2 launched {counts.get('reverse_scan', 0)} times")
    med = {m: float(np.median([r["iteration_ms"] for r in rows[m]]))
           for m in rows}
    print(f"[obs] in process, humanoid-sim: cg_iters_total + updates = "
          f"{cg} + {updates} = {cg + updates} == K1 launches "
          f"{counts.get('fused_fvp', 0)} (exact; no cg_precond_probes), K2 "
          f"{counts.get('reverse_scan', 0)}; iteration ms, median of 12 "
          f"(runs of 3: off, on, on, off, twice), telemetry off "
          f"{med['off']:.2f} "
          f"{[round(r['iteration_ms'], 2) for r in rows['off']]}, on (bus, "
          f"JSONL, health, status server) {med['on']:.2f} "
          f"{[round(r['iteration_ms'], 2) for r in rows['on']]}: "
          f"{(med['on'] / med['off'] - 1) * 100:+.2f}%; the telemetry's own "
          f"host time (bus emits and on_iteration, timed) "
          f"{sum(spent) * 1e3 / len(rows['on']):.3f} ms an iteration, "
          f"{sum(spent) * 1e3 / len(rows['on']) / med['off'] * 100:.3f}% "
          f"of the off median ({card})", flush=True)
    return counts


def _obs_serving(torch, dev, ck_dir: str, work: Path, card: str) -> None:
    """Leg 3: ``python -m trpo_torch.serve --replicas 2`` over two
    ``--replica-cmd`` children (each with its own event log), with
    ``--metrics-jsonl`` and ``--trace-sample-rate`` at each rate. The three
    sets start together (one startup wait), then take the load in turn:
    /act at 64 clients x 20; every record valid, every sampled trace with
    its root; at rate 0 a child killed under requests must still be traced
    (the retry is forced)."""
    from trpo_torch.obs.events import validate_event

    runs = {}
    t0 = time.perf_counter()
    try:
        for rate in OBS_TRACE_RATES:
            run = work / f"serve_{rate}"
            shutil.rmtree(run, ignore_errors=True)
            # a copy of the checkpoint each: the children's descriptors
            # live under it
            shutil.copytree(ck_dir, run / "ck")
            template = (f"{sys.executable} -m trpo_torch.serve --device "
                        f"{dev.type} --port {{port}} --checkpoint-dir "
                        "{checkpoint} --replica-name {replica} --preset "
                        f"humanoid-sim --metrics-jsonl {run}/{{replica}}"
                        f".jsonl --trace-sample-rate {rate}")
            child = subprocess.Popen(
                [sys.executable, "-m", "trpo_torch.serve", "--device",
                 dev.type, "--preset", "humanoid-sim", "--checkpoint-dir",
                 str(run / "ck"), "--port", "0", "--replicas", "2",
                 "--replica-cmd", template, "--health-interval", "1.0",
                 "--metrics-jsonl", str(run / "router.jsonl"),
                 "--trace-sample-rate", str(rate), "--run-descriptor",
                 str(run / "run.json")],
                cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            runs[rate] = {"dir": run, "child": child}
        deadline = time.monotonic() + 300
        for rate, r in runs.items():
            desc = r["dir"] / "run.json"
            while not desc.exists():
                _check(r["child"].poll() is None
                       and time.monotonic() < deadline,
                       f"[obs] serve CLI at rate {rate}: {r['child'].poll()}")
                time.sleep(0.1)
            r["url"] = json.loads(desc.read_text())["url"]
            while json.loads(_get_url(r["url"] + "/status"))["healthy"] < 2:
                _check(time.monotonic() < deadline, "[obs] children")
                time.sleep(0.1)
        up_s = time.perf_counter() - t0
        for rate, r in runs.items():
            r["load"] = _load_result(*_http_load(
                int(r["url"].rsplit(":", 1)[1]), CONTROL_CLIENTS,
                CONTROL_PER, lambda g: g.standard_normal(376).tolist()),
                f"[obs] rate {rate}")
        # rate 0: kill r0 between health polls; the next request it gets
        # fails on the hop and is retried on r1
        r = runs[0.0]
        r["killed"] = json.loads((r["dir"] / "ck" / "replicas" / "r0"
                                  / "run.json").read_text())["pid"]
        os.kill(r["killed"], signal.SIGKILL)
        for _ in range(8):
            status, _ = _post_url(r["url"] + "/act", {"obs": [0.0] * 376})
            _check(status == 200, f"[obs] act after the kill {status}")
        for rate, r in runs.items():
            r["child"].send_signal(signal.SIGTERM)
        for rate, r in runs.items():
            text, _ = r["child"].communicate(timeout=120)
            _check(r["child"].returncode == 0,
                   f"[obs] serve CLI at rate {rate} exit "
                   f"{r['child'].returncode}: {text[-2000:]}")
    finally:
        for r in runs.values():
            if r["child"].poll() is None:
                r["child"].kill()
                r["child"].wait(timeout=60)
    for rate, r in runs.items():
        logs = {p.stem: [json.loads(x) for x in p.read_text().splitlines()]
                for p in sorted(r["dir"].glob("*.jsonl"))}
        bad = [(name, validate_event(rec)) for name, recs in logs.items()
               for rec in recs if validate_event(rec)]
        _check(not bad, f"[obs] invalid serving records: {bad[:3]}")
        router = logs["router"]
        spans = [x for recs in logs.values() for x in recs
                 if x["kind"] == "span"]
        traces = {x["trace"] for x in spans}
        roots = {x["trace"] for x in router if x["kind"] == "span"
                 and x["name"] == "router.act" and "parent" not in x}
        _check(traces <= roots, f"[obs] rate {rate}: "
               f"{len(traces - roots)} sampled traces without a root")
        requests = [x for x in router if x["kind"] == "router"
                    and x.get("scope") == "request"]
        retry = [x for x in spans if x["name"] == "router.retry"]
        if rate == 0.0:
            _check(retry and any(x["retried"] and "trace" in x
                                 for x in requests),
                   f"[obs] rate 0: the failover left no trace "
                   f"({len(retry)} retry spans)")
        load = r["load"]
        print(f"[obs] serving humanoid-sim, router over 2 children, trace "
              f"rate {rate}: /act {CONTROL_CLIENTS} clients x "
              f"{CONTROL_PER}: {load['rps']:.1f} requests/s, p50 "
              f"{load['p50']:.3f} ms, p99 {load['p99']:.3f} ms; "
              f"{len(traces)} traces, {len(spans)} spans "
              f"({len(spans) / max(1, len(traces)):.2f} a trace) over the "
              f"router's and the children's logs, every record valid, "
              f"every trace with its root"
              + (f"; child r0 (pid {r['killed']}) killed: {len(retry)} "
                 "router.retry span(s) traced at rate 0"
                 if "killed" in r else "")
              + f" ({card})", flush=True)
    print(f"[obs] the three serving sets (6 children) up together in "
          f"{up_s:.2f} s; each took its load while the other two idled "
          f"({card})", flush=True)


def phase_obs(torch, dev):
    """The run-event bus, the tracer and live training telemetry: the
    train CLI with every telemetry flag (a subprocess, as users run it),
    the solver counter against K1 and the telemetry overhead in process,
    and the replicated server's traces at three rates."""
    card = _card_line()
    work = WORK / "obs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ck_dir = _obs_train_cli(torch, dev, work, card)
    counts = _obs_overhead(torch, dev, work, card)
    _obs_serving(torch, dev, ck_dir, work, card)
    return counts


def phase_bench(torch):
    from trpo_torch import bench

    res = bench.run("cuda")
    print(f"[bench] {json.dumps(res)}", flush=True)
    values = [res["value"], res["update_ms"], res["vs_baseline"],
              *res["paths"].values()]
    _check(all(math.isfinite(v) and v > 0 for v in values),
           f"[bench] not every number is finite and positive: {res}")


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
        fvp16 = phase_fvp_bf16(torch, np, peaks, dev, fvp["ms"])
    torch.cuda.synchronize()
    total = {}  # launches over every driven path
    if not kernels_only:
        t0 = time.perf_counter()
        main_counts, stages, main_run = phase_main_path(torch, dev)
        total = _add(total, main_counts)
        seconds = {"main": time.perf_counter() - t0}
        for tag, phase in (
                ("bf16", lambda: phase_bf16(torch, dev, main_run)),
                ("fleet", lambda: phase_fleet(torch, dev, stages)),
                ("cartpole", lambda: phase_cartpole(torch, dev)),
                ("small", lambda: phase_small_reference(torch, dev)),
                ("pixel", lambda: phase_pixel(torch, np, dev)),
                ("recurrent", lambda: phase_recurrent(torch, np, dev)),
                ("moe", lambda: phase_moe(torch, dev)),
                ("learn", lambda: phase_learn(torch, dev)),
                ("norm", lambda: phase_norm(torch, dev)),
                ("overlap", lambda: phase_overlap(torch, dev)),
                ("population", lambda: phase_population(torch, dev)),
                ("host", lambda: phase_host(torch, np, dev)),
                ("preempt", lambda: phase_preempt(torch, dev)),
                ("serve", lambda: phase_serve(torch, dev)),
                ("control", lambda: phase_control(torch, dev)),
                ("obs", lambda: phase_obs(torch, dev)),
                ("bench", lambda: phase_bench(torch))):
            t0 = time.perf_counter()
            total = _add(total, phase() or {})
            seconds[tag] = time.perf_counter() - t0
            if tag == "bf16":
                del main_run
        print(f"[paths] launches over every driven path: {total}",
              flush=True)
        print("[time] seconds per phase: " + ", ".join(
            f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)

    kernels = [
        {"name": "fused_gauss_newton_fvp", "route": "cuda",
         "source": "trpo_torch/csrc/fused_fvp.cu",
         "replaces": "trpo_tpu/ops/fused_fvp.py:298",
         "launches": total.get("fused_fvp", 0), **fvp},
        {"name": "fused_gauss_newton_fvp_bf16", "route": "cuda",
         "source": "trpo_torch/csrc/fused_fvp_bf16.cu",
         "replaces": "trpo_tpu/ops/fused_fvp.py:298",
         "launches": total.get("fused_fvp_bf16", 0), **fvp16},
        {"name": "reverse_affine_scan", "route": "cuda",
         "source": "trpo_torch/csrc/reverse_scan.cu",
         "replaces": "trpo_tpu/ops/pallas_scan.py:75",
         "launches": total.get("reverse_scan", 0), **scan},
    ]
    print(json.dumps({"kernels": kernels}))
    print(_card_line(), flush=True)
    if kernels_only:
        return 0  # the main path was not driven: no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
