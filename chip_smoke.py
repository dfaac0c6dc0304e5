#!/usr/bin/env python3
"""Chip smoke for trpo_torch: build the hand-written Hopper kernels, hold
each against its plain PyTorch version on the card, drive the flagship and
the other device-env presets through them as published, and check the
result.

    python3 chip_smoke.py                 # needs one CUDA card
    python3 chip_smoke.py --kernels-only  # phases 1-4 only
    python3 chip_smoke.py --phases=flywheel,compat  # named path phases
                                          # alone, no result lines
    python3 chip_smoke.py --evidence=all  # the learning runs: every rung
                                          # of learning_evidence at its
                                          # published length (or
                                          # --evidence=cartpole,pendulum)

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
     16 clients while it holds requests it cannot finish (0 client
     errors, retried, relaunched); 16 sessions x 20
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
 22. ``[chaos]`` the fault injector as users arm it: ``python -m
     trpo_torch.train --preset humanoid-sim`` in a child with
     ``nan_update@iter=2;sigterm@iter=4`` and ``--recover-on-nan
     restore`` (exit 75; each fault met by its recovery / preempted
     record; iteration 2 replayed finite; the newest checkpoint = the last
     row; the child's K1 launches exactly Σ(cheap solve + 1) over its
     updates, the rewound one included, K2 once an iteration run, both
     read from the child's own counts); ``python -m trpo_torch.serve
     --replicas 2`` (the reference's router: 30 s act timeout, 8 retry
     tokens) under 64 clients with a replica killed at request 200 and a
     step 5 wedged through the canary (each spec fired and met by r0's
     died/evicted record or the canary's rollback, no wedged answer
     after the rollback, every client error a 502 for a retry the bucket
     shed, counted); ``Router(act_timeout_s=0.5, retry_budget=128)`` over
     two in-process replicas under 64 clients with a replica killed at
     request 200 and the other stalled 2 s at request 800 (each met by
     its own replica's died/evicted record, 0 client errors); requests/s
     and p50/p99 in the faulted and a clean window of each;
     ``gymproc:`` refused naming gymnasium before any worker starts; the
     records in ``build/chip_smoke/chaos/chaos.jsonl``;
 23. ``[replay]`` request capture, deterministic replay, offline analysis
     and alerts through the port's entry points (``trpo_torch.scripts``):
     ``python -m trpo_torch.train --preset humanoid-sim`` (5 iterations,
     ``--status-port 0``) in a child, watched while it runs by the
     observatory's aggregator and ``observatory --targets ... --once
     --json`` frames (``status.iteration`` advancing, 0 alerts), then
     ``analyze_run`` (5 iterations; ``--compare`` itself exit 0) and
     ``validate_events`` on its log; the child's K1 exactly Σ(cheap + 1)
     = ``cg_iters_total`` + updates less the audited full solve, K2 5;
     ``python -m trpo_torch.serve --preset cartpole-po --replicas 2
     --capture`` recording window A (4 sessions x 50 acts, one at a time)
     and B (8 x 50 from 8 clients), each exported from its 11th act
     (``analyze_run --export-bundle``) and replayed by ``replay_run``:
     every session journal-seeded, REPLAY BIT-EXACT, 0 capture drops, and
     exit 1 on another step's weights; the serve CLI (humanoid-sim, 64
     paced clients) under ``overload_storm``, watched in process by a
     ``MetricsAggregator`` + ``AlertEngine(default_rules)``: 0 alerts in
     the clean window, ``slo_p99`` and ``shed_rate`` fired and resolved,
     the log clean under ``validate_events`` and read by ``observatory
     --events``; capture's cost (64 clients, trace rate 1.0, off/on
     alternating); logs in ``build/chip_smoke/replay/``;
 24. ``[flywheel]`` the fleet orchestrator and the train→serve flywheel
     through their entry points: ``python -m trpo_torch.scripts.fleet``
     over 2 ``humanoid-sim`` members as published (grid seed=0..1, 3
     iterations each, 2 slots, ``--status-port 0``, one PBT round of 1
     iteration, ``seed1=sigterm@iter=2``): seed1 exits 75, requeues once
     and resumes at step 2 + 1 with its iterations gapless; the fleet
     ``/metrics`` carries a running member's ``trpo_fleet_member_*``
     iteration timing; the culled member respawns from the winner's
     step 3 with the reference's explore draw (its seed, computed here
     with the port's spec code); the gate exits 0, the logs pass
     ``validate_events``, and every member process launches K1 exactly
     Σ(cheap + 1) and K2 once an iteration (each read from that
     process's own counts); beside it ``python -m
     trpo_torch.scripts.flywheel_smoke`` at the reference's sizes
     (kill_promoter and its restart, the reward gate rejecting a
     regressed step, a torn step rejected by its reload, 0 client
     errors); logs in ``build/chip_smoke/flywheel/``;
 25. ``[compat]`` ``compat.discount`` on a CUDA tensor against the plain
     scan at K2's 2e-5 (the reference-style loop on ``trpo_torch.compat``
     runs in ``[examples]``);
 26. ``[examples]`` the user examples (``trpo_torch/scripts``), each in
     a counted child, all side by side: ``quickstart`` as published,
     ``pomdp_recurrent`` (2 iterations), ``mujoco_host`` on
     ``native:pendulum`` (2 iterations: K1 exactly Σ(cheap + 1), K2 2) and
     on its default ``gym:`` env (refused, naming gymnasium),
     ``population_sweep`` (4 cartpole members, 1 chunk of 2 iterations;
     the reference's ``--out`` keys), ``reference_style`` (the reference's
     hand-written loop on ``trpo_torch.compat``, 5 iterations: per
     iteration ms, host CG iterations and line-search probes, K2 once per
     path from ``compat.discount``), and ``learning_evidence``'s cartpole
     rung as published (300 iterations in chunks of 50) held to a best
     reading ≥ 400; each script's wall and launches;
 27. ``[mesh]`` data and sequence parallelism (``trpo_torch/parallel``)
     in children under ``torchrun`` (the parent holds no process group):
     leg 1 ``python -m trpo_torch.train --preset humanoid-sim
     --mesh-shape 1`` as published on an NCCL world of one (3
     iterations, a checkpoint each; K2 once an iteration, K1 never: the
     GGN operator on a mesh), resumed from step 2 bitwise the
     uninterrupted step 3, its step 2 against the meshless run (rtol
     1e-4, atol 1e-5); leg 2 ``make_sharded_fused_fvp`` at 37,536 x
     376-256-256-17 in a 10-iteration CG, f32 and bf16, against K1 and
     K1-bf16 alone (relative L2 1e-5, 1e-2), its ms a call beside theirs
     and the all-reduce's µs; leg 3, beside leg 1, two ranks on the one
     card over gloo: K1 over two halves of leg 2's rows, the seq GAE at
     (392, 128) on K2 per rank, ``cartpole-fleet`` as published on a
     ``data x seq`` mesh against one rank, ``Population(mesh)`` over 4
     ``humanoid-sim`` members with member 1 bitwise its solo run; leg 4,
     beside legs 1 and 3, ``python -m trpo_torch.train --preset
     humanoid-sim --mesh-shape 1,2 --mesh-axes data,model`` as published
     on two gloo ranks sharing the card (2 iterations, a checkpoint each;
     K2 once an iteration on each rank, K1 never), its step 1 against the
     meshless GGN run (rtol 1e-4, atol 1e-5), rank 0 holding its blocks of
     layers 0-1 and layer 2 whole, its checkpoint restored on one rank
     bitwise the gathered params; leg 5 ``pendulum`` on
     ``native:pendulum`` over two data ranks against one rank, 2
     iterations (the first at rtol 2e-4/atol 2e-5, the second within
     ``LEG5_ITER2_ATOL``), beside its witness: the one-rank run with its
     update's rows reordered (the same sums, reassociated), leg
     6 ``cartpole`` with 4 experts on ``data x expert`` and the
     ``cartpole-po`` GRU on ``data x model`` against one rank, with the
     model-axis all-reduce's µs a call; logs in
     ``build/chip_smoke/mesh/``;
 28. ``[bench]`` ``trpo_torch.bench``'s JSON line at the 50k shape.
Phases 18 and 26 run beside phase 27's first wave of children: their
children and those of [mesh]'s legs 1, 3-6 run side by side (their
checks are functional), and [mesh]'s timed leg 2 starts once all are done.
Each path (5-8, 10-17, 19-27) is driven with the launch counts set to 0
just before it and read just after ([chaos]'s, [replay]'s, [flywheel]'s,
[examples]' and [mesh]'s children in their own processes, fresh ones). The fused kernel's launches on each path
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
import re
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

    def make(policy, cfg, *a, **kw):
        update = real(policy, cfg, *a, **kw)

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
    """Leg 3: 16 clients on two in-process replicas; r0 is killed 1 s in,
    while it holds requests it cannot finish: from just before the kill
    its handlers wait at its batcher for a release that comes only after
    the kill, so the requests seen in flight are lost with it. No client
    sees an error, the router retries, and r0 is relaunched and answers
    again."""
    import http.client
    import threading

    from trpo_torch.serve import Router

    hold, release = threading.Event(), threading.Event()

    def factory(rid):
        make = _ff_replica(loads, agent, params)
        if rid != "r0":
            return make

        def gated():
            server, closers = make()
            submit = server.batcher.submit

            def held(*args, **kw):
                if hold.is_set():
                    release.wait(60)
                return submit(*args, **kw)

            server.batcher.submit = held
            return server, closers
        return gated

    rs = _in_process_set(factory, 2)
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
        # kill r0 while it holds requests it cannot finish: they are lost
        # with it
        hold.set()
        deadline = time.monotonic() + 10
        while (rs.replicas["r0"].inflight == 0
               and time.monotonic() < deadline):
            time.sleep(0.001)
        inflight = rs.replicas["r0"].inflight
        t_kill = time.perf_counter()
        rs.replicas["r0"].handle.kill()
        release.set()
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
        release.set()
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
    ``/metrics`` scraped by a thread while it runs."""
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


def _obs_overhead(torch, dev, work: Path, card: str) -> dict:
    """Leg 2, in this process on the flagship state: ``learn`` with
    telemetry off and on (bus + JSONL + health + status server), runs of 3
    iterations in the order off, on, on, off, after an audited
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
    # off, on, on, off: the host clock drifts over a process. The
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

    for mode in ("off", "on", "on", "off"):
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
          f"{counts.get('reverse_scan', 0)}; iteration ms, median of 6 "
          f"(runs of 3: off, on, on, off), telemetry off "
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


def _obs_serving_start(dev, ck_dir: str, work: Path) -> dict:
    """Leg 3's servers: ``python -m trpo_torch.serve --replicas 2`` over
    two ``--replica-cmd`` children (each with its own event log), with
    ``--metrics-jsonl`` and ``--trace-sample-rate`` at each rate, the three
    sets started together (one startup wait). Returns rate -> run."""
    runs = {}
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
    except BaseException:
        _obs_serving_stop(runs)
        raise
    return runs


def _obs_serving_stop(runs: dict) -> None:
    """Stop every serve CLI still running: SIGTERM first, so each stops
    its replica children, then SIGKILL what is left after 30 s."""
    live = [r["child"] for r in runs.values() if r["child"].poll() is None]
    for child in live:
        child.send_signal(signal.SIGTERM)
    for child in live:
        try:
            child.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            child.kill()
            child.communicate(timeout=60)


def _obs_serving(runs: dict, work: Path, card: str) -> None:
    """Leg 3: the servers of ``_obs_serving_start``, once all are up, take
    the load in turn: /act at 64 clients x 20; every record valid, every
    sampled trace with its root; at rate 0 a child killed under requests
    must still be traced (the retry is forced)."""
    from trpo_torch.obs.events import validate_event

    t0 = time.perf_counter()
    try:
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
        _obs_serving_stop(runs)
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
    print(f"[obs] the three serving sets (6 children), started beside the "
          f"train CLI, all up {up_s:.2f} s after the overhead leg; each took "
          f"its load while the other two idled ({card})", flush=True)


def phase_obs(torch, dev):
    """The run-event bus, the tracer and live training telemetry: the
    train CLI with every telemetry flag (a subprocess, as users run it),
    the solver counter against K1 and the telemetry overhead in process,
    and the replicated server's traces at three rates. The servers start
    beside the train CLI, on a checkpoint of the flagship's initial
    weights, so their startup costs no leg; the overhead leg runs while
    they idle up."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.utils.checkpoint import Checkpointer

    card = _card_line()
    work = WORK / "obs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    serve_ck = work / "serve_ck"
    agent = TRPOAgent("humanoid-sim", get_preset("humanoid-sim"), device=dev)
    Checkpointer(str(serve_ck)).save(1, agent.init_state(seed=0))
    del agent
    runs = _obs_serving_start(dev, str(serve_ck), work)
    try:
        _obs_train_cli(torch, dev, work, card)
        counts = _obs_overhead(torch, dev, work, card)
        _obs_serving(runs, work, card)
    finally:
        _obs_serving_stop(runs)
    return counts


# ---------------------------------------------------------------------------
# [chaos] the fault injector through the trainer and the router
# ---------------------------------------------------------------------------

CHAOS_TRAIN_FAULTS = "nan_update@iter=2;sigterm@iter=4"
CHAOS_CLI_FAULTS = "kill_replica@request=200:replica=0"
CHAOS_ROUTER_FAULTS = ("kill_replica@request=200:replica=0;"
                       "stall_replica@request=800:replica=1:seconds=2")
CHAOS_WEDGE_STEP = 5
CHAOS_ACT_TIMEOUT = 0.5   # the router leg's per-hop timeout. A pooled
#                           connection that times out gets one fresh dial,
#                           so a stall is detected at 2 x 0.5 s: the 2 s
#                           stall outlasts that by 1 s
CHAOS_RETRY_BUDGET = 128  # the router leg's retry tokens: a kill and a
#                           stall a second apart under 64 clients owe up
#                           to 2 x 64 retries; the CLI keeps the
#                           reference's 8, and its leg measures the loss
CHAOS_CLEAN_S = 3.0       # the clean window's length


def _update_records(log) -> list:
    """The recorder's updates (``_updates``) as JSON records."""
    return [{"launched": launched, "cheap": int(cheap), "used": int(used),
             "fallback": bool(fallback)}
            for launched, cheap, used, fallback in log]


def _counted_child(counts_path: str, module: str = "trpo_torch.train") -> int:
    """Run in a child process: ``python -m <module>`` (by runpy, with this
    process's argv) under the update recorder, then write the process's
    launch counts, each update's record and the module's wall seconds to
    ``counts_path``. A fresh process starts every count at 0."""
    import runpy

    from trpo_torch.ops import _build

    code = 1
    t0 = time.perf_counter()
    with _updates() as log:
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
        updates = _update_records(log)
    Path(counts_path).write_text(json.dumps({
        "launches": dict(_build.LAUNCHES), "updates": updates,
        "wall_s": time.perf_counter() - t0}))
    return code


def _events(path: Path) -> list:
    """The records of a log, which another process may still be appending
    to: a torn last line is left for the next read."""
    out = []
    for line in (path.read_text().splitlines() if path.exists() else []):
        try:
            out.append(json.loads(line))
        except ValueError:
            break
    return out


def _after(recs, t0, pred):
    """The first record at or after time ``t0`` that satisfies ``pred``."""
    return next((r for r in recs if r["t"] >= t0 and pred(r)), None)


def _chaos_train(torch, dev, work: Path, card: str):
    """The train leg: ``python -m trpo_torch.train --preset humanoid-sim``
    in a child, NaN-poisoned before iteration 2 (restored and replayed)
    and SIGTERMed before iteration 4 (exit 75). Returns (the child's launch
    counts, the checkpoint directory, the chaos records)."""
    from trpo_torch.obs.events import validate_event
    from trpo_torch.utils.checkpoint import Checkpointer

    ck, ev, rows_path = work / "ck", work / "train.jsonl", work / "rows.jsonl"
    counts_path = work / "train_counts.json"
    argv = [sys.executable, "-c",
            "import sys, chip_smoke as cs; "
            "sys.exit(cs._counted_child(sys.argv.pop(1)))",
            str(counts_path), "--preset", "humanoid-sim", "--device",
            dev.type, "--iterations", "6", "--inject-faults",
            CHAOS_TRAIN_FAULTS, "--recover-on-nan", "restore",
            "--on-preempt", "checkpoint", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "1", "--log-jsonl", str(rows_path),
            "--metrics-jsonl", str(ev), "--health-checks"]
    t0 = time.perf_counter()
    child = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
    wall = time.perf_counter() - t0
    out = child.stdout + child.stderr
    _check(child.returncode == 75,
           f"[chaos] train CLI exit {child.returncode} (expected 75):\n"
           f"{out[-3000:]}")
    recs = _events(ev)
    bad = [(r.get("kind"), validate_event(r)) for r in recs
           if validate_event(r)]
    _check(not bad, f"[chaos] invalid train events: {bad[:3]}")
    faults = [r for r in recs if r["kind"] == "fault_injected"]
    _check([f["spec"] for f in faults] == CHAOS_TRAIN_FAULTS.split(";"),
           f"[chaos] train faults fired: {[f['spec'] for f in faults]}")
    nan_f, term_f = faults
    recovery = _after(recs, nan_f["t"], lambda r: r["kind"] == "recovery")
    preempted = _after(recs, term_f["t"], lambda r: r["kind"] == "health"
                       and r["check"] == "preempted")
    _check(recovery is not None and recovery["iteration"] == 2,
           f"[chaos] nan_update without its recovery: {recovery}")
    _check(preempted is not None, "[chaos] sigterm without a preempted "
           "health record")
    rows = [json.loads(x) for x in rows_path.read_text().splitlines()]
    its = [r["iteration"] for r in rows]
    _check(its == [1, 2, 2, 3, 4], f"[chaos] logged iterations {its}")
    poisoned, replayed = rows[1], rows[2]
    _check(poisoned["entropy"] != poisoned["entropy"],
           f"[chaos] the poisoned row is finite: {poisoned['entropy']}")
    for k in ("entropy", "kl_old_new", "surrogate_loss", "vf_loss"):
        _check(_finite(torch, replayed[k]),
               f"[chaos] replayed iteration 2: {k} = {replayed[k]}")
    step = Checkpointer(str(ck)).latest_step()
    _check(step == rows[-1]["iteration"] == 4,
           f"[chaos] newest checkpoint {step}, last row {rows[-1]}")
    # K1 and K2 in the child, exactly: every update launches K1 its cheap
    # solve's iterations + 1 (the poisoned one: 0 + 1, its CG exits at
    # once on a NaN residual), K2 once an iteration run
    counts = json.loads(counts_path.read_text())
    launches, updates = counts["launches"], counts["updates"]
    _check(len(updates) == len(rows),
           f"[chaos] {len(updates)} updates for {len(rows)} rows")
    for i, (u, r) in enumerate(zip(updates, rows)):
        _check(u["launched"]["fused_fvp"] == u["cheap"] + 1,
               f"[chaos] update {i + 1}: K1 {u['launched']} for a cheap "
               f"solve of {u['cheap']}")
        _check(u["used"] == r["cg_iterations"],
               f"[chaos] update {i + 1}: {u['used']} against the row's "
               f"{r['cg_iterations']}")
    expected = sum(u["cheap"] + 1 for u in updates)
    _check(launches.get("fused_fvp", 0) == expected,
           f"[chaos] K1 launched {launches.get('fused_fvp', 0)}, expected "
           f"{expected}")
    _check(launches.get("reverse_scan", 0) == len(rows),
           f"[chaos] K2 launched {launches.get('reverse_scan', 0)} for "
           f"{len(rows)} iterations")
    plain = {k: n for k, n in launches.items() if k.endswith("_plain") and n}
    _check(not plain, f"[chaos] a plain version ran: {plain}")
    it_events = [r for r in recs if r["kind"] == "iteration"]
    clean_after = _after(it_events, nan_f["t"], lambda r: r["iteration"] == 2
                         and r["stats"]["entropy"] == r["stats"]["entropy"])
    _check(clean_after is not None, "[chaos] no clean iteration-2 event "
           "after the fault")
    fault_to_clean = clean_after["t"] - nan_f["t"]
    print(f"[chaos] train CLI (humanoid-sim as published, 6 iterations, "
          f"{CHAOS_TRAIN_FAULTS}, --recover-on-nan restore): exit 75 in "
          f"{wall:.1f} s; rows {its}; iteration 2 poisoned (entropy nan, "
          f"cg_iterations {poisoned['cg_iterations']}) then replayed "
          f"finite (entropy {replayed['entropy']:.6g}); recovery restored "
          f"to {recovery['restored_to']}; preempted at step "
          f"{preempted['data']['step']}; newest checkpoint {step} = last "
          f"row; fault to the first clean row {fault_to_clean:.3f} s; "
          f"iteration_ms poisoned {poisoned['iteration_ms']:.1f}, replayed "
          f"{replayed['iteration_ms']:.1f}, clean (iteration 3) "
          f"{rows[3]['iteration_ms']:.1f}, audited (1) "
          f"{rows[0]['iteration_ms']:.1f}; K1 {launches['fused_fvp']} = "
          f"Σ(cheap + 1) over {len(updates)} updates (cheap "
          f"{[u['cheap'] for u in updates]}; the rewound update "
          f"{updates[1]['launched']['fused_fvp']}; the restored state's "
          f"cg_iters_total {rows[-1]['cg_iters_total']} leaves it out, and "
          f"counts update 1's full solve, not its cheap one); K2 "
          f"{launches['reverse_scan']} ({card})", flush=True)
    records = [
        {"leg": "train", "fault": "nan_update", "spec": nan_f["spec"],
         "response": "recovery", "delay_s": recovery["t"] - nan_f["t"],
         "first_clean_row_s": fault_to_clean},
        {"leg": "train", "fault": "sigterm", "spec": term_f["spec"],
         "response": "preempted", "delay_s": preempted["t"] - term_f["t"],
         "exit_code": child.returncode},
    ]
    return {k: v for k, v in launches.items() if v}, str(ck), records


def _chaos_load(port: int, samples: list, lock, stop):
    """``CONTROL_CLIENTS`` keep-alive clients on ``port`` until ``stop``:
    each answer is ``(sent, answered, status, step, finite, error)`` in
    ``samples``; a transport error is status -1."""
    import http.client
    import threading

    def client(k):
        r = np.random.default_rng(7000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while not stop.is_set():
                t0 = time.time()
                try:
                    st, ans = _post(conn, "/act", {
                        "obs": r.standard_normal(376).tolist()})
                except Exception as e:  # counted as a client error
                    st, ans = -1, repr(e)
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=60)
                t1 = time.time()
                ok = st == 200
                with lock:
                    samples.append((
                        t0, t1, st, ans.get("step") if ok else None,
                        ok and bool(np.all(np.isfinite(
                            np.asarray(ans["action"], float)))),
                        None if ok else str(ans.get("code") or ans.get(
                            "error") if isinstance(ans, dict) else ans)))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(CONTROL_CLIENTS)]
    for t in threads:
        t.start()
    return threads


def _chaos_window(samples, a, b):
    """requests/s, p50, p99 and count of the answers sent in [a, b)."""
    lat = [(s[1] - s[0]) * 1e3 for s in samples if a <= s[0] < b]
    p50, p99 = _quantiles(lat)
    return len(lat) / (b - a), p50, p99, len(lat)


def _replica_event(recs, f, states):
    """The first router record after fault ``f`` that puts ``f``'s own
    replica in one of ``states``."""
    return _after(recs, f["t"], lambda r: r["kind"] == "router"
                  and r.get("scope") == "replica"
                  and r.get("replica") == f["replica"]
                  and r.get("state") in states)


def _chaos_serve_cli(torch, dev, ck_dir: str, work: Path,
                     card: str) -> list:
    """The serve CLI as users arm it: ``python -m trpo_torch.serve
    --replicas 2`` on the train leg's checkpoint (step 4) under 64
    clients, its router at the reference's fixed act timeout and retry
    bucket, a replica killed at request 200, then a step 5 wedged (NaN
    params) through the canary. Every fault must fire and meet its
    response; the answers the kill costs are measured, and each must be
    a retry the bucket shed."""
    import threading

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.obs.events import validate_event
    from trpo_torch.utils.checkpoint import Checkpointer

    ev, desc = work / "serve_cli.jsonl", work / "serve_run.json"
    specs = CHAOS_CLI_FAULTS + f";wedge_reload@step={CHAOS_WEDGE_STEP}"
    t_start = time.perf_counter()
    # the child's output goes to a file, kept if it hangs; SIGABRT makes
    # it print every thread's stack (PYTHONFAULTHANDLER)
    log_path = work / "serve_cli.log"
    log = open(log_path, "w")
    child = subprocess.Popen(
        [sys.executable, "-m", "trpo_torch.serve", "--device", dev.type,
         "--preset", "humanoid-sim", "--checkpoint-dir", ck_dir,
         "--port", "0", "--replicas", "2", "--health-interval", "0.1",
         "--canary-fraction", "0.25", "--canary-window", "24",
         "--poll-interval", "0.2", "--inject-faults", specs,
         "--metrics-jsonl", str(ev), "--run-descriptor", str(desc)],
        cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONFAULTHANDLER": "1"})
    stop = threading.Event()
    samples, lock = [], threading.Lock()
    try:
        deadline = time.monotonic() + 300
        while not desc.exists():
            _check(child.poll() is None and time.monotonic() < deadline,
                   f"[chaos] the serve CLI: {child.poll()}")
            time.sleep(0.1)
        url = json.loads(desc.read_text())["url"]

        def status():
            return json.loads(_get_url(url + "/status"))

        while status()["healthy"] < 2:
            _check(time.monotonic() < deadline, "[chaos] serve replicas")
            time.sleep(0.1)
        up_s = time.perf_counter() - t_start
        threads = _chaos_load(int(url.rsplit(":", 1)[1]), samples, lock,
                              stop)
        # the kill fires on the request clock; wait for r0 to be back
        fired = []
        while True:
            _check(time.monotonic() < deadline and child.poll() is None,
                   f"[chaos] faults fired: {[f['spec'] for f in fired]}")
            fired = [r for r in _events(ev) if r["kind"] == "fault_injected"]
            snap = status()
            if (fired and snap["healthy"] == 2
                    and snap["replicas"]["r0"]["restarts"] >= 1):
                break
            time.sleep(0.1)
        t_recovered = time.time()
        time.sleep(CHAOS_CLEAN_S)
        t_clean_end = time.time()
        # a step 5 published: the canary loads it wedged (NaN) and the
        # gate must roll it back
        agent = TRPOAgent("humanoid-sim", get_preset("humanoid-sim"),
                          device=dev)
        state = Checkpointer(ck_dir).restore(agent.init_state())
        t_publish = time.time()
        Checkpointer(ck_dir).save(CHAOS_WEDGE_STEP, state)
        del agent, state
        while True:
            _check(time.monotonic() < deadline and child.poll() is None,
                   "[chaos] no canary terminal for the wedged step")
            terminal = [r for r in _events(ev) if r["kind"] == "canary"
                        and r["step"] == CHAOS_WEDGE_STEP
                        and r["event"] in ("promoted", "rolled_back")]
            if terminal:
                break
            time.sleep(0.1)
        t_rolled = terminal[0]["t"]
        time.sleep(1.0)  # answers after the rollback
        stop.set()
        for t in threads:
            t.join(timeout=120)
        counters = status()["counters"]
        child.send_signal(signal.SIGTERM)
        try:
            child.wait(timeout=120)
        except subprocess.TimeoutExpired:
            child.send_signal(signal.SIGABRT)
            child.wait(timeout=60)
            raise SmokeFailure(
                "[chaos] the serve CLI did not exit within 120 s of "
                f"SIGTERM; its threads at SIGABRT, from {log_path}:\n"
                f"{log_path.read_text()[-6000:]}") from None
        text = log_path.read_text()
        _check(child.returncode == 0,
               f"[chaos] serve CLI exit {child.returncode}: {text[-3000:]}")
    finally:
        stop.set()
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        log.close()
    recs = _events(ev)
    bad = [(r.get("kind"), validate_event(r)) for r in recs
           if validate_event(r)]
    _check(not bad, f"[chaos] invalid serve CLI events: {bad[:3]}")
    faults = [r for r in recs if r["kind"] == "fault_injected"]
    _check(sorted(f["spec"] for f in faults) == sorted(specs.split(";")),
           f"[chaos] serve CLI faults fired: {[f['spec'] for f in faults]}")
    by = {f["fault"]: f for f in faults}
    kill, wedge = by["kill_replica"], by["wedge_reload"]
    kill_resp = _replica_event(recs, kill, ("died", "evicted"))
    kill_back = _replica_event(recs, kill, ("healthy",))
    _check(kill_resp is not None and kill_back is not None,
           f"[chaos] serve CLI kill_replica r0: down {kill_resp}, back "
           f"{kill_back}")
    rolled = next(r for r in recs if r["kind"] == "canary"
                  and r["step"] == CHAOS_WEDGE_STEP
                  and r["event"] in ("promoted", "rolled_back"))
    _check(rolled["event"] == "rolled_back",
           f"[chaos] wedged step {CHAOS_WEDGE_STEP}: {rolled}")
    # at the reference's bucket a kill may cost answers: each must be the
    # router's 502 for a retry its bucket shed, or the 503 of the
    # stateless shed that the pressure of those sheds turns on
    errors = [s for s in samples if s[2] != 200]
    shed_retry = [s for s in errors if s[2] == 502]
    shed_stateless = [s for s in errors
                      if s[2] == 503 and s[5] == "shed_stateless"]
    _check(len(shed_retry) + len(shed_stateless) == len(errors)
           and len(shed_retry) == counters["failed_total"]
           <= counters["retries_skipped_total"]
           and len(shed_stateless) == counters["shed_stateless_total"],
           f"[chaos] serve CLI: {len(errors)} client errors "
           f"{sorted({(s[2], s[5]) for s in errors})}, at "
           f"{sorted(round(s[0] - kill['t'], 3) for s in errors)[:8]}... s "
           f"after the kill (r0 back at "
           f"{kill_back['t'] - kill['t']:.3f} s, the wedge loaded at "
           f"{wedge['t'] - kill['t']:.3f} s); router counters {counters}")
    wedged = [s for s in samples if s[3] == CHAOS_WEDGE_STEP]
    late = [s for s in wedged if s[0] > t_rolled]
    _check(not late, f"[chaos] {len(late)} answers from the wedged step "
           "to requests sent after its rollback")
    _check(all(not s[4] for s in wedged) and all(
        s[4] for s in samples if s[3] not in (None, CHAOS_WEDGE_STEP)),
        "[chaos] the wedged step's answers must be the only nonfinite ones")
    f_rps, f50, f99, fn = _chaos_window(samples, kill["t"], kill_back["t"])
    c_rps, c50, c99, cn = _chaos_window(samples, t_recovered, t_clean_end)
    answered = len(samples) - len(errors)
    print(f"[chaos] serve CLI (humanoid-sim, --replicas 2, canary 0.25, "
          f"the reference's router: 30 s act timeout, 8 retry tokens; "
          f"{CONTROL_CLIENTS} clients): up in {up_s:.1f} s; every spec "
          f"fired ({specs}); kill_replica r0 -> {kill_resp['state']} in "
          f"{kill_resp['t'] - kill['t']:.3f} s, healthy again "
          f"{kill_back['t'] - kill['t']:.3f} s after the kill; "
          f"{counters['retried_total']} retried, "
          f"{counters['retries_skipped_total']} retries shed; "
          f"{len(errors)} client errors: {len(shed_retry)} 502 for a shed "
          f"retry, {len(shed_stateless)} 503 shed_stateless; step "
          f"{CHAOS_WEDGE_STEP} wedged, rolled back "
          f"{rolled['t'] - wedge['t']:.3f} s after its load "
          f"({rolled.get('reason')}; published "
          f"{wedge['t'] - t_publish:.3f} s before the load); its "
          f"{len(wedged)} answers all nonfinite, all inside its gate "
          f"window, none after; {answered} answers; faulted window "
          f"({kill_back['t'] - kill['t']:.2f} s) {f_rps:.1f} requests/s "
          f"p50 {f50:.2f} p99 {f99:.2f} ms ({fn}); clean window "
          f"({CHAOS_CLEAN_S:g} s) {c_rps:.1f} requests/s p50 {c50:.2f} "
          f"p99 {c99:.2f} ms ({cn}) ({card})", flush=True)
    return [
        {"leg": "serve_cli", "fault": "kill_replica", "spec": kill["spec"],
         "response": kill_resp["state"],
         "delay_s": kill_resp["t"] - kill["t"],
         "healthy_again_s": kill_back["t"] - kill["t"],
         "client_errors": len(errors),
         "retries": counters["retried_total"],
         "retries_shed": counters["retries_skipped_total"],
         "errors_502_shed_retry": len(shed_retry),
         "errors_503_shed_stateless": len(shed_stateless)},
        {"leg": "serve_cli", "fault": "wedge_reload", "spec": wedge["spec"],
         "response": "canary rolled_back",
         "delay_s": rolled["t"] - wedge["t"],
         "wedged_answers": len(wedged)},
        {"leg": "serve_cli", "window": "faulted", "requests_per_s": f_rps,
         "p50_ms": f50, "p99_ms": f99, "requests": fn},
        {"leg": "serve_cli", "window": "clean", "requests_per_s": c_rps,
         "p50_ms": c50, "p99_ms": c99, "requests": cn},
    ]


def _chaos_serve_router(torch, dev, ck_dir: str, work: Path,
                        card: str) -> list:
    """The router with its timeout and bucket set: two in-process
    ``humanoid-sim`` replicas (as the CLI builds them) on the train leg's
    checkpoint behind ``Router(act_timeout_s=0.5, retry_budget=128,
    injector=...)`` under 64 clients, a replica killed at request 200 and
    the other stalled past the act timeout at request 800. Each fault must
    fire and be met by its own replica's died/evicted record; 0 client
    errors."""
    import threading

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.obs.events import (
        EventBus,
        JsonlSink,
        manifest_fields,
        validate_event,
    )
    from trpo_torch.resilience import FaultInjector
    from trpo_torch.serve import Router
    from trpo_torch.utils.checkpoint import Checkpointer

    ev = work / "serve_router.jsonl"
    agent = TRPOAgent("humanoid-sim", get_preset("humanoid-sim"),
                      device=dev)
    state = Checkpointer(ck_dir).restore(agent.init_state())
    bus = EventBus(JsonlSink(str(ev)))
    bus.emit("run_manifest", **manifest_fields(agent.cfg, extra={
        "driver": "serve", "checkpoint_dir": ck_dir, "replicas": 2,
        "recurrent": False, "act_timeout_s": CHAOS_ACT_TIMEOUT,
        "retry_budget": CHAOS_RETRY_BUDGET}, device=agent.device))
    injector = FaultInjector.from_spec(CHAOS_ROUTER_FAULTS)
    injector.bus = bus
    loads = _Loads()
    stop = threading.Event()
    samples, lock = [], threading.Lock()
    # the CLI's supervision: health every 0.1 s, relaunch backoff 0.5 s
    rs = _in_process_set(lambda rid: _ff_replica(
        loads, agent, state.policy_params, replica_name=rid), 2,
        backoff=0.5, bus=bus)
    router = Router(rs, port=0, act_timeout_s=CHAOS_ACT_TIMEOUT,
                    retry_budget=CHAOS_RETRY_BUDGET, injector=injector,
                    bus=bus)
    try:
        threads = _chaos_load(router.port, samples, lock, stop)
        deadline = time.monotonic() + 120
        # the kill and the stall fire on the request clock; wait for both
        # replicas to be back from them
        while True:
            _check(time.monotonic() < deadline,
                   f"[chaos] router leg: unfired {injector.unfired}, "
                   f"{rs.snapshot()}")
            snap = rs.snapshot()
            if (not injector.unfired and snap["healthy"] == 2
                    and all(snap["replicas"][rid]["restarts"] >= 1
                            for rid in ("r0", "r1"))):
                break
            time.sleep(0.1)
        t_recovered = time.time()
        time.sleep(CHAOS_CLEAN_S)
        t_clean_end = time.time()
        stop.set()
        for t in threads:
            t.join(timeout=120)
        retried = router.retried_total
    finally:
        stop.set()
        router.close()
        rs.close()
        bus.close()
    recs = _events(ev)
    bad = [(r.get("kind"), validate_event(r)) for r in recs
           if validate_event(r)]
    _check(not bad, f"[chaos] invalid router events: {bad[:3]}")
    faults = [r for r in recs if r["kind"] == "fault_injected"]
    _check(sorted(f["spec"] for f in faults)
           == sorted(CHAOS_ROUTER_FAULTS.split(";")),
           f"[chaos] router faults fired: {[f['spec'] for f in faults]}")
    by = {f["fault"]: f for f in faults}
    kill, stall = by["kill_replica"], by["stall_replica"]
    kill_resp = _replica_event(recs, kill, ("died", "evicted"))
    stall_resp = _replica_event(recs, stall, ("died", "evicted"))
    _check(kill_resp is not None, "[chaos] kill_replica r0 unmatched")
    _check(stall_resp is not None, "[chaos] stall_replica r1 unmatched")
    kill_back = _replica_event(recs, kill, ("healthy",))
    stall_back = _replica_event(recs, stall, ("healthy",))
    _check(kill_back is not None and stall_back is not None,
           f"[chaos] router leg: back {kill_back}, {stall_back}")
    errors = [s for s in samples if s[2] != 200]
    if errors:
        moments = {"kill": kill["t"], "stall": stall["t"],
                   "r0 back": kill_back["t"], "r1 back": stall_back["t"]}
        when = {k: round(v - kill["t"], 3) for k, v in moments.items()}
        raise SmokeFailure(
            f"[chaos] router leg: {len(errors)} client errors, sent at "
            f"{sorted(round(s[0] - kill['t'], 3) for s in errors)[:8]}... "
            f"s after the kill (faults and recoveries at {when}); "
            f"statuses {sorted({s[2] for s in errors})}")
    _check(all(s[4] for s in samples), "[chaos] router leg: a nonfinite "
           "answer")
    t_fault1 = max(kill_back["t"], stall_back["t"])
    f_rps, f50, f99, fn = _chaos_window(samples, kill["t"], t_fault1)
    c_rps, c50, c99, cn = _chaos_window(samples, t_recovered, t_clean_end)
    print(f"[chaos] router (humanoid-sim, 2 in-process replicas, "
          f"act_timeout_s {CHAOS_ACT_TIMEOUT:g}, retry_budget "
          f"{CHAOS_RETRY_BUDGET}, {CONTROL_CLIENTS} clients): every spec "
          f"fired ({CHAOS_ROUTER_FAULTS}); kill_replica r0 -> "
          f"{kill_resp['state']} in {kill_resp['t'] - kill['t']:.3f} s, "
          f"healthy again {kill_back['t'] - kill['t']:.3f} s after the "
          f"kill; stall_replica r1 -> {stall_resp['state']} in "
          f"{stall_resp['t'] - stall['t']:.3f} s, healthy again "
          f"{stall_back['t'] - stall['t']:.3f} s after; {len(samples)} "
          f"answers, 0 client errors, {retried} retried; faulted window "
          f"({t_fault1 - kill['t']:.2f} s) {f_rps:.1f} requests/s p50 "
          f"{f50:.2f} p99 {f99:.2f} ms ({fn}); clean window "
          f"({CHAOS_CLEAN_S:g} s) {c_rps:.1f} requests/s p50 {c50:.2f} "
          f"p99 {c99:.2f} ms ({cn}) ({card})", flush=True)
    return [
        {"leg": "serve_router", "fault": "kill_replica",
         "spec": kill["spec"], "response": kill_resp["state"],
         "delay_s": kill_resp["t"] - kill["t"],
         "healthy_again_s": kill_back["t"] - kill["t"]},
        {"leg": "serve_router", "fault": "stall_replica",
         "spec": stall["spec"], "response": stall_resp["state"],
         "delay_s": stall_resp["t"] - stall["t"],
         "healthy_again_s": stall_back["t"] - stall["t"]},
        {"leg": "serve_router", "window": "faulted",
         "requests_per_s": f_rps, "p50_ms": f50, "p99_ms": f99,
         "requests": fn},
        {"leg": "serve_router", "window": "clean", "requests_per_s": c_rps,
         "p50_ms": c50, "p99_ms": c99, "requests": cn},
    ]


def _chaos_gymproc(torch, dev) -> dict:
    """``TRPOAgent("gymproc:CartPole-v1", ..., device=dev)``: without
    gymnasium it must raise naming it before any worker process starts;
    where gymnasium is installed, the supervised pool builds instead."""
    import importlib.util
    import multiprocessing

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig

    cfg = TRPOConfig(env="gymproc:CartPole-v1", n_envs=2, batch_timesteps=8)
    before = multiprocessing.active_children()
    if importlib.util.find_spec("gymnasium") is None:
        try:
            TRPOAgent(cfg.env, cfg, device=dev)
        except RuntimeError as e:
            msg = str(e)
        else:
            raise SmokeFailure("[chaos] gymproc: built without gymnasium")
        _check("gymnasium" in msg, f"[chaos] gymproc: refusal {msg!r}")
        _check(multiprocessing.active_children() == before,
               "[chaos] a worker process started before the refusal")
        print(f"[chaos] gymproc: refused on this machine (no gymnasium), "
              f"no worker started: RuntimeError: {msg}", flush=True)
        return {"leg": "gymproc", "response": "refused", "message": msg}
    agent = TRPOAgent(cfg.env, cfg, device=dev)
    try:
        agent.run_iteration(agent.init_state())
    finally:
        agent.env.close()
    print("[chaos] gymproc: gymnasium is installed here; the supervised "
          "pool built and ran one iteration", flush=True)
    return {"leg": "gymproc", "response": "ran"}


def phase_chaos(torch, dev):
    """The fault injector (``trpo_torch.resilience``) through the flagship
    trainer and the replicated server, as users run them (subprocesses),
    through the router with its timeout and retry bucket set (in
    process), and the ``gymproc:`` refusal. Returns the train child's
    launches."""
    from trpo_torch.ops import _build

    card = _card_line()
    work = WORK / "chaos"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    counts, ck_dir, records = _chaos_train(torch, dev, work, card)
    t1 = time.perf_counter()
    records += _chaos_serve_cli(torch, dev, ck_dir, work, card)
    records += _chaos_serve_router(torch, dev, ck_dir, work, card)
    t2 = time.perf_counter()
    records.append(_chaos_gymproc(torch, dev))
    here = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check(not here, f"[chaos] launches in the measuring process: {here}")
    with open(work / "chaos.jsonl", "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    print("[chaos] summary: " + "; ".join(
        f"{r['fault']} -> {r['response']} in {r['delay_s']:.3f} s"
        for r in records if "fault" in r)
        + f"; legs train {t1 - t0:.1f} s, serve {t2 - t1:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s; records in "
        f"{(work / 'chaos.jsonl').relative_to(ROOT)}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# [replay] capture, deterministic replay, offline analysis and alerts
# ---------------------------------------------------------------------------

REPLAY_ITERS = 5          # the observed train child's iterations
REPLAY_ACTS = 50          # acts per session in each recorded window
REPLAY_MID = 10           # each window opens after this many acts
REPLAY_PACE_S = 1.6       # each of the storm leg's 64 clients sends ~0.6
#                           requests/s: 40/s offered, an eighth of what
#                           that server (2 in-process replicas, every
#                           request an event on its log) routes on the card;
#                           at 80/s a host at half the usual speed held ~16
#                           requests in flight, the admission limit, and
#                           shed in the clean window
REPLAY_CALIBRATE_S = 10.5  # the SLO's readings start once the router's
#                            10 s recent window holds no connection's
#                            first request
REPLAY_CALIBRATE_PEAK_S = 10.0  # and run this long: the SLO sits over
#                                 the peak of the clean steady state, not
#                                 one reading of it (a single 10 s p99 of
#                                 ~400 requests moved 2.2x on a clean load)
REPLAY_STORM_AT = 970     # the storm's request clock: ~24 s at the paced
#                           load, so the clean window runs ~3 s armed
REPLAY_STORMS = 4          # storms at once, 16 workers each
REPLAY_STORM = ";".join(
    f"overload_storm@request={REPLAY_STORM_AT + i}:rps=8000:seconds=8"
    for i in range(REPLAY_STORMS))
REPLAY_SLO_X = 2.0         # the SLO over the calibrated clean p99
REPLAY_STORM_INFLIGHT = 8  # per replica: 16 admitted, the rest shed
REPLAY_COST_PER = 8       # requests per client in a capture-cost run


def _spawn(argv, log: Path, err: Path = None):
    """A child process of the port's entry points, its output in ``log``
    (a pipe left unread could fill and stall it), its errors there too or
    in ``err`` (a JSON answer must stay parseable)."""
    f = open(log, "w")
    e = open(err, "w") if err is not None else None
    try:
        return subprocess.Popen(argv, cwd=str(ROOT), stdout=f,
                                stderr=e or subprocess.STDOUT, text=True)
    finally:
        f.close()
        if e is not None:
            e.close()



def _tool(*argv) -> list:
    return [sys.executable, "-m", *argv]


def _finish(children: dict, timeout: float = 300) -> dict:
    """Wait for every ``name -> (Popen, log)``: ``name -> (code, output)``."""
    out = {}
    deadline = time.monotonic() + timeout
    for name, (proc, log) in children.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out[name] = (proc.returncode, Path(log).read_text())
    return out


def _serve_up(child, desc: Path, log: Path, what: str,
              timeout: float = 300) -> str:
    """The URL of a serve CLI child once its replicas are all healthy."""
    deadline = time.monotonic() + timeout
    while not desc.exists():
        _check(child.poll() is None and time.monotonic() < deadline,
               f"[replay] {what}: exit {child.poll()}:\n"
               f"{log.read_text()[-3000:]}")
        time.sleep(0.1)
    url = json.loads(desc.read_text())["url"]
    while json.loads(_get_url(url + "/status"))["healthy"] < 2:
        _check(time.monotonic() < deadline, f"[replay] {what}: replicas")
        time.sleep(0.1)
    return url


def _stop_serve(child, log: Path, what: str) -> None:
    child.send_signal(signal.SIGTERM)
    try:
        child.wait(timeout=60)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
    _check(child.returncode == 0, f"[replay] {what}: exit "
           f"{child.returncode}:\n{log.read_text()[-3000:]}")


def _metric(text: str, name: str) -> float:
    rows = [ln for ln in text.splitlines() if ln.startswith(name + " ")]
    _check(len(rows) == 1, f"[replay] /metrics {name}: {rows}")
    return float(rows[0].split()[1])


def _replay_train(torch, dev, work: Path, card: str):
    """Leg 1: ``python -m trpo_torch.train --preset humanoid-sim`` as
    published, 5 iterations, watched while it runs by the observatory's
    aggregator (in process, ticking) and by ``observatory --targets
    train=URL --once --json`` frames; then ``analyze_run`` (summary and a
    self-compare) and ``validate_events`` on its log, started here and
    read by ``_replay_train_report``. Returns (the child's launches, its
    checkpoint directory, what the report reads)."""
    from trpo_torch.obs.aggregate import HttpTarget, MetricsAggregator
    from trpo_torch.obs.alerts import AlertEngine, default_rules

    ck, ev, desc = work / "ck", work / "train.jsonl", work / "train.json"
    counts_path, log = work / "train_counts.json", work / "train.log"
    t0 = time.perf_counter()
    child = _spawn([
        sys.executable, "-c", "import sys, chip_smoke as cs; "
        "sys.exit(cs._counted_child(sys.argv.pop(1)))", str(counts_path),
        "--preset", "humanoid-sim", "--device", dev.type, "--iterations",
        str(REPLAY_ITERS), "--metrics-jsonl", str(ev), "--status-port", "0",
        "--run-descriptor", str(desc), "--checkpoint-dir", str(ck),
        "--checkpoint-every", str(REPLAY_ITERS)], log)
    agg = engine = frame = None
    seen, frames, n = [], [], 0
    try:
        while child.poll() is None:
            _check(time.perf_counter() - t0 < 600, "[replay] train child")
            if agg is None and desc.exists():
                url = json.loads(desc.read_text())["status_url"]
                engine = AlertEngine(default_rules())
                agg = MetricsAggregator([HttpTarget("train", url)],
                                        engine=engine, interval=0.2)
            if agg is not None:
                agg.tick()
                it = agg.latest("train", "status.iteration")
                if it is not None and (not seen or seen[-1][1] != it):
                    seen.append((time.time(), it))
                if frame is None or frame[0].poll() is not None:
                    if frame is not None:
                        frames.append(json.loads(
                            frame[1].read_text() or "null"))
                    n += 1
                    frame = (_spawn(_tool(
                        "trpo_torch.scripts.observatory", "--targets",
                        f"train={url}", "--once", "--json"),
                        work / f"frame{n}.json", work / f"frame{n}.err"),
                        work / f"frame{n}.json")
            time.sleep(0.2)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        if agg is not None:
            agg.close()
    wall = time.perf_counter() - t0
    if frame is not None:
        frame[0].wait(timeout=60)
        frames.append(json.loads(frame[1].read_text() or "null"))
    _check(child.returncode == 0, f"[replay] train child exit "
           f"{child.returncode}:\n{log.read_text()[-3000:]}")
    iters = [it for _, it in seen]
    _check(len(iters) >= 2 and iters == sorted(iters),
           f"[replay] status.iteration over the watch: {iters}")
    _check(engine is not None and not engine.firing_total,
           f"[replay] alerts on the clean train run: "
           f"{engine and engine.firing_total}")
    live = [f for f in frames
            if f and f["targets"].get("train", {}).get("up") == 1.0]
    _check(live and all(not f["alerts"]["firing"] for f in frames if f),
           f"[replay] observatory frames: {frames}")
    # the child's kernels, exactly: K1 its cheap solves' iterations + 1 an
    # update, K2 once an iteration
    counts = json.loads(counts_path.read_text())
    launches, updates = counts["launches"], counts["updates"]
    _check(len(updates) == REPLAY_ITERS,
           f"[replay] {len(updates)} updates recorded")
    k1 = launches.get("fused_fvp", 0)
    _check(k1 == sum(u["cheap"] + 1 for u in updates),
           f"[replay] K1 {k1} against the updates {updates}")
    _check(launches.get("reverse_scan", 0) == REPLAY_ITERS,
           f"[replay] K2 {launches.get('reverse_scan', 0)}")
    plain = {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    _check(not plain, f"[replay] a plain version ran: {plain}")
    tools = {
        "summary": (_spawn(_tool("trpo_torch.scripts.analyze_run", str(ev),
                                 "--json"), work / "summary.json",
                           work / "summary.err"), work / "summary.json"),
        "compare": (_spawn(_tool("trpo_torch.scripts.analyze_run", str(ev),
                                 "--compare", str(ev), "--json"),
                           work / "compare.json", work / "compare.err"),
                    work / "compare.json"),
        "validate": (_spawn(_tool("trpo_torch.scripts.validate_events",
                                  str(ev)), work / "validate.log"),
                     work / "validate.log")}
    seen_s = (wall, iters, len(frames), len(live))
    return ({k: v for k, v in launches.items() if v}, str(ck),
            (tools, seen_s, k1, updates, launches))


def _replay_train_report(card: str, state) -> None:
    """Leg 1's tools on the train log: 5 iterations and a steady
    iteration ms, a self-compare with no verdict moved, a clean log, and
    K1 against the summary's ``cg_iters_total``."""
    tools, (wall, iters, n_frames, n_live), k1, updates, launches = state
    res = _finish(tools)
    for name, (code, out) in res.items():
        _check(code == 0, f"[replay] train log {name}: exit {code}:\n"
               f"{out[-2000:]}")
    summary = json.loads(res["summary"][1])
    verdicts = json.loads(res["compare"][1])["verdicts"]
    _check(summary["iterations"] == REPLAY_ITERS
           and math.isfinite(summary["steady_iteration_ms"] or math.nan),
           f"[replay] summary {summary['iterations']} iterations, steady "
           f"{summary['steady_iteration_ms']}")
    moved = [v for v in verdicts if v["verdict"] not in ("ok", "skipped")]
    _check(not moved, f"[replay] self-compare verdicts {moved}")
    cg = summary["last_stats"]["cg_iters_total"]
    fallback = sum(u["used"] - u["cheap"] for u in updates)
    _check(k1 == cg + len(updates) - fallback,
           f"[replay] K1 {k1}, cg_iters_total {cg}, {len(updates)} updates, "
           f"audited full solves {fallback}")
    print(f"[replay] train child (humanoid-sim as published, "
          f"{REPLAY_ITERS} iterations, --status-port 0): exit 0 in "
          f"{wall:.1f} s; status.iteration seen advancing {iters} by the "
          f"in-process aggregator, 0 alerts fired under default_rules; "
          f"{n_frames} observatory --once --json frames ({n_live} with "
          f"the target up), 0 firing; analyze_run: {summary['iterations']} "
          f"iterations, steady iteration {summary['steady_iteration_ms']:.2f}"
          f" ms, --compare itself exit 0 ({len(verdicts)} verdicts, none "
          f"moved); validate_events exit 0; K1 {k1} = Σ(cheap + 1) over "
          f"{len(updates)} updates = cg_iters_total {cg} + {len(updates)} "
          f"updates - {fallback} (the audited update's full solve counts in "
          f"cg_iters_total, its cheap one ran on K1), K2 "
          f"{launches.get('reverse_scan', 0)} ({card})", flush=True)


def _replay_sessions(url: str, obs_dim: int, sessions: int, concurrent: bool,
                     seed: int, at_mark) -> tuple:
    """``sessions`` cartpole-po sessions x ``REPLAY_ACTS`` acts through the
    router, one at a time (round robin) or one client thread each: every
    answer must be 200. After ``REPLAY_MID`` acts of every session the
    clients wait while ``at_mark()`` runs. Returns the times the window
    opens (after ``at_mark``) and closes."""
    import http.client
    import threading

    port = int(url.rsplit(":", 1)[1])
    marks, errors = [], []
    lock = threading.Lock()

    def run(acts, conn, sid, rng):
        for _ in range(acts):
            st, ans = _post(conn, f"/session/{sid}/act", {
                "obs": rng.standard_normal(obs_dim).astype(
                    np.float32).tolist()})
            if st != 200:
                with lock:
                    errors.append((st, ans))

    def open_session(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        st, ans = _post(conn, "/session")
        _check(st == 200, f"[replay] /session: {st} {ans}")
        return conn, ans["session"], np.random.default_rng(seed + k)

    if not concurrent:
        opened = [open_session(k) for k in range(sessions)]
        for r in range(REPLAY_ACTS):
            if r == REPLAY_MID:
                at_mark()
                marks.append(time.time())
            for conn, sid, rng in opened:
                run(1, conn, sid, rng)
        for conn, _, _ in opened:
            conn.close()
    else:
        barrier = threading.Barrier(
            sessions, action=lambda: (at_mark(), marks.append(time.time())))

        def client(k):
            conn, sid, rng = open_session(k)
            try:
                run(REPLAY_MID, conn, sid, rng)
                barrier.wait(timeout=120)
                run(REPLAY_ACTS - REPLAY_MID, conn, sid, rng)
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(sessions)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    _check(not errors and len(marks) == 1,
           f"[replay] session acts: {errors[:3]}, marks {marks}")
    return marks[0], time.time()


def _replay_capture(torch, dev, work: Path, card: str, po_child) -> None:
    """Leg 2: the ``cartpole-po`` server (GRU 64, 2 replicas, capture at
    trace rate 1.0) records window A (4 sessions x 50 acts one at a time)
    and window B (8 sessions x 50 acts from 8 clients); each window is
    exported from its 11th act on (journal-seeded) and replayed by
    ``replay_run``: bit-exact, and one replay on another step's weights
    must exit 1."""
    from trpo_torch.obs.replay import load_bundle, write_bundle
    from trpo_torch.utils.checkpoint import Checkpointer

    child, log, desc, ck, agent = po_child
    sv, cj = work / "po_serve.jsonl", work / "po_journal"
    url = _serve_up(child, desc, log, "cartpole-po server")
    dim = agent.obs_shape[0]
    # the journals self-compact (past 256 lines a replica) and coalesce a
    # session's entries while its acts outrun the writer: at each window's
    # start the clients pause for the writers to flush, and the journal
    # directory is archived, as an operator keeps it for an incident

    def archive(name):
        def at_mark():
            time.sleep(0.5)
            shutil.copytree(cj, work / name)
        return at_mark

    marks = [time.perf_counter()]
    a0, a1 = _replay_sessions(url, dim, 4, False, 100, archive("journal_A"))
    b0, b1 = _replay_sessions(url, dim, 8, True, 200, archive("journal_B"))
    marks.append(time.perf_counter())
    metrics = _get_url(url + "/metrics")
    acts = (4 + 8) * REPLAY_ACTS
    req, drop = (_metric(metrics, "trpo_capture_requests_total"),
                 _metric(metrics, "trpo_capture_dropped_total"))
    _check(req == acts and drop == 0, f"[replay] router capture: "
           f"{req} requests, {drop} dropped for {acts} acts")
    _stop_serve(child, log, "cartpole-po server")
    marks.append(time.perf_counter())
    caps = [r for r in _events(sv) if r["kind"] == "capture"]
    by_proc = {}
    for c in caps:
        by_proc[c["process"]] = by_proc.get(c["process"], 0) + 1
    routed = {}
    for c in caps:
        if c["process"] == "router":
            routed[c["replica"]] = routed.get(c["replica"], 0) + 1
    _check(by_proc.get("router") == acts and all(
        by_proc.get(r) == n for r, n in routed.items())
        and sum(routed.values()) == acts,
        f"[replay] capture records by process {by_proc}, routed {routed}")
    bundles = {"A": work / "A.bundle.json", "B": work / "B.bundle.json"}
    res = _finish({
        w: (_spawn(_tool("trpo_torch.scripts.analyze_run", str(sv),
                         "--export-bundle", "--window", repr(lo), repr(hi),
                         "--journal-dir", str(work / f"journal_{w}"),
                         "--out", str(bundles[w])),
                   work / f"export_{w}.log"), work / f"export_{w}.log")
        for w, (lo, hi) in (("A", (a0, a1)), ("B", (b0, b1)))})
    for w, (code, out) in res.items():
        _check(code == 0, f"[replay] export {w}: exit {code}:\n{out}")
    marks.append(time.perf_counter())
    # another step's weights, published after the recording: replaying
    # window A's step-1 actions on them must diverge
    Checkpointer(str(ck)).save(2, agent.init_state(seed=1))
    other = load_bundle(str(bundles["A"]))
    other["checkpoint_step"] = 2
    bundles["A@2"] = work / "A_step2.bundle.json"
    write_bundle(other, str(bundles["A@2"]))
    t0 = time.perf_counter()
    res = _finish({
        w: (_spawn(_tool("trpo_torch.scripts.replay_run", str(b),
                         "--checkpoint-dir", str(ck), "--preset",
                         "cartpole-po", "--device", dev.type, "--events",
                         str(work / f"replay_{w}.jsonl")),
                   work / f"replay_{w}.log"), work / f"replay_{w}.log")
        for w, b in bundles.items()})
    replay_wall = time.perf_counter() - t0
    lines = {}
    for w, n_sess in (("A", 4), ("B", 8)):
        code, out = res[w]
        seeded = [ln for ln in out.splitlines()
                  if ln.startswith("seeded session")]
        _check(code == 0 and out.rstrip().endswith("REPLAY BIT-EXACT")
               and len(seeded) == n_sess,
               f"[replay] window {w}: exit {code}, {len(seeded)} seeded:\n"
               f"{out[-3000:]}")
        recs = _events(work / f"replay_{w}.jsonl")
        rep = [r for r in recs if r["kind"] == "replay"]
        begin = next(r for r in rep if r["event"] == "begin")
        done = next(r for r in rep if r["event"] == "complete")
        n = done["acts"]
        _check(n == n_sess * (REPLAY_ACTS - REPLAY_MID)
               and done["mismatches"] == 0,
               f"[replay] window {w}: {done}")
        lines[w] = (n, n / (done["t"] - begin["t"]), [
            ln.strip() for ln in out.splitlines()
            if ln.strip().startswith("trace/") and "_p99_ms" in ln])
    code, out = res["A@2"]
    mism = [ln for ln in out.splitlines() if "MISMATCH" in ln]
    _check(code == 1 and mism and "REPLAY DIVERGED" in out,
           f"[replay] window A on step 2: exit {code}:\n{out[-3000:]}")
    code, out = _finish({"v": (_spawn(_tool(
        "trpo_torch.scripts.validate_events", str(sv),
        *[str(work / f"replay_{w}.jsonl") for w in bundles]),
        work / "validate_po.log"), work / "validate_po.log")})["v"]
    _check(code == 0, f"[replay] validate_events: {out[-3000:]}")
    marks.append(time.perf_counter())
    for w in ("A", "B"):
        n, rate, rows = lines[w]
        print(f"[replay] window {w} ({4 if w == 'A' else 8} cartpole-po GRU "
              f"64 sessions x {REPLAY_ACTS} acts, "
              f"{'one at a time' if w == 'A' else 'from 8 clients'}; "
              f"exported from act {REPLAY_MID + 1} on): replay_run exit 0, "
              f"every session seeded from its journal through "
              f"Router.restore_session, {n} acts REPLAY BIT-EXACT at "
              f"{rate:.1f} acts/s; recorded against replayed p99 "
              f"(advisory): {'; '.join(rows)} ({card})", flush=True)
    print(f"[replay] capture: router {by_proc['router']} records, replicas "
          f"{ {k: v for k, v in by_proc.items() if k != 'router'} } (= the "
          f"acts the router sent each), trpo_capture_requests_total {req:g}, "
          f"dropped 0; window A on step 2's weights: exit 1, "
          f"{len(mism)} of {lines['A'][0]} acts named MISMATCH; the three "
          f"replays ran side by side in {replay_wall:.1f} s; every log "
          f"validate_events-clean; seconds: recording "
          f"{marks[1] - marks[0]:.1f}, server stop {marks[2] - marks[1]:.1f}"
          f", exports {marks[3] - marks[2]:.1f}, replays {replay_wall:.1f}, "
          f"validate {marks[4] - marks[3] - replay_wall:.1f} ({card})",
          flush=True)


def _paced_load(port: int, stop, samples: list, lock):
    """``CONTROL_CLIENTS`` keep-alive clients, each sending one humanoid-sim
    /act about every ``REPLAY_PACE_S`` (jittered, so they do not move in
    step) until ``stop``: ``(sent, answered, status)`` in ``samples``."""
    import http.client
    import threading

    def client(k):
        r = np.random.default_rng(9000 + k)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while not stop.is_set():
                t0 = time.time()
                try:
                    st, _ = _post(conn, "/act", {
                        "obs": r.standard_normal(376).tolist()})
                except Exception:
                    st = -1
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", port, timeout=60)
                with lock:
                    samples.append((t0, time.time(), st))
                stop.wait(REPLAY_PACE_S * r.uniform(0.5, 1.5))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(CONTROL_CLIENTS)]
    for t in threads:
        t.start()
    return threads


def _replay_storm(torch, dev, work: Path, card: str, storm_child) -> dict:
    """Leg 3: alerts on a live router. The serve CLI (humanoid-sim, 2
    replicas) under 64 paced clients, ``overload_storm`` at request
    ``REPLAY_STORM_AT``; a ``MetricsAggregator`` + ``AlertEngine(
    default_rules)`` in this process scrapes its /status and /metrics.
    The SLO is set at 2x the peak of the router's recent p99 as read
    every 0.25 s from 10.5 s to 20.5 s, the aggregator's own scrapes
    running from the start (a calibration: the card's /act takes a few
    ms, where the reference's smoke simulates 50 ms acts and puts its
    SLO at 2x the top of that steady state); the clean window from then
    until the storm must fire nothing, and slo_p99 and shed_rate must
    fire and resolve."""
    import threading

    from trpo_torch.obs.aggregate import HttpTarget, MetricsAggregator
    from trpo_torch.obs.alerts import AlertEngine, default_rules
    from trpo_torch.obs.events import EventBus, JsonlSink, manifest_fields

    child, log, desc = storm_child
    sv, watch = work / "storm_serve.jsonl", work / "storm_watch.jsonl"
    url = _serve_up(child, desc, log, "storm server")
    stop, samples, lock = threading.Event(), [], threading.Lock()
    threads = _paced_load(int(url.rsplit(":", 1)[1]), stop, samples, lock)
    bus = EventBus(JsonlSink(str(watch)))
    bus.emit("run_manifest", **manifest_fields(
        None, extra={"driver": "chip_smoke_watch"}, device=dev))
    try:
        # the calibration scrapes as the armed watcher will, so the
        # readings carry the same load as the window they arm
        t_load = time.monotonic()
        cal = MetricsAggregator(
            [HttpTarget("router", url, metrics_path="/metrics")],
            interval=0.25)
        readings = []
        try:
            while time.monotonic() - t_load < (REPLAY_CALIBRATE_S
                                               + REPLAY_CALIBRATE_PEAK_S):
                cal.tick()
                n = cal.latest("router", "status.latency_recent_samples")
                p99 = cal.latest("router", "status.latency_recent_ms.0.99")
                if time.monotonic() - t_load >= REPLAY_CALIBRATE_S \
                        and n and n >= 8 and p99 is not None:
                    readings.append(p99)
                time.sleep(0.25)
        finally:
            cal.close()
        _check(readings, "[replay] no clean p99 reading to calibrate on")
        clean_p99 = max(readings)
        slo = REPLAY_SLO_X * clean_p99
        engine = AlertEngine(default_rules(slo_p99_ms=slo), bus=bus)
        agg = MetricsAggregator(
            [HttpTarget("router", url, metrics_path="/metrics")], bus=bus,
            engine=engine, interval=0.25)
        t_armed = time.time()
        fault = None
        deadline = time.monotonic() + 120
        try:
            while time.monotonic() < deadline:
                agg.tick()
                if fault is None:
                    fault = next((r for r in _events(sv)
                                  if r["kind"] == "fault_injected"), None)
                done = {r for r in ("slo_p99", "shed_rate")
                        if engine.resolved_total.get(r)}
                if fault is not None and len(done) == 2 and \
                        not engine.active():
                    break
                time.sleep(0.25)
        finally:
            agg.close()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        bus.close()
    _stop_serve(child, log, "storm server")
    _check(fault is not None, "[replay] the storm never fired")
    hist = [r for r in _events(watch) if r["kind"] == "alert"]
    early = [e for e in hist if e["state"] == "firing" and e["t"] < fault["t"]]
    _check(not early, f"[replay] false positives in the clean window: "
           f"{early}; SLO {slo:.3f} ms over {len(readings)} calibration "
           f"readings {min(readings):.3f}-{clean_p99:.3f} ms; the "
           f"router's recent p99 while armed: "
           f"{[(round(r['t'] - fault['t'], 2), round(r['value'], 3)) for r in _events(watch) if r['kind'] == 'metric_sample' and r['series'] == 'status.latency_recent_ms.0.99' and r['t'] < fault['t']]}"
           f" (s before the fault, ms); client ms over 20 in the clean "
           f"window: {[(round(s[0] - fault['t'], 2), round((s[1] - s[0]) * 1e3, 1)) for s in samples if t_armed - 10 <= s[0] < fault['t'] and (s[1] - s[0]) * 1e3 > 20]}")
    fired = {r: next((e for e in hist if e["rule"] == r
                      and e["state"] == "firing"), None)
             for r in ("slo_p99", "shed_rate")}
    resolved = {r: next((e for e in hist if e["rule"] == r
                         and e["state"] == "resolved"), None)
                for r in fired}
    p99s = [r["value"] for r in _events(watch)
            if r["kind"] == "metric_sample"
            and r["series"] == "status.latency_recent_ms.0.99"
            and r.get("value") is not None]
    _check(all(fired.values()) and all(resolved.values())
           and not engine.active(),
           f"[replay] storm alerts: fired {engine.firing_total}, resolved "
           f"{engine.resolved_total}, active {engine.active()}; SLO "
           f"{slo:.3f} ms, the router's recent p99 peaked at "
           f"{max(p99s, default=math.nan):.3f} ms; client p50/p99 clean "
           f"{_quantiles([(s[1] - s[0]) * 1e3 for s in samples if s[0] < fault['t'] and s[2] == 200])}"
           f", storm {_quantiles([(s[1] - s[0]) * 1e3 for s in samples if fault['t'] <= s[0] < fault['t'] + 8 and s[2] == 200] or [math.nan])}")
    merged = work / "storm_merged.jsonl"
    recs = sorted(_events(sv) + _events(watch), key=lambda r: r["t"])
    merged.write_text("".join(json.dumps(r) + "\n" for r in recs))
    res = _finish({
        "validate": (_spawn(_tool("trpo_torch.scripts.validate_events",
                                  str(merged)), work / "validate_storm.log"),
                     work / "validate_storm.log"),
        "observatory": (_spawn(_tool(
            "trpo_torch.scripts.observatory", "--events", str(merged),
            "--once", "--json"), work / "storm_obs.json",
            work / "storm_obs.err"), work / "storm_obs.json")})
    for name, (code, out) in res.items():
        _check(code == 0, f"[replay] storm {name}: exit {code}:\n"
               f"{out[-3000:]}")
    view = json.loads(res["observatory"][1])["alerts"]
    for r in fired:
        row = view["rules"].get(r, {})
        _check(row.get("fired", 0) >= 1 and row.get("resolved", 0) >= 1
               and not row.get("active"), f"[replay] observatory {r}: {row}")
    _check(not view["firing"], f"[replay] observatory firing {view}")
    storm_end = fault["t"] + 8.0
    clean_max = max((r["value"] for r in _events(watch)
                     if r["kind"] == "metric_sample"
                     and r["series"] == "status.latency_recent_ms.0.99"
                     and r.get("value") is not None
                     and r["t"] < fault["t"]), default=math.nan)
    clean = [s for s in samples if t_armed <= s[0] < fault["t"]]
    stormy = [s for s in samples if fault["t"] <= s[0] < storm_end]
    sheds = sum(1 for s in stormy if s[2] == 503)
    print(f"[replay] storm ({REPLAY_STORM}: {16 * REPLAY_STORMS} workers, "
          f"64 clients paced at ~{1 / REPLAY_PACE_S:.2f}/s each, "
          f"--max-inflight {REPLAY_STORM_INFLIGHT}): clean p99 "
          f"{min(readings):.3f}-{clean_p99:.3f} ms over {len(readings)} "
          f"readings -> SLO {slo:.3f} ms; the router's recent "
          f"p99 peaked at {clean_max:.3f} ms in the clean window and "
          f"{max(p99s, default=math.nan):.3f} ms in all; clean window "
          f"{fault['t'] - t_armed:.1f} s, "
          f"{len(clean)} client answers, 0 alerts; under the storm "
          f"{len(stormy)} client answers, {sheds} shed (503); "
          + "; ".join(
              f"{r} fired {fired[r]['t'] - fault['t']:.2f} s after the "
              f"fault (value {fired[r]['value']:.3f}, threshold "
              f"{fired[r]['threshold']:.3f}) and resolved "
              f"{resolved[r]['t'] - storm_end:.2f} s after the storm's end"
              for r in fired)
          + f"; validate_events and observatory --events clean ({card})",
          flush=True)
    return {r: fired[r]["t"] - fault["t"] for r in fired}


def _replay_capture_cost(torch, dev, work: Path, card: str, cost) -> dict:
    """Leg 4: the serve CLI (humanoid-sim, 2 replicas, trace rate 1.0)
    with ``--capture`` off and on, side by side; 64 clients x
    ``REPLAY_COST_PER`` on each in the order off, on, on, off (two runs of
    each since the script gained ``[mesh]``: the whole script keeps to
    its time budget)."""
    urls = {m: _serve_up(c, d, lg, f"capture-{m} server")
            for m, (c, lg, d) in cost.items()}
    runs = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        port = int(urls[mode].rsplit(":", 1)[1])
        runs[mode].append(_load_result(*_http_load(
            port, CONTROL_CLIENTS, REPLAY_COST_PER,
            lambda r: r.standard_normal(376).tolist()), f"capture {mode}"))
    metrics = _get_url(urls["on"] + "/metrics")
    req, drop = (_metric(metrics, "trpo_capture_requests_total"),
                 _metric(metrics, "trpo_capture_dropped_total"))
    for m, (c, lg, _) in cost.items():
        _stop_serve(c, lg, f"capture-{m} server")
    med = {m: float(np.median([r["rps"] for r in runs[m]])) for m in runs}

    def fmt(m):
        return ", ".join(f"{r['rps']:.1f} req/s p50 {r['p50']:.3f} p99 "
                         f"{r['p99']:.3f} ms" for r in runs[m])

    spread = {m: (min(r["rps"] for r in runs[m]),
                  max(r["rps"] for r in runs[m])) for m in runs}
    print(f"[replay] capture cost (humanoid-sim /act through the serve CLI, "
          f"2 replicas, trace rate 1.0, {CONTROL_CLIENTS} clients x "
          f"{REPLAY_COST_PER}, runs off, on, on, off): off "
          f"[{fmt('off')}], on [{fmt('on')}]; median {med['off']:.1f} -> "
          f"{med['on']:.1f} req/s ({(med['on'] / med['off'] - 1) * 100:+.2f}"
          f"%), spread off {spread['off'][0]:.1f}-{spread['off'][1]:.1f}, on "
          f"{spread['on'][0]:.1f}-{spread['on'][1]:.1f}; the capture's router "
          f"recorded {req:g} requests, dropped {drop:g} ({card})", flush=True)
    return {"median": med, "drops": drop}


def phase_replay(torch, dev):
    """Request capture, deterministic replay, offline analysis and alerts
    (``trpo_torch/obs``, ``trpo_torch/scripts``) through the port's entry
    points as users run them: a live-watched flagship train child, a
    recorded and replayed ``cartpole-po`` serving window, a storm that
    must page and recover, and capture's cost. Returns the train child's
    launches."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.ops import _build
    from trpo_torch.utils.checkpoint import Checkpointer

    card = _card_line()
    work = WORK / "replay"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    serve = ["trpo_torch.serve", "--device", dev.type, "--port", "0",
             "--replicas", "2"]
    # the servers start beside the train child (the recorded one now, the
    # trained checkpoint's once it exists), so their start costs no leg
    po_ck = work / "po_ck"
    agent = TRPOAgent("cartpole-po", get_preset("cartpole-po"), device=dev)
    Checkpointer(str(po_ck)).save(1, agent.init_state(seed=0))
    po = (_spawn(_tool(*serve, "--preset", "cartpole-po", "--checkpoint-dir",
                       str(po_ck), "--trace-sample-rate", "1.0", "--capture",
                       "--metrics-jsonl", str(work / "po_serve.jsonl"),
                       "--carry-journal-dir", str(work / "po_journal"),
                       "--run-descriptor", str(work / "po.json")),
                 work / "po_serve.log"),
          work / "po_serve.log", work / "po.json", po_ck, agent)
    children = [po[0]]
    try:
        counts, ck_dir, train = _replay_train(torch, dev, work, card)
        t1 = time.perf_counter()
        storm = (_spawn(_tool(*serve, "--preset", "humanoid-sim",
                              "--checkpoint-dir", ck_dir, "--max-inflight",
                              str(REPLAY_STORM_INFLIGHT), "--inject-faults",
                              REPLAY_STORM, "--metrics-jsonl",
                              str(work / "storm_serve.jsonl"),
                              "--run-descriptor", str(work / "storm.json")),
                        work / "storm_serve.log"),
                 work / "storm_serve.log", work / "storm.json")
        children.append(storm[0])
        cost = {}
        for mode in ("off", "on"):
            extra = ["--capture"] if mode == "on" else []
            cost[mode] = (_spawn(_tool(
                *serve, "--preset", "humanoid-sim", "--checkpoint-dir",
                ck_dir, "--trace-sample-rate", "1.0", *extra,
                "--metrics-jsonl", str(work / f"cost_{mode}.jsonl"),
                "--run-descriptor", str(work / f"cost_{mode}.json")),
                work / f"cost_{mode}.log"),
                work / f"cost_{mode}.log", work / f"cost_{mode}.json")
            children.append(cost[mode][0])
        _replay_capture(torch, dev, work, card, po)
        _replay_train_report(card, train)
        t2 = time.perf_counter()
        _replay_capture_cost(torch, dev, work, card, cost)
        t3 = time.perf_counter()
        _replay_storm(torch, dev, work, card, storm)
        t4 = time.perf_counter()
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    here = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check(not here, f"[replay] launches in the measuring process: {here}")
    print(f"[replay] legs: train {t1 - t0:.1f} s (the recording server "
          f"starting beside it), capture and replay {t2 - t1:.1f} s (the "
          f"other servers starting beside it), capture cost "
          f"{t3 - t2:.1f} s, storm {t4 - t3:.1f} s; phase "
          f"{time.perf_counter() - t0:.1f} s; logs in "
          f"{work.relative_to(ROOT)}", flush=True)
    return counts


FLY_ITERS = 3        # each [flywheel] fleet member's iterations
FLY_FAULT = "sigterm@iter=2"   # injected into member seed1
COMPAT_ITERS = 5     # the reference-style loop's iterations


def _fleet_cli_child() -> int:
    """Run in a child process: ``python -m trpo_torch.scripts.fleet`` (by
    runpy, with this process's argv), every member launched as the stock
    ``python -m trpo_torch.train`` argv run under ``_counted_child``,
    so each member process writes its own launch counts and update
    records to ``<member dir>/counts.<attempt>.json``."""
    import runpy

    from trpo_torch.fleet import scheduler

    stock = scheduler.default_member_argv

    def counted(spec, member, ctx):
        argv = stock(spec, member, ctx)
        head = argv.index("trpo_torch.train") + 1
        counts = os.path.join(ctx["member_dir"],
                              f"counts.{ctx['attempt']}.json")
        return [argv[0], "-c", "import sys, chip_smoke as cs; "
                "sys.exit(cs._counted_child(sys.argv.pop(1)))",
                counts] + argv[head:]

    scheduler.default_member_argv = counted
    code = 1
    try:
        runpy.run_module("trpo_torch.scripts.fleet", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    return code


def _segments(path: Path) -> list:
    """A member's event log split at each ``run_manifest``: one list of
    records per process that wrote it."""
    segs = []
    for r in _events(path):
        if r["kind"] == "run_manifest" or not segs:
            segs.append([])
        segs[-1].append(r)
    return segs


def _fleet_scrape(url: str, done, seen: list) -> None:
    """Poll the fleet's ``/metrics`` until ``done``: keep every scrape
    that carries a live member's iteration timing."""
    while not done.is_set():
        try:
            text = _get_url(url + "/metrics", timeout=5.0)
        except Exception:
            text = ""
        if "trpo_fleet_member_iteration_ms{" in text:
            seen.append((time.time(), text))
        time.sleep(0.1)


def _flywheel_fleet(torch, dev, work: Path, card: str) -> dict:
    """Leg A: ``python -m trpo_torch.scripts.fleet`` over 2 ``humanoid-sim``
    members as published (grid seed=0..1), ``FLY_ITERS`` iterations each
    on 2 slots, ``--status-port 0``, one PBT round of 1 iteration, with
    ``FLY_FAULT`` injected into seed1. Returns the members' launches,
    summed over their processes."""
    import random
    import threading

    from trpo_torch.fleet import MemberSpec, expand_grid, member_cli_args

    fleet_dir = work / "fleet"
    out, err = work / "fleet_result.json", work / "fleet.err"
    t0 = time.perf_counter()
    child = _spawn([
        sys.executable, "-c", "import sys, chip_smoke as cs; "
        "sys.exit(cs._fleet_cli_child())", "--fleet-dir", str(fleet_dir),
        "--grid", "seed=0..1", "--max-workers", "2", "--backoff", "0.2",
        "--status-port", "0", "--scrape-interval", "0.2", "--inject",
        f"seed1={FLY_FAULT}", "--cull-bottom-k", "1", "--pbt-rounds", "1",
        "--pbt-iterations", "1", "--json", "--", "--preset",
        "humanoid-sim", "--device", dev.type, "--iterations",
        str(FLY_ITERS), "--checkpoint-every", "1", "--health-checks"],
        out, err)
    done, seen, scraper = threading.Event(), [], None
    try:
        while child.poll() is None:
            _check(time.perf_counter() - t0 < 400, "[flywheel] fleet CLI")
            if scraper is None and "fleet endpoint:" in err.read_text():
                url = err.read_text().split("fleet endpoint: ")[1].split()[0]
                scraper = threading.Thread(
                    target=_fleet_scrape, daemon=True,
                    args=(url.rsplit("/status", 1)[0], done, seen))
                scraper.start()
            time.sleep(0.1)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        done.set()
        if scraper is not None:
            scraper.join(timeout=10)
    wall = time.perf_counter() - t0
    _check(child.returncode == 0, f"[flywheel] fleet CLI exit "
           f"{child.returncode}:\n{err.read_text()[-3000:]}")
    result = json.loads(out.read_text())
    _check(result["gate"]["exit_code"] == 0 and result["exit_code"] == 0,
           f"[flywheel] fleet gate {result['gate']}")
    fleet = [r for r in _events(fleet_dir / "fleet_events.jsonl")
             if r["kind"] == "fleet"]
    by = {m: [r for r in fleet if r["member"] == m]
          for m in result["members"]}
    # the sigterm'd member: exit 75, one requeue, resumed at the newest
    # complete step + 1, its iterations gapless across the two processes
    s1 = [(r["state"], r["attempt"], r.get("exit_code"), r.get("resume_step"))
          for r in by["seed1"]]
    resume = 2   # sigterm@iter=2: preempted after its checkpoint of step 2
    _check(s1[:4] == [("launched", 1, None, None), ("preempted", 1, 75, None),
                      ("requeued", 1, 75, resume),
                      ("launched", 2, None, resume)]
           and result["members"]["seed1"]["requeues"] == 1,
           f"[flywheel] seed1's lifecycle {s1}")
    respawned = result["respawned"]
    _check(len(respawned) == 1 and result["culled"],
           f"[flywheel] PBT: culled {result['culled']}, respawned "
           f"{respawned}")
    culled = respawned[0]
    winner = next(m for m in result["members"] if m != culled)
    rot = sorted(fleet_dir.glob(f"{culled}/events.gen*.jsonl"))
    s1_log = (rot[0] if culled == "seed1" else
              fleet_dir / "seed1" / "events.jsonl")
    segs = _segments(s1_log)
    its = [[r["iteration"] for r in seg if r["kind"] == "iteration"]
           for seg in segs]
    _check(len(segs) == 2 and sum(its, []) == list(range(1, FLY_ITERS + 1))
           and its[1][0] == resume + 1,
           f"[flywheel] seed1's iterations by process {its}")
    # the respawn: exploit the winner's newest step, explore the seed as
    # the reference draws it (plain Python, so identical)
    resp = next(r for r in by[culled] if r["state"] == "respawned")
    attempt = resp["attempt"]
    rng = random.Random(f"{culled}:{attempt}")
    factor = 0.8 if rng.random() < 0.5 else 1.2
    base = next(m for m in expand_grid("seed=0..1")
                if m.member_id == culled).overrides_dict
    if culled == "seed1":
        base["inject_faults"] = FLY_FAULT
    base["seed"] = rng.randrange(2 ** 31)
    want_args = member_cli_args(MemberSpec(culled, tuple(base.items())))
    _check(resp["resume_step"] == FLY_ITERS and resp["reason"] ==
           f"pbt exploit {winner}@{FLY_ITERS} explore x{factor:g}",
           f"[flywheel] respawn record {resp}")
    new_seg = _segments(fleet_dir / culled / "events.jsonl")
    manifest = new_seg[-1][0]
    new_its = [r["iteration"] for r in new_seg[-1] if r["kind"] == "iteration"]
    _check(manifest["config"]["seed"] == base["seed"]
           and new_its == [FLY_ITERS + 1],
           f"[flywheel] respawned {culled}: seed "
           f"{manifest['config']['seed']} (want {base['seed']}), "
           f"iterations {new_its}")
    # the live fleet view while members ran
    live = [t for _, t in seen if 'state="running"} 1' in t]
    _check(live, "[flywheel] the fleet /metrics never carried a running "
           "member's iteration timing")
    timed = sorted({m for t in live for m in result["members"]
                    if f'trpo_fleet_member_iteration_ms{{member="{m}"}}' in t})
    # every member process: K1 Σ(cheap + 1) over its updates, K2 once an
    # iteration, no plain version
    totals, per = {}, []
    for mdir in sorted(p for p in fleet_dir.iterdir() if p.is_dir()):
        for cpath in sorted(mdir.glob("counts.*.json")):
            counts = json.loads(cpath.read_text())
            launches, updates = counts["launches"], counts["updates"]
            k1 = launches.get("fused_fvp", 0)
            _check(k1 == sum(u["cheap"] + 1 for u in updates)
                   and all(u["launched"]["fused_fvp"] == u["cheap"] + 1
                           for u in updates),
                   f"[flywheel] {cpath.relative_to(work)}: K1 {k1} for "
                   f"{updates}")
            _check(launches.get("reverse_scan", 0) == len(updates) > 0,
                   f"[flywheel] {cpath.relative_to(work)}: K2 "
                   f"{launches.get('reverse_scan', 0)} for {len(updates)} "
                   "iterations")
            plain = {k: v for k, v in launches.items()
                     if k.endswith("_plain") and v}
            _check(not plain, f"[flywheel] a plain version ran: {plain}")
            per.append(f"{mdir.name}#{cpath.name.split('.')[1]} K1 {k1} "
                       f"K2 {launches['reverse_scan']}")
            totals = _add(totals, {k: v for k, v in launches.items() if v})
    # seed0 once, seed1 twice (the requeue), the culled one's respawn
    _check(len(per) == 4, f"[flywheel] member processes {per}")
    logs = [str(fleet_dir / "fleet_events.jsonl")] + [
        str(p) for p in sorted(fleet_dir.glob("*/events*.jsonl"))]
    check = subprocess.run(_tool("trpo_torch.scripts.validate_events", *logs),
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    _check(check.returncode == 0, f"[flywheel] validate_events:\n"
           f"{check.stdout[-3000:]}{check.stderr[-2000:]}")
    # each process's start: its launch record to its first iteration
    starts, steady = [], []
    for m, recs in by.items():
        launched = [r for r in recs if r["state"] == "launched"]
        segs = [seg for p in ([fleet_dir / m / "events.jsonl"]
                              + sorted(fleet_dir.glob(f"{m}/events.gen*")))
                for seg in _segments(p)]
        segs.sort(key=lambda seg: seg[0]["t"])
        for rec, seg in zip(launched, segs):
            first = next(r for r in seg if r["kind"] == "iteration")
            starts.append(f"{m}#{rec['attempt']} {first['t'] - rec['t']:.1f}")
            steady += [r["stats"]["iteration_ms"] for r in seg
                       if r["kind"] == "iteration"][1:]
    rows = {m: (r["attempt"], r["requeues"], r["state"], r["score"])
            for m, r in result["members"].items()}
    print(f"[flywheel] fleet CLI (2 humanoid-sim members as published, "
          f"{FLY_ITERS} iterations, 2 slots, seed1 {FLY_FAULT}, 1 PBT "
          f"round of 1): exit 0, gate exit 0, wall {wall:.1f} s (bench "
          f"row: fleet {result['bench']['fleet_wall_ms'] / 1e3:.1f} s, "
          f"members {result['bench']['members_wall_ms'] / 1e3:.1f} s); "
          f"members (attempts, requeues, state, score) {rows}; first "
          f"iteration s after launch {starts}; steady iteration ms "
          f"{[round(x, 1) for x in sorted(steady)]}; seed1 preempted "
          f"(exit 75), requeued once, resumed at step {resume} + 1, "
          f"iterations {its} gapless; {culled} culled and respawned from "
          f"{winner}@{FLY_ITERS} with {want_args} (x{factor:g}; seed as "
          f"the reference draws it), ran iteration {new_its}; live "
          f"/metrics: {len(live)} scrapes with a running member's "
          f"iteration_ms (members {timed}); per process {per}; "
          f"validate_events exit 0 over {len(logs)} logs ({card})",
          flush=True)
    return totals


def _flywheel_loop(dev, work: Path):
    """Leg B, started: ``python -m trpo_torch.scripts.flywheel_smoke`` at
    the reference's sizes (not ``--quick``) on the card."""
    return _spawn(_tool("trpo_torch.scripts.flywheel_smoke", "--tmp",
                        str(work / "loop"), "--device", dev.type),
                  work / "loop.log")


def _flywheel_loop_report(child, work: Path, card: str) -> None:
    log = work / "loop.log"
    try:
        child.wait(timeout=400)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
    _check(child.returncode == 0, f"[flywheel] flywheel_smoke exit "
           f"{child.returncode}:\n{log.read_text()[-3000:]}")
    lines = log.read_text().splitlines()
    summary = json.loads(next(ln for ln in reversed(lines)
                              if ln.startswith("{")))
    _check(summary["client_errors"] == 0 and summary["episodes"] > 0,
           f"[flywheel] flywheel_smoke {summary}")
    events = work / "loop" / "flywheel_events.jsonl"
    check = subprocess.run(_tool("trpo_torch.scripts.validate_events",
                                 str(events)), cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    _check(check.returncode == 0, f"[flywheel] validate_events:\n"
           f"{check.stdout[-3000:]}")
    recs = _events(events)
    outcomes = [(r["event"], r["step"]) for r in recs
                if r["kind"] == "promote" and r["event"] in
                ("promoted", "rejected", "rolled_back")]
    _check(outcomes == [("promoted", 1), ("rejected", 2), ("rejected", 3)],
           f"[flywheel] promotion outcomes {outcomes}")
    tm = summary["timings_s"]
    print(f"[flywheel] flywheel_smoke (2 pendulum GRU-8 members, 2 "
          f"iterations each, sessions through the canary-striding router): "
          f"exit 0; fleet {tm['fleet']:.1f} s (winner {summary['winner']}); "
          f"kill_promoter at serving step 1, promoter_stuck fired "
          f"{tm['stuck_fired'] - tm['killed']:.1f} s after, the restarted "
          f"controller converged without republishing and promoted in "
          f"{tm['promoted'] - tm['stuck_fired']:.2f} s; gate decisions "
          f"{summary['gate_decision_s']} (regress_checkpoint rejected "
          f"naming the realized return, corrupt_checkpoint by its failed "
          f"reload); outcomes {outcomes}; {summary['episodes']} episodes "
          f"booked as feedback; client errors {summary['client_errors']}; "
          f"validate_events exit 0 ({card})", flush=True)


def phase_flywheel(torch, dev):
    """The fleet orchestrator and the train→serve flywheel
    (``trpo_torch.fleet``) through their entry points: the fleet CLI over
    the flagship (leg A) beside the closed-loop smoke (leg B). Returns
    the fleet members' launches."""
    from trpo_torch.ops import _build

    card = _card_line()
    work = WORK / "flywheel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    _build.reset_launches()
    t0 = time.perf_counter()
    loop = _flywheel_loop(dev, work)
    try:
        counts = _flywheel_fleet(torch, dev, work, card)
        t1 = time.perf_counter()
        _flywheel_loop_report(loop, work, card)
    finally:
        if loop.poll() is None:
            loop.kill()
            loop.wait()
    here = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check(not here, f"[flywheel] launches in the measuring process: {here}")
    print(f"[flywheel] legs: fleet {t1 - t0:.1f} s (the loop running "
          f"beside it), loop done {time.perf_counter() - t0:.1f} s after "
          f"the phase's start; logs in {work.relative_to(ROOT)}", flush=True)
    return counts


def phase_compat(torch, dev):
    """The reference's ``utils.py`` surface (``trpo_torch.compat``) in
    this process: ``compat.discount`` on a CUDA tensor held against the
    plain scan, one K2 launch (a comparison, not a driven path: it adds
    nothing to the path counts). The reference-style loop on it
    (``trpo_torch.scripts.reference_style``) runs in ``[examples]``."""
    from trpo_torch import compat
    from trpo_torch.ops import _build
    from trpo_torch.ops.reverse_scan import reverse_affine_scan_plain

    card = _card_line()
    x = torch.randn(200, generator=torch.Generator().manual_seed(0)).to(dev)
    _build.reset_launches()
    got = compat.discount(x, 0.95)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    _check(launches == {"reverse_scan": 1},
           f"[compat] compat.discount on {dev}: {launches}")
    plain = reverse_affine_scan_plain(
        torch.full((200, 1), 0.95, device=dev), x[:, None])[:, 0]
    err = float(np.max(np.abs(got - plain.cpu().numpy())))
    _check(err <= K2_TOL * max(1.0, float(plain.abs().max())),
           f"[compat] compat.discount against plain: max err {err}")
    _build.reset_launches()
    print(f"[compat] compat.discount on a (200,) input on {dev}: K2 once, "
          f"against the plain scan max err {err:.2e} (K2's {K2_TOL}) "
          f"({card})", flush=True)


def _reference_style_result(code: int, out: str, counts_path: Path,
                            card: str) -> dict:
    """Check ``[examples]``' reference-style child (``COMPAT_ITERS``
    iterations of the reference's hand-written loop on ``compat``): a row
    an iteration with a finite reward and ms and a host CG of at least one
    iteration, and K2 exactly once per path (``compat.discount``), no
    other launch. Prints its line; returns its launches."""
    _check(code == 0, f"[examples] reference_style exit {code}:\n"
           f"{out[-3000:]}")
    rows = [dict(kv.split("=") for kv in ln.split()[2:])
            for ln in out.splitlines() if ln.startswith("iter ")]
    _check(len(rows) == COMPAT_ITERS, f"[examples] reference_style "
           f"{len(rows)} iterations:\n{out[-2000:]}")
    for r in rows:
        _check(all(math.isfinite(float(r[k])) for k in ("mean_reward", "ms"))
               and int(r["cg_iters"]) >= 1,
               f"[examples] reference_style iteration {r}")
    res = json.loads(counts_path.read_text())
    launches = {k: v for k, v in res["launches"].items() if v}
    paths = sum(int(r["paths"]) for r in rows)
    _check(launches == {"reverse_scan": paths},
           f"[examples] reference_style launches {launches} for {paths} "
           "paths' discount (K2 once a path, no other kernel)")
    print(f"[examples] reference_style --iterations {COMPAT_ITERS} "
          f"(cartpole on the native stepper one env at a time, host CG and "
          f"line search): exit 0 in {res['wall_s']:.1f} s; per iteration ms "
          f"{[float(r['ms']) for r in rows]}, CG host-loop iterations "
          f"{[int(r['cg_iters']) for r in rows]}, line-search probes "
          f"{[int(r['ls_probes']) for r in rows]}, mean reward "
          f"{[float(r['mean_reward']) for r in rows]}; K2 {paths} = one per "
          f"path's compat.discount ({card})", flush=True)
    return launches


# ---------------------------------------------------------------------------
# [examples] the user examples (trpo_torch/scripts), and the learning runs
# ---------------------------------------------------------------------------

# learning_evidence's Gaussian-MLP rungs: their cheap CG solve runs on K1
K1_RUNGS = ("pendulum", "halfcheetah-sim", "humanoid-sim")
EVIDENCE_BAR = 400.0      # cartpole's best reading (tests/test_agent.py:148)
EXAMPLES_S = 600          # [examples]'s children's deadline
EVIDENCE_S = (300, 4.0)   # a learning run's deadline: s + s per iteration
SWEEP_KEYS = {"env", "members", "labels", "iterations", "wall_s",
              "member_updates_per_sec", "final_chunk_scores"}


def _evidence_child(out_path: str, rung: str, device: str) -> int:
    """Run in a child process: ``learning_evidence.train`` on ``rung`` as
    published (seed 0, its iterations and chunk from ``RUNGS``) on
    ``device`` under the update recorder, its table header and row printed
    as the script's ``main`` prints them; then write the launch counts,
    each update's record and the run's stats rows to ``out_path``."""
    from trpo_torch.ops import _build
    from trpo_torch.scripts import learning_evidence

    iters, chunk = learning_evidence.RUNGS[rung]
    print("| rung | iterations | wall | mean episode reward |")
    print("|---|---|---|---|", flush=True)
    with _updates() as log:
        rows = learning_evidence.train(rung, iters, chunk, device=device)
        updates = _update_records(log)
    Path(out_path).write_text(json.dumps({
        "launches": dict(_build.LAUNCHES), "updates": updates,
        "rows": rows}))
    return 0


def _evidence_argv(out_path: Path, rung: str, device: str) -> list:
    return [sys.executable, "-c", "import sys, chip_smoke as cs; "
            "sys.exit(cs._evidence_child(*sys.argv[1:]))",
            str(out_path), rung, device]


def _evidence_result(rung: str, path: Path, out: str, card: str) -> dict:
    """Check one learning run's child (``_evidence_child``): the script's
    row, a finite update on every iteration, K2 once an iteration, K1
    exactly Σ(cheap cg_iterations + 1) on a Gaussian rung and never
    elsewhere, K1-bf16 and the plain versions never. Prints the rung's
    line and returns its summary: wall, median iteration ms, first → last
    and best reading, launches, and every audit's update, cosine and
    fallback."""
    from trpo_torch.config import get_preset
    from trpo_torch.scripts import learning_evidence

    tag = f"evidence {rung}"
    iters, chunk = learning_evidence.RUNGS[rung]
    max_kl = get_preset(rung).max_kl
    res = json.loads(path.read_text())
    rows = res["rows"]
    launches = {k: v for k, v in res["launches"].items() if v}
    m = re.search(rf"^\| {re.escape(rung)} \| {iters} \| ([0-9.]+) s \| "
                  r"(-?[0-9]+) → (-?[0-9]+) \|$", out, re.M)
    _check(m is not None and len(rows) == iters,
           f"[{tag}] {len(rows)} rows, the row {m}:\n{out[-2000:]}")
    for i, r in enumerate(rows):
        _check(math.isfinite(r["entropy"]) and math.isfinite(r["kl_old_new"])
               and r["kl_old_new"] <= 2 * max_kl,
               f"[{tag}] update {i + 1}: entropy {r['entropy']}, "
               f"kl_old_new {r['kl_old_new']}")
    _check(launches.get("reverse_scan", 0) == iters,
           f"[{tag}] K2 launched {launches.get('reverse_scan', 0)} times "
           f"over {iters} iterations")
    stray = {k: n for k, n in launches.items()
             if k.endswith("_plain") or k == "fused_fvp_bf16"}
    _check(not stray, f"[{tag}] launches of {stray}")
    if rung in K1_RUNGS:
        log = [(u["launched"], u["cheap"], u["used"], u["fallback"])
               for u in res["updates"]]
        _exact_fvp_launches(tag, "fused_fvp", rows, log, launches)
    else:
        _check(not launches.get("fused_fvp"),
               f"[{tag}] K1 ran on a policy it does not cover: {launches}")
    rewards = np.asarray([r["mean_episode_reward"] for r in rows], float)
    audits = [(i + 1, r["solve_cosine"], r["solve_fallback"])
              for i, r in enumerate(rows) if r.get("solve_audited")]
    summary = {
        "rung": rung, "iterations": iters, "chunk": chunk,
        "wall_s": float(m.group(1)),
        "median_iteration_ms": float(np.median(
            [r["iteration_ms"] for r in rows])),
        "first": int(m.group(2)), "last": int(m.group(3)),
        "best": float(np.nanmax(rewards)),
        "best_at": int(np.nanargmax(rewards)) + 1,
        "launches": launches,
        "cg_iterations_total": sum(r["cg_iterations"] for r in rows),
        "audits": audits, "card": card}
    print(f"[{tag}] {iters} iterations in chunks of {chunk}: wall "
          f"{summary['wall_s']} s, median iteration "
          f"{summary['median_iteration_ms']:.1f} ms (a chunk's wall over its "
          f"iterations); mean episode reward {summary['first']} → "
          f"{summary['last']}, best {summary['best']:.1f} at iteration "
          f"{summary['best_at']}; launches {launches}; audits (update, "
          f"cosine, fallback) {audits} ({card})", flush=True)
    return summary


def phase_examples(torch, dev, beside=None):
    """The user examples (``trpo_torch/scripts``) as users run them, each
    in a counted child on the card, all side by side: ``quickstart`` as
    published; ``pomdp_recurrent --iterations 2``; ``mujoco_host --env
    native:pendulum --iterations 2`` (K1 and K2), and on its default
    ``gym:`` env, refused (the card's machine has no gymnasium);
    ``population_sweep --chunks 1 --iters-per-chunk 2``;
    ``reference_style`` (``COMPAT_ITERS`` iterations of the reference's
    hand-written loop on ``trpo_torch.compat``); and
    ``learning_evidence``'s cartpole rung as published (300 iterations in
    chunks of 50), held to a best reading ≥ 400. ``beside``, when given,
    runs in this process while the children run. Returns the children's
    launches, with ``beside``'s."""
    card = _card_line()
    work = WORK / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    sweep = work / "sweep.json"
    runs = {
        "quickstart": ("quickstart", []),
        "pomdp_recurrent": ("pomdp_recurrent", ["--iterations", "2"]),
        "mujoco_host": ("mujoco_host", ["--env", "native:pendulum",
                                        "--iterations", "2"]),
        "mujoco_host gym:": ("mujoco_host", []),
        "population_sweep": ("population_sweep", [
            "--chunks", "1", "--iters-per-chunk", "2", "--out", str(sweep)]),
        "reference_style": ("reference_style", [
            "--iterations", str(COMPAT_ITERS)]),
    }
    t0 = time.perf_counter()
    evidence = work / "learning_evidence.json"
    children = {"learning_evidence": (
        _spawn(_evidence_argv(evidence, "cartpole", dev.type),
               work / "learning_evidence.log"),
        work / "learning_evidence.log")}
    for name, (script, args) in runs.items():
        tag = name.replace(" gym:", "_gym")
        log = work / f"{tag}.log"
        children[name] = (_spawn(
            [sys.executable, "-c", "import sys, chip_smoke as cs; "
             "sys.exit(cs._counted_child(sys.argv.pop(1), sys.argv.pop(1)))",
             str(work / f"{tag}.json"), f"trpo_torch.scripts.{script}",
             "--device", dev.type, *args], log), log)
    side = {}
    try:
        if beside is not None:
            side = beside() or {}
    finally:
        done = _finish(children, timeout=EXAMPLES_S)
    wall = time.perf_counter() - t0

    def counted(name, pattern):
        code, out = done[name]
        _check(code == 0, f"[examples] {name} exit {code}:\n{out[-3000:]}")
        m = re.search(pattern, out, re.M)
        _check(m is not None, f"[examples] {name} printed:\n{out[-2000:]}")
        res = json.loads((work / f"{name}.json").read_text())
        res["launches"] = {k: v for k, v in res["launches"].items() if v}
        stray = {k: n for k, n in res["launches"].items()
                 if k.endswith("_plain") or k == "fused_fvp_bf16"}
        _check(not stray, f"[examples] {name}: launches of {stray}")
        print(f"[examples] {' '.join([name, *runs[name][1]])}: exit 0 in "
              f"{res['wall_s']:.1f} s, {len(res['updates'])} updates, "
              f"launches {res['launches']}; \"{m.group(0).strip()}\" "
              f"({card})", flush=True)
        return m, res

    total = side
    m, res = counted("quickstart", r"^finished at iteration ([0-9]+)$")
    n = int(m.group(1))
    _check(1 <= n <= 30 and len(res["updates"]) == n
           and res["launches"] == {"reverse_scan": n},
           f"[examples] quickstart: {n} iterations, launches "
           f"{res['launches']} (K2 once an iteration; no K1 on a "
           "categorical policy)")
    total = _add(total, res["launches"])
    _, res = counted("pomdp_recurrent", r"^GRU policy on velocity-masked "
                     r"CartPole after 2 iterations: greedy eval -?[0-9.]+.*$")
    _check(res["launches"] == {"reverse_scan": 2},
           f"[examples] pomdp_recurrent launches {res['launches']}")
    total = _add(total, res["launches"])
    _, res = counted("mujoco_host", r"^finished at iteration 2; greedy eval "
                     r"return -?[0-9.]+ .*$")
    k1 = sum(u["cheap"] + 1 for u in res["updates"] if u["cheap"] >= 0)
    _check(len(res["updates"]) == 2 and k1 > 0
           and res["launches"] == {"reverse_scan": 2, "fused_fvp": k1},
           f"[examples] mujoco_host on native:pendulum launches "
           f"{res['launches']}; expected K2 2 and K1 {k1} = Σ(cheap "
           "cg_iterations + 1)")
    total = _add(total, res["launches"])
    code, out = done["mujoco_host gym:"]
    _check(code not in (0, None)
           and "gymnasium is required for gym:* envs" in out
           and "finished at iteration" not in out,
           f"[examples] mujoco_host on gym:HalfCheetah-v4 without "
           f"gymnasium: exit {code}:\n{out[-2000:]}")
    print(f"[examples] mujoco_host on its default gym:HalfCheetah-v4: exit "
          f"{code}, the adapter's ImportError naming gymnasium (not on the "
          f"card's machine), no other env tried", flush=True)
    _, res = counted("population_sweep", r"^4 members x 2 iterations in .*"
                     r"best member: s[0-3]$")
    row = json.loads(sweep.read_text())
    _check(set(row) == SWEEP_KEYS and row["members"] == 4
           and row["iterations"] == 2
           and res["launches"] == {"reverse_scan": 8},
           f"[examples] population_sweep row {row}, launches "
           f"{res['launches']} (K2 once a member's iteration)")
    total = _add(total, res["launches"])
    total = _add(total, _reference_style_result(
        *done["reference_style"], work / "reference_style.json", card))
    code, out = done["learning_evidence"]
    _check(code == 0, f"[examples] learning_evidence exit {code}:\n"
           f"{out[-3000:]}")
    summary = _evidence_result("cartpole", evidence, out, card)
    _check(summary["best"] >= EVIDENCE_BAR,
           f"[examples] learning_evidence cartpole best reading "
           f"{summary['best']} < {EVIDENCE_BAR}")
    total = _add(total, summary["launches"])
    print(f"[examples] {len(children)} children side by side in "
          f"{wall:.1f} s; launches {total}; logs in "
          f"{work.relative_to(ROOT)}", flush=True)
    return total


def run_evidence(rungs: list) -> int:
    """The learning runs (``--evidence=``): each rung of
    ``learning_evidence`` at its published length, seed 0, in its own
    child, one after another, each checked as ``_evidence_result`` checks
    it; a rung that fails is named and the next one runs. Prints a line
    per rung and the table; each rung's rows, update records and summary
    stay under ``build/chip_smoke/evidence/``."""
    from trpo_torch.scripts import learning_evidence

    card = _card_line()
    work = WORK / "evidence"
    work.mkdir(parents=True, exist_ok=True)
    done, failed = [], []
    for rung in rungs:
        iters, _ = learning_evidence.RUNGS[rung]
        out, log = work / f"{rung}.json", work / f"{rung}.log"
        child = _spawn(_evidence_argv(out, rung, "cuda"), log)
        try:
            code = child.wait(timeout=EVIDENCE_S[0] + EVIDENCE_S[1] * iters)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            code = "killed at its deadline"
        text = log.read_text()
        try:
            _check(code == 0, f"[evidence {rung}] exit {code}:\n"
                   f"{text[-3000:]}")
            summary = _evidence_result(rung, out, text, card)
        except SmokeFailure as e:
            print(f"[evidence {rung}] FAILED: {e}", flush=True)
            failed.append(rung)
            continue
        (work / f"{rung}.summary.json").write_text(json.dumps(summary))
        done.append(summary)
    print(f"[evidence] ({card})\n| rung | iterations | wall s | median "
          "iteration ms | first → last | best (at) | K1 | K2 | audits "
          "(update: cosine, fallback) |\n|---|---|---|---|---|---|---|---|"
          "---|")
    for s in done:
        audits = "; ".join(f"{u}: {c:.5f}{' fell back' if f else ''}"
                           for u, c, f in s["audits"]) or "none"
        print(f"| {s['rung']} | {s['iterations']} | {s['wall_s']} | "
              f"{s['median_iteration_ms']:.1f} | {s['first']} → {s['last']} "
              f"| {s['best']:.1f} ({s['best_at']}) | "
              f"{s['launches'].get('fused_fvp', 0)} | "
              f"{s['launches'].get('reverse_scan', 0)} | {audits} |")
    print(f"[evidence] failed: {failed or 'none'}", flush=True)
    return 1 if failed else 0


# ---------------------------------------------------------------------------
# [mesh] data and sequence parallelism (trpo_torch/parallel)
# ---------------------------------------------------------------------------

MESH_ROWS = 37_536         # the flagship's ¾ curvature subsample of 50,048
MESH_DIMS = (376, 256, 256, 17)
MESH_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_agent_mesh.py:52-54
TREE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_tree_update.py:53-55
# pendulum's second iteration on two data ranks against one rank: the
# first update's reassociated all-reduce sums (1.06e-5 after it) grow
# through the critic fit and the next solve, to 6.888e-4 on the H100;
# the one-rank run with its update's rows reordered alone grows alike
# (1.42e-6, then 6.0e-5 in this child on the CPU, where leg 5 reads
# 1.03e-5, then 3.55e-4; 1.333e-5, then 1.219e-3 on the H100). The limit
# is about 3x leg 5's reading on the card
LEG5_ITER2_ATOL = 2e-3
MESH_GAE = (392, 128)      # 391 steps are odd: seq=2 needs an even T
MESH_COLLECTIVE_S = 300    # every collective's timeout in the children


def _torchrun(n: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), str(ROOT / "chip_smoke.py"),
            *map(str, args)]


def _mesh_problem(torch, dev, dtype=None):
    """The flagship policy (seeded params) and leg 2's rows, drawn on the
    host from seed 0 so every rank holds the same numbers."""
    from trpo_torch.models.policy import BoxSpec, make_policy
    from trpo_torch.ops.flat import flatten_params, tree_map
    from trpo_torch.trpo import TRPOBatch

    kw = {} if dtype is None else {"compute_dtype": dtype}
    policy = make_policy((MESH_DIMS[0],), BoxSpec(MESH_DIMS[-1]),
                         hidden=MESH_DIMS[1:-1], **kw)
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.to(dev), policy.init(gen))
    obs = torch.randn(MESH_ROWS, MESH_DIMS[0], generator=gen).to(dev)
    n = flatten_params(params)[0].numel()
    v = torch.randn(n, generator=gen).to(dev)
    batch = TRPOBatch(obs, None, None, None,
                      torch.ones(MESH_ROWS, device=dev))
    return policy, params, batch, v


def _rel(torch, a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _event_ms(torch, fn, reps: int = 20) -> float:
    """Milliseconds a call by CUDA events around ``reps`` calls, after two
    warm-up calls (NaN off the card: a CPU rehearsal measures nothing)."""
    if not torch.cuda.is_available():
        return float("nan")
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _PathCounts:
    """Launches of the driven paths, apart from those made to compare a
    kernel with its plain version or a mesh run with its one-rank run."""

    def __init__(self):
        from trpo_torch.ops import _build

        self._build = _build
        self.total: dict = {}
        _build.reset_launches()

    def path(self) -> dict:
        got = {k: v for k, v in self._build.LAUNCHES.items() if v}
        self.total = _add(self.total, got)
        self._build.reset_launches()
        return got

    def skip(self) -> None:
        self._build.reset_launches()


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_nccl_child(out: str, ck1: str, ck2: str, ck4: str,
                     device: str) -> int:
    """Leg 1's resume and comparison, and leg 2, in one rank of an NCCL
    world of one (torchrun). ``device`` is ``cuda``; ``cpu`` rehearses the
    child's control flow on gloo with the plain versions."""
    import torch
    import torch.distributed as dist

    from trpo_torch import train
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig, get_preset
    from trpo_torch.ops.allreduce import all_sum
    from trpo_torch.ops.cg import conjugate_gradient
    from trpo_torch.ops.flat import flatten_params
    from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
    from trpo_torch.parallel import make_mesh, make_sharded_fused_fvp
    from trpo_torch.utils.checkpoint import Checkpointer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    res, counts = {}, _PathCounts()
    # leg 1: resume step 2 on the mesh for one iteration
    for name in ("step_1", "step_2", "step_1.complete", "step_2.complete",
                 ".markers_enabled"):
        src = Path(ck1) / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src,
                                                           Path(ck2) / name)
    with contextlib.redirect_stdout(io.StringIO()):
        res["resume_code"] = train.main([
            "--preset", "humanoid-sim", "--device", device, "--mesh-shape",
            "1", "--iterations", "1", "--checkpoint-dir", ck2,
            "--checkpoint-every", "1", "--resume"])
    res["resume_launches"] = counts.path()
    res["backend"] = dist.get_backend()
    cfg = get_preset("humanoid-sim")
    tmpl_agent = TRPOAgent(cfg.env, cfg.replace(fvp_mode="ggn"), device=dev)
    a, b = (Checkpointer(d).restore(tmpl_agent.init_state(), step=3,
                                    prune=False) for d in (ck1, ck2))
    res["resume_diff"] = _state_diff(torch, a, b)
    mesh2 = Checkpointer(ck1).restore(tmpl_agent.init_state(), step=2,
                                      prune=False)
    want = flatten_params(mesh2.policy_params)[0]
    counts.skip()
    # the same seed without a mesh, on the mesh's operator (the meshless
    # run on K1 differs from it by about 1e-8 on an H100: PERF.md)
    st1, _ = tmpl_agent.run_iterations(tmpl_agent.init_state(), 1)
    st, _ = tmpl_agent.run_iterations(st1, 1)
    got = flatten_params(st.policy_params)[0]
    res["meshless_close"] = bool(torch.allclose(want, got, **MESH_TOL))
    res["meshless_maxdiff"] = float((want - got).abs().max())
    # leg 4's step 1 (data x model, gathered into its checkpoint) against
    # the same meshless run's step 1
    tp1 = flatten_params(Checkpointer(ck4).restore(
        tmpl_agent.init_state(), step=1, prune=False).policy_params)[0]
    one1 = flatten_params(st1.policy_params)[0]
    res["leg4_close"] = bool(torch.allclose(tp1, one1, **MESH_TOL))
    res["leg4_maxdiff"] = float((tp1 - one1).abs().max())
    counts.skip()
    # leg 2: the sharded fused FVP at the flagship shape, inside CG
    mesh = make_mesh((1,), ("data",), device=dev)
    group = mesh.group("data")
    for dtype, key in ((None, "f32"), (torch.bfloat16, "bf16")):
        policy, params, batch, v = _mesh_problem(torch, dev, dtype)
        op = make_sharded_fused_fvp(policy, TRPOConfig(cg_damping=0.1),
                                    mesh).operator(params, batch)
        y = op(v)
        x = conjugate_gradient(op, v, cg_iters=10, residual_tol=0.0).x
        _sync(torch, dev)
        res[f"leg2_{key}_launches"] = counts.path()
        # K1 alone over every row, its damping added after it as the
        # sharded operator adds it after the all-reduce
        single = make_fused_gaussian_mlp_fvp(
            params["net"], batch.obs, batch.weight, params["log_std"], 0.0,
            compute_dtype=dtype or torch.float32)
        k1 = lambda u: single.flat(u) + 0.1 * u.float()  # noqa: E731
        y1 = k1(v)
        x1 = conjugate_gradient(k1, v, cg_iters=10, residual_tol=0.0).x
        res[f"leg2_{key}_fvp_rel"] = _rel(torch, y, y1)
        res[f"leg2_{key}_cg_rel"] = _rel(torch, x, x1)
        res[f"leg2_{key}_plain_rel"] = _rel(torch, y,
                                            single.plain(v) + 0.1 * v)
        res[f"leg2_{key}_ms"] = _event_ms(torch, lambda: op(v))
        res[f"leg2_{key}_k1_ms"] = _event_ms(torch, lambda: single.flat(v))
        counts.skip()
    payload = torch.zeros(flatten_params(params)[0].numel() + 1, device=dev)
    res["leg2_floats"] = payload.numel()
    res["leg2_allreduce_us"] = 1e3 * _event_ms(
        torch, lambda: all_sum(payload, group))
    res["path_launches"] = counts.total
    Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def _mesh_gloo_child(out_prefix: str, device: str) -> int:
    """Leg 3 in one of two ranks sharing the one card over gloo: NCCL
    refuses two ranks on one device (``device="cpu"`` rehearses it)."""
    import torch
    import torch.distributed as dist

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import TRPOConfig, get_preset
    from trpo_torch.ops.flat import flatten_params
    from trpo_torch.ops.fused_fvp import make_fused_gaussian_mlp_fvp
    from trpo_torch.ops.returns import gae_from_next_values
    from trpo_torch.parallel import (
        initialize_distributed,
        make_mesh,
        make_sharded_fused_fvp,
        seq_sharded_gae,
        shard_batch,
    )
    from trpo_torch.population import Population

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(backend="gloo", timeout=MESH_COLLECTIVE_S)
    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    res, counts = {"backend": dist.get_backend()}, _PathCounts()
    mesh = make_mesh((2,), ("data",), device=dev)
    # the fused FVP over two halves of leg 2's rows
    policy, params, batch, v = _mesh_problem(torch, dev)
    y = make_sharded_fused_fvp(policy, TRPOConfig(cg_damping=0.1), mesh)(
        params, shard_batch(mesh, batch), v)
    _sync(torch, dev)
    res["fvp_launches"] = counts.path()
    if rank == 0:
        y1 = make_fused_gaussian_mlp_fvp(
            params["net"], batch.obs, batch.weight, params["log_std"],
            0.0).flat(v) + 0.1 * v
        res["fvp_rel"] = _rel(torch, y, y1)
    counts.skip()
    # the sequence-parallel GAE on K2 per rank
    seq = make_mesh((2,), ("seq",), device=dev)
    gen = torch.Generator().manual_seed(1)
    T, N = MESH_GAE
    args = [torch.randn(T, N, generator=gen).to(dev) for _ in range(3)]
    flags = [(torch.rand(T, N, generator=gen) < p).to(dev)
             for p in (0.005, 0.01)]
    term, done = flags[0], flags[0] | flags[1]
    adv, vt = seq_sharded_gae(seq, args[0], args[1], args[2], term, done,
                              0.99, 0.97)
    _sync(torch, dev)
    res["gae_launches"] = counts.path()
    if rank == 0:
        want, _ = gae_from_next_values(args[0], args[1], args[2], term,
                                       done, 0.99, 0.97)
        res["gae_err"] = float((adv - want).abs().max())
        res["gae_scale"] = float(want.abs().max())
    counts.skip()
    # cartpole-fleet on a data×seq mesh, against its one-rank run
    cfg = get_preset("cartpole-fleet")
    agent = TRPOAgent(cfg.env, cfg.replace(mesh_shape=(1, 2),
                                           mesh_axes=("data", "seq")),
                      device=dev)
    st, stats = agent.run_iterations(agent.init_state(), 2)
    got = flatten_params(st.policy_params)[0]
    res["fleet_launches"] = counts.path()
    res["fleet_kl"] = [float(k) for k in stats["kl_old_new"]]
    if rank == 0:
        solo = TRPOAgent(cfg.env, cfg, device=dev)
        s1, _ = solo.run_iterations(solo.init_state(), 2)
        want = flatten_params(s1.policy_params)[0]
        res["fleet_close"] = bool(torch.allclose(got, want, **MESH_TOL))
        res["fleet_maxdiff"] = float((got - want).abs().max())
        counts.skip()
    # Population(mesh): four humanoid-sim members, two a rank
    hcfg = get_preset("humanoid-sim")
    pop = Population(TRPOAgent(hcfg.env, hcfg, device=dev), [0, 1, 2, 3],
                     mesh=mesh)
    pstats = pop.run_iteration()
    _sync(torch, dev)
    res["pop_launches"] = counts.path()
    res["pop_reward"] = [float(r) for r in pstats["mean_episode_reward"]]
    if rank == 0:
        solo = TRPOAgent(hcfg.env, hcfg.replace(fvp_mode="ggn"), device=dev)
        s1, _ = solo.run_iteration(solo.init_state(1))
        res["pop_member1_diff"] = _state_diff(torch, pop.member_state(1), s1)
        counts.skip()
    res["path_launches"] = counts.total
    Path(f"{out_prefix}.{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def _mesh_tp_child(out_prefix: str, ck4: str, device: str) -> int:
    """In one of two ranks sharing the one card over gloo: legs 5 and 6,
    then, once leg 4's train child (beside this one) has completed its
    step 2 in ``ck4``, leg 4's layout and checkpoint."""
    import torch
    import torch.distributed as dist

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.ops.flat import flatten_params
    from trpo_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(backend="gloo", timeout=MESH_COLLECTIVE_S)
    rank = dist.get_rank()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    res, counts = {"backend": dist.get_backend()}, _PathCounts()
    flat = lambda p: flatten_params(p)[0]  # noqa: E731

    def iterate(agent, n):
        """``n`` iterations one at a time: every iteration's params
        (whole) and the stacked stats."""
        st, flats, rows = agent.init_state(), [], []
        for _ in range(n):
            st, stats = agent.run_iteration(st)
            flats.append(flat(agent.gather_params(st.policy_params)))
            rows.append(stats)
        return flats, {k: [float(r[k]) for r in rows] for k in rows[0]}

    def one_rank(cfg, n, reorder=False):
        """The same config without a mesh, on the mesh's operator (the
        GGN: a mesh agent never takes K1), on rank 0 (its launches are
        not the path's); with ``reorder`` each update takes its batch's
        rows in a seeded other order."""
        counts.skip()
        solo = TRPOAgent(cfg.env, cfg.replace(fvp_mode="ggn"), device=dev)
        if reorder:
            solo.trpo_update = _reordered(solo.trpo_update)
        got = iterate(solo, n)
        counts.skip()
        return got

    _mesh_legs56(res, counts, iterate, one_rank, dev, rank)
    t0 = time.perf_counter()
    while not (Path(ck4) / "step_2.complete").exists():
        if time.perf_counter() - t0 > MESH_COLLECTIVE_S:
            raise SmokeFailure(f"leg 4's step 2 never completed in {ck4}")
        time.sleep(0.2)
    t0 = time.perf_counter()
    _mesh_leg4_layout(res, ck4, dev, rank, flat)
    res["leg4_layout_s"] = time.perf_counter() - t0
    res["path_launches"] = counts.total
    Path(f"{out_prefix}.{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def _reordered(update):
    """``update`` on its batch's rows in a seeded other order: the same
    sums, reassociated."""
    from trpo_torch.ops.flat import tree_map
    from trpo_torch.trpo import TRPOBatch

    def reordered(params, batch, *args, **kwargs):
        import torch

        p = torch.randperm(batch.obs.shape[0],
                           generator=torch.Generator().manual_seed(1)).to(
            batch.obs.device)
        return update(params, TRPOBatch(*tree_map(lambda t: t[p],
                                                  tuple(batch))),
                      *args, **kwargs)

    return reordered


def _mesh_leg4_layout(res, ck4, dev, rank, flat) -> None:
    """Leg 4: rank 0's blocks, the checkpoint restored on the mesh and on
    one rank, the model-axis all-reduce's µs a call."""
    import torch

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset
    from trpo_torch.parallel.tp import reduce_from_model
    from trpo_torch.utils.checkpoint import Checkpointer

    hcfg = get_preset("humanoid-sim")
    tcfg = hcfg.replace(mesh_shape=(1, 2), mesh_axes=("data", "model"))
    agent = TRPOAgent(tcfg.env, tcfg, device=dev)
    layers = agent.init_state().policy_params["net"]["layers"]
    res["leg4_shapes"] = [list(layer["w"].shape) for layer in layers]
    restored = Checkpointer(ck4, mesh=agent.mesh,
                            param_layout=agent.param_layout).restore(
        agent.init_state(), step=2, prune=False)
    gathered = flat(agent.gather_params(restored.policy_params))
    if rank == 0:
        solo = TRPOAgent(hcfg.env, hcfg, device=dev)
        one = Checkpointer(ck4).restore(solo.init_state(), step=2,
                                        prune=False)
        res["leg4_restore_equal"] = bool(torch.equal(
            gathered, flat(one.policy_params)))
    # the model-axis all-reduce at the act's and the update's widths
    tp = agent.policy.tp
    for rows, key in ((128, "act"), (50_048, "update")):
        x = torch.ones(rows, 256, device=dev)
        res[f"allreduce_{key}_us"] = 1e3 * _wall_ms(
            torch, dev, lambda: reduce_from_model(x, tp), 10)


def _mesh_legs56(res, counts, iterate, one_rank, dev, rank) -> None:
    """Leg 5 (pendulum on native: over two data ranks, and its witness,
    the device pendulum on the same mesh) and leg 6 (the MoE on data x
    expert, the GRU on data x model), each against one rank."""
    import torch

    from trpo_torch.agent import TRPOAgent
    from trpo_torch.config import get_preset

    for key, cfg, n in (
            ("leg5", get_preset("pendulum").replace(env="native:pendulum"),
             2),
            ("leg6_expert", get_preset("cartpole").replace(
                policy_experts=4), 1),
            ("leg6_gru", get_preset("cartpole-po"), 1)):
        axes = {"leg5": ("data",), "leg6_expert": ("data", "expert"),
                "leg6_gru": ("data", "model")}[key]
        mesh_cfg = cfg.replace(mesh_shape=(2,) if len(axes) == 1 else (1, 2),
                               mesh_axes=axes)
        t0 = time.perf_counter()
        agent = TRPOAgent(mesh_cfg.env, mesh_cfg, device=dev)
        got, stats = iterate(agent, n)
        _sync(torch, dev)
        res[f"{key}_s"] = time.perf_counter() - t0
        res[f"{key}_launches"] = counts.path()
        res[f"{key}_kl"] = stats["kl_old_new"]
        del agent
        if rank == 0:
            want, wstats = one_rank(cfg, n)
            # after each iteration; the first is the one held to the
            # reference's tree-update tolerance (a later one compounds the
            # reassociated sums through the critic and the next solve)
            res[f"{key}_maxdiff"] = [float((g - w).abs().max())
                                     for g, w in zip(got, want)]
            res[f"{key}_close"] = bool(torch.allclose(got[0], want[0],
                                                      **TREE_TOL))
            res[f"{key}_reward"] = [stats["mean_episode_reward"][0],
                                    wstats["mean_episode_reward"][0]]
            if key == "leg5":
                # the witness: only the order of the update's sums moved
                order, _ = one_rank(cfg, n, reorder=True)
                res["leg5_order_maxdiff"] = [float((g - w).abs().max())
                                             for g, w in zip(order, want)]


def _wall_ms(torch, dev, fn, reps: int) -> float:
    """Milliseconds a call on the host clock, synchronized, after one
    warm-up call (a gloo collective waits on the host)."""
    fn()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch, dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _mesh_child(mode: str, argv: list) -> int:
    """A ``[mesh]`` child, started by torchrun with this script."""
    if mode == "train":
        sys.argv = [sys.argv[0]] + argv[1:]
        return _counted_child(argv[0].format(
            rank=os.environ.get("RANK", "0")))
    if mode == "nccl":
        return _mesh_nccl_child(*argv)
    if mode == "tp":
        return _mesh_tp_child(*argv)
    return _mesh_gloo_child(*argv)


def phase_mesh(torch, dev, beside=None):
    """Data and sequence parallelism on the card, in child processes (the
    parent never holds a process group): leg 1 the flagship through the
    train CLI under torchrun on an NCCL world of one (3 iterations, a
    checkpoint each), resumed from step 2 (bitwise the uninterrupted step
    3), its step 2 against the meshless run; leg 2 the sharded fused FVP
    at 37,536 x 376-256-256-17 inside a 10-iteration CG (f32 and bf16)
    against K1 / K1-bf16 alone, with its all-reduce timed; leg 3 two ranks
    on the one card over gloo: the FVP over two halves, the
    sequence-parallel GAE on K2, cartpole-fleet on data x seq against one
    rank, and Population(mesh) with member 1 bitwise its solo run; legs
    4-6 on parameter axes and host envs. ``beside``, when given, runs in
    this process while the first wave of children (legs 1, 3, 4, 5-6) runs:
    the second wave (leg 2's timings) starts after it returns. Returns the
    children's path launches, with ``beside``'s."""
    import threading

    card = _card_line()
    work = WORK / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True, exist_ok=True)
    ck1, ck2, ck4 = work / "ck1", work / "ck2", work / "ck4"
    ck2.mkdir()
    total, secs = {}, {}

    ended = {}

    def start(tag, argv):
        log = open(work / f"{tag}.log", "w")
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        # the child's own end, which a caller busy ``beside`` reads late
        threading.Thread(target=lambda: ended.setdefault(
            tag, (proc.wait(), time.perf_counter())[1]), daemon=True).start()
        return (tag, time.perf_counter(), log, proc)

    def finish(started, timeout):
        tag, t0, log, proc = started
        try:
            code = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        secs[tag] = ended.get(tag, time.perf_counter()) - t0
        out = (work / f"{tag}.log").read_text()
        _check(code == 0, f"[mesh] {tag} exit {code}:\n{out[-3000:]}")
        return out

    # leg 3 (two ranks on the one card over gloo) runs beside leg 1's
    # train child; leg 2's timings run alone after both
    prefix = work / "gloo"
    leg3 = start("leg3_gloo", _torchrun(2, "--mesh-child=gloo", prefix,
                                        dev.type))
    # legs 5-6 (two gloo ranks) beside them, then leg 4's layout and
    # checkpoint once leg 4's train child has written its step 2
    legs56 = start("legs56_gloo", _torchrun(2, "--mesh-child=tp",
                                            work / "legs56", ck4, dev.type))
    # leg 4: the train CLI on data x model, two gloo ranks on the card
    leg4 = start("leg4_train", _torchrun(
        2, "--mesh-child=train", work / "tp_counts.{rank}.json", "--preset",
        "humanoid-sim", "--device", dev.type, "--mesh-shape", "1,2",
        "--mesh-axes", "data,model", "--iterations", "2",
        "--checkpoint-dir", ck4, "--checkpoint-every", "1"))
    # leg 1: python -m trpo_torch.train under torchrun, NCCL world of one
    counts_path = work / "train_counts.json"
    try:
        leg1 = start("leg1_train", _torchrun(
            1, "--mesh-child=train", counts_path, "--preset", "humanoid-sim",
            "--device", dev.type, "--mesh-shape", "1", "--iterations", "3",
            "--checkpoint-dir", ck1, "--checkpoint-every", "1"))
        if beside is not None:
            total = _add(total, beside() or {})
        train_out = finish(leg1, 300)
    finally:
        try:
            finish(leg3, 300)
        finally:
            try:
                leg4_out = finish(leg4, 400)
            finally:
                finish(legs56, 400)
    rows = [ln for ln in train_out.splitlines() if ln.startswith("iter ")]
    _check(len(rows) == 3, f"[mesh] leg 1: {len(rows)} rows")
    train = {k: v for k, v in json.loads(counts_path.read_text())[
        "launches"].items() if v}
    _check(train == {"reverse_scan": 3}, f"[mesh] leg 1 launches {train} "
           "(K2 once an iteration, K1 never: the GGN operator on a mesh)")
    total = _add(total, train)
    rows4 = [ln for ln in leg4_out.splitlines() if ln.startswith("iter ")]
    _check(len(rows4) == 2, f"[mesh] leg 4: {len(rows4)} rows (rank 0 "
           "alone writes them)")
    leg4 = [json.loads((work / f"tp_counts.{i}.json").read_text())
            for i in (0, 1)]
    leg4 = [{k: v for k, v in c["launches"].items() if v} for c in leg4]
    _check(all(c == {"reverse_scan": 2} for c in leg4), f"[mesh] leg 4 "
           f"launches per rank {leg4} (K2 once an iteration, K1 never: the "
           "tree update on a parameter axis)")
    for c in leg4:
        total = _add(total, c)
    out = work / "nccl.json"
    finish(start("leg1_resume_leg2", _torchrun(
        1, "--mesh-child=nccl", out, ck1, ck2, ck4, dev.type)), 300)
    r = json.loads(out.read_text())
    _check(r["backend"] == ("nccl" if dev.type == "cuda" else "gloo")
           and r["resume_code"] == 0,
           f"[mesh] resume child: {r['backend']}, exit {r['resume_code']}")
    _check(r["resume_launches"] == {"reverse_scan": 1},
           f"[mesh] resume launches {r['resume_launches']}")
    _check(not r["resume_diff"], f"[mesh] resumed step 3 differs from the "
           f"uninterrupted run: {r['resume_diff'][:4]}")
    _check(r["meshless_close"], "[mesh] the mesh's step 2 against the "
           f"meshless GGN run: max|diff| {r['meshless_maxdiff']:.3e}")
    for key, bound in (("f32_fvp_rel", K1_RTOL), ("f32_cg_rel", K1_RTOL),
                       ("f32_plain_rel", K1_RTOL),
                       ("bf16_fvp_rel", K1_BF16_RTOL),
                       ("bf16_plain_rel", K1_BF16_RTOL)):
        _check(r[f"leg2_{key}"] < bound, f"[mesh] leg 2 {key} "
               f"{r[f'leg2_{key}']:.3e} >= {bound}")
    _check(r["leg2_f32_launches"] == {"fused_fvp": 11}
           and r["leg2_bf16_launches"] == {"fused_fvp_bf16": 11},
           f"[mesh] leg 2 launches {r['leg2_f32_launches']} "
           f"{r['leg2_bf16_launches']}")
    total = _add(total, r["path_launches"])
    _check(r["leg4_close"], "[mesh] leg 4 step 1 on data x model against "
           f"the meshless GGN run: max|diff| {r['leg4_maxdiff']:.3e}")
    tpr = [json.loads((work / f"legs56.{i}.json").read_text())
           for i in (0, 1)]
    d_in, h1, h2, d_out = MESH_DIMS   # a head of odd width stays whole
    _check(tpr[0]["leg4_shapes"] == [[d_in, h1 // 2], [h1 // 2, h2],
                                     [h2, d_out // (2 - d_out % 2)]],
           f"[mesh] leg 4 rank 0's blocks {tpr[0]['leg4_shapes']}")
    _check(tpr[0]["leg4_restore_equal"], "[mesh] leg 4's checkpoint "
           "restored on one rank differs from the gathered params")
    for key in ("leg5", "leg6_expert", "leg6_gru"):
        _check(tpr[0][f"{key}_close"], f"[mesh] {key} against one rank "
               f"after its first iteration: max|diff| "
               f"{tpr[0][f'{key}_maxdiff']}")
    _check(tpr[0]["leg5_maxdiff"][1] <= LEG5_ITER2_ATOL,
           "[mesh] leg5 against one rank after its second iteration: "
           f"max|diff| {tpr[0]['leg5_maxdiff'][1]:.3e} > {LEG5_ITER2_ATOL}")
    # the first window's episodes: the env slices seeded by global index,
    # the noise drawn globally
    mesh_r, one_r = tpr[0]["leg5_reward"]
    _check(abs(mesh_r - one_r) <= 1e-5 * abs(one_r), "[mesh] leg 5's "
           f"first window: mean episode reward {mesh_r} against {one_r}")
    for x in tpr:
        _check(x["leg5_launches"] == {"reverse_scan": 2}
               and x["leg6_expert_launches"] == {"reverse_scan": 1}
               and x["leg6_gru_launches"] == {"reverse_scan": 1},
               f"[mesh] legs 5-6 launches {x}")
        total = _add(total, x["path_launches"])
    # leg 3's results
    g = [json.loads((work / f"gloo.{i}.json").read_text()) for i in (0, 1)]
    _check(all(x["backend"] == "gloo" for x in g), "[mesh] leg 3 backend")
    _check(g[0]["fvp_rel"] < K1_RTOL, f"[mesh] leg 3 FVP halves: relative "
           f"L2 {g[0]['fvp_rel']:.3e} to one K1 over every row")
    _check(g[0]["gae_err"] <= K2_TOL * max(1.0, g[0]["gae_scale"]),
           f"[mesh] leg 3 seq GAE: max err {g[0]['gae_err']:.3e}")
    _check(g[0]["fleet_close"], "[mesh] leg 3 cartpole-fleet data x seq "
           f"against one rank: max|diff| {g[0]['fleet_maxdiff']:.3e}")
    _check(not g[0]["pop_member1_diff"], "[mesh] leg 3 population member 1 "
           f"against its solo run: {g[0]['pop_member1_diff'][:4]}")
    for x in g:
        _check(x["fvp_launches"] == {"fused_fvp": 1}
               and x["gae_launches"] == {"reverse_scan": 2}
               and x["fleet_launches"] == {"reverse_scan": 4}
               and x["pop_launches"] == {"reverse_scan": 2},
               f"[mesh] leg 3 launches {x}")
        total = _add(total, x["path_launches"])
    print(f"[mesh] leg 1: torchrun --nproc_per_node 1 -m trpo_torch.train "
          f"--preset humanoid-sim --mesh-shape 1 (NCCL, 3 iterations, "
          f"{secs['leg1_train']:.1f} s): K2 {train.get('reverse_scan')}, K1 "
          f"0 (the GGN operator on a mesh); resumed from step 2 bitwise the "
          f"uninterrupted step 3; step 2 against the meshless run on the "
          f"same operator max|diff| {r['meshless_maxdiff']:.3e} "
          f"(rtol 1e-4/atol 1e-5) ({card})", flush=True)
    print(f"[mesh] leg 2: make_sharded_fused_fvp at {MESH_ROWS} x "
          f"{'-'.join(map(str, MESH_DIMS))}, NCCL world of one: f32 "
          f"{r['leg2_f32_ms']:.4f} ms a call against K1 alone "
          f"{r['leg2_f32_k1_ms']:.4f} ms, FVP rel L2 "
          f"{r['leg2_f32_fvp_rel']:.2e}, 10-iteration CG rel L2 "
          f"{r['leg2_f32_cg_rel']:.2e}; bf16 {r['leg2_bf16_ms']:.4f} ms "
          f"against K1-bf16 {r['leg2_bf16_k1_ms']:.4f} ms, rel L2 "
          f"{r['leg2_bf16_fvp_rel']:.2e} (plain bf16 "
          f"{r['leg2_bf16_plain_rel']:.2e}); all-reduce of "
          f"{r['leg2_floats']} floats {r['leg2_allreduce_us']:.1f} us "
          f"({card})", flush=True)
    print(f"[mesh] leg 3: two ranks on the one card over gloo (NCCL refuses "
          f"two ranks on one device; collectives staged through host "
          f"memory), beside leg 1, both done in "
          f"{secs['leg3_gloo']:.1f} s: FVP over two halves rel L2 "
          f"{g[0]['fvp_rel']:.2e} to one K1; seq GAE at {MESH_GAE} max err "
          f"{g[0]['gae_err']:.2e}; cartpole-fleet on data x seq against "
          f"one rank max|diff| {g[0]['fleet_maxdiff']:.3e}, KL "
          f"{g[0]['fleet_kl']}; Population(mesh) member 1 bitwise its solo "
          f"run, rewards {g[0]['pop_reward']} ({card})", flush=True)
    print(f"[mesh] leg 4: torchrun --nproc_per_node 2 -m trpo_torch.train "
          f"--preset humanoid-sim --mesh-shape 1,2 --mesh-axes data,model "
          f"(two gloo ranks on the card, 2 iterations, beside legs 1 and 3, "
          f"{secs['leg4_train']:.1f} s): K2 per rank {leg4}, K1 0 (the tree "
          f"update); rank 0 holds w {tpr[0]['leg4_shapes']}; step 1 against "
          f"the meshless GGN run max|diff| {r['leg4_maxdiff']:.3e} (rtol "
          f"1e-4/atol 1e-5); its checkpoint restored on one rank bitwise the "
          f"gathered params; model-axis all-reduce (gloo, staged through "
          f"host memory) {tpr[0]['allreduce_act_us']:.1f} us a call at "
          f"128 x 256 f32, {tpr[0]['allreduce_update_us']:.1f} us at "
          f"50,048 x 256 ({card})", flush=True)
    print(f"[mesh] leg 5: pendulum on native:pendulum over two data ranks "
          f"(2 iterations, {tpr[0]['leg5_s']:.1f} s) against one rank on "
          f"the GGN: first window's mean episode reward "
          f"{tpr[0]['leg5_reward'][0]!r} against "
          f"{tpr[0]['leg5_reward'][1]!r}; max|diff| after each iteration "
          f"{tpr[0]['leg5_maxdiff']} (the first within rtol 2e-4/atol "
          f"2e-5, the second within {LEG5_ITER2_ATOL}), KL "
          f"{tpr[0]['leg5_kl']}, K2 per rank "
          f"{[x['leg5_launches'] for x in tpr]}; witness: the one-rank run "
          f"with its update's rows reordered max|diff| "
          f"{tpr[0]['leg5_order_maxdiff']} ({card})", flush=True)
    print(f"[mesh] leg 6: cartpole, 4 experts, on data x expert "
          f"({tpr[0]['leg6_expert_s']:.1f} s) max|diff| "
          f"{tpr[0]['leg6_expert_maxdiff']}; cartpole-po GRU on data x "
          f"model ({tpr[0]['leg6_gru_s']:.1f} s) max|diff| "
          f"{tpr[0]['leg6_gru_maxdiff']}, against one rank; K2 per rank "
          f"{[x['leg6_expert_launches'] for x in tpr]}, "
          f"{[x['leg6_gru_launches'] for x in tpr]}; legs 5-6's child "
          f"{secs['legs56_gloo']:.1f} s beside legs 1, 3 and 4, leg 4's "
          f"layout and checkpoint after them in the same child "
          f"{tpr[0]['leg4_layout_s']:.1f} s ({card})", flush=True)
    print(f"[mesh] child seconds {json.dumps(secs)}; path launches {total}",
          flush=True)
    return total


def phase_bench(torch):
    from trpo_torch import bench

    res = bench.run("cuda")
    print(f"[bench] {json.dumps(res)}", flush=True)
    values = [res["value"], res["update_ms"], res["vs_baseline"],
              *res["paths"].values()]
    _check(all(math.isfinite(v) and v > 0 for v in values),
           f"[bench] not every number is finite and positive: {res}")


def main() -> int:
    child = [a for a in sys.argv[1:] if a.startswith("--mesh-child=")]
    if child:
        return _mesh_child(child[0].split("=", 1)[1], sys.argv[2:])
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
    evidence = [a.split("=", 1)[1] for a in sys.argv[1:]
                if a.startswith("--evidence=")]
    if evidence:
        # the learning runs alone (no kernel phases, no result lines)
        from trpo_torch.scripts.learning_evidence import RUNGS

        rungs = evidence[0].split(",")
        return run_evidence(list(RUNGS) if rungs == ["all"] else rungs)
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--phases=")]
    if only:
        # named path phases alone (no kernel phases, no result lines)
        for tag in only[0]:
            t0 = time.perf_counter()
            got = globals()[f"phase_{tag}"](torch, dev)
            print(f"[time] {tag} {time.perf_counter() - t0:.1f} s; "
                  f"launches {got}", flush=True)
        return 0
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
                ("serve", lambda: phase_serve(torch, dev)),
                ("control", lambda: phase_control(torch, dev)),
                ("obs", lambda: phase_obs(torch, dev)),
                ("chaos", lambda: phase_chaos(torch, dev)),
                ("replay", lambda: phase_replay(torch, dev)),
                ("flywheel", lambda: phase_flywheel(torch, dev)),
                ("compat", lambda: phase_compat(torch, dev)),
                # children that run side by side, their checks functional:
                # [examples]' children (with [preempt]'s child beside them)
                # run beside [mesh]'s first wave; [mesh]'s timed second
                # wave starts once they are all done
                ("examples+preempt+mesh", lambda: phase_mesh(
                    torch, dev, beside=lambda: phase_examples(
                        torch, dev,
                        beside=lambda: phase_preempt(torch, dev)))),
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
