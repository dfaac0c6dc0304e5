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
     shape and small ragged ones, with the device time of each of its
     sub-kernels (profiler);
  4. ``[fvp-bf16]`` K1-bf16 against its plain bf16 version and against
     K1, at the same shapes, beside the ``torch.func`` GGN at bf16;
  5. ``[main]`` the main path: 3 ``TRPOAgent.run_iteration`` calls on the
     ``humanoid-sim`` preset unchanged (its ¾ curvature subsample audited
     every 25 updates), with every kernel's launch count read around them,
     and the stage times of an audited and of an unaudited update;
  6. ``[bf16]`` the same preset on the ladder's bf16 rung, 3 iterations;
  7. ``[fleet]`` ``humanoid-sim-fleet`` unchanged (1,024 envs, 49-step
     windows in 7-step chunks), 2 iterations;
  8. ``[cartpole]`` ``cartpole`` and ``cartpole-fleet``, 2 iterations each;
  9. ``[small]`` one audited update on a small input, on the card against
     the CPU.
Each path (5-8) is driven with the launch counts set to 0 just before it
and read just after.

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
    """The same model for K1-bf16: ``obs`` and the ``h_k`` are bf16 (2 B);
    the per-row scratch (``dh``, ``c32``, ``g32``) is f32, read as f32 by
    the next product (which rounds it on load) and, for ``c32``/``g32``,
    by both the weight-gradient and the bias-sum kernels."""
    L = len(dims) - 2
    h = [rows * d for d in dims[1:-1]]
    obs, c = rows * dims[0], rows * dims[-1]
    a = 2 * obs + 2 * h[0] + 4 * h[0]                   # obs @ V0 -> dh0
    for k in range(1, L):
        a += 2 * h[k - 1] + 4 * h[k - 1] + 2 * h[k] + 4 * h[k]
    a += 2 * h[L - 1] + 4 * h[L - 1] + 4 * c            # Fisher -> c32
    a += 4 * c + 2 * h[L - 1] + 4 * h[L - 1]            # c W^T -> g32
    for k in range(L - 1, 0, -1):
        a += 4 * h[k] + 2 * h[k - 1] + 4 * h[k - 1]     # g W^T -> g32
    params = sum(x * y + y for x, y in zip(dims[:-1], dims[1:]))
    b = (2 * (obs + sum(h)) + 2 * 4 * (sum(h) + c)
         + 4 * 2 * splits * params + 4 * 2 * params)
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


def phase_fvp_bf16(torch, np, peaks, dev):
    """K1-bf16 against its plain bf16 version (same inputs, the card), and
    against f32 K1; timed beside the ``torch.func`` GGN over the bf16
    ``apply_cast`` forward (the library yardstick)."""
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
    ]
    rec = {}
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
        err = (out - ref).abs().max().item()
        again = op.flat(v)
        bitwise = bool(torch.equal(out, again))
        _check(rel_plain <= K1_BF16_RTOL,
               f"K1-bf16 {dims} {activation}: rel err vs plain {rel_plain}")
        _check(bitwise, f"K1-bf16 {dims}: two calls on the same v differ")
        line = (f"[fvp-bf16] {rows}x{'->'.join(map(str, dims))} {activation}"
                f" rel_err_plain={rel_plain:.3e} max_abs_err={err:.3e} "
                f"rel_err_vs_f32_k1={rel_f32:.3e} bitwise_repeat={bitwise}")
        if rows == flagship_rows:
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
            line += (f" kernel_ms={ms:.4f} host_issued_ms={host_ms:.4f} "
                     f"plain_ms={plain_ms:.4f} "
                     f"plain_host_issued_ms={plain_host_ms:.4f} "
                     f"ggn_bf16_ms={ggn_ms:.4f} "
                     f"ggn_bf16_host_issued_ms={ggn_host_ms:.4f} "
                     f"bound_ms={bound:.4f} ({by}: {2.0 * macs / 1e9:.2f} "
                     f"GFLOP at the bf16 tensor rate, {nbytes / 1e6:.1f} MB)"
                     f" share_of_bound={bound / ms:.3f} | bytes per call by "
                     f"design (model from the shapes): phase A "
                     f"{design[0] / 1e6:.1f} MB, phase B "
                     f"{design[1] / 1e6:.1f} MB, total "
                     f"{sum(design) / 1e6:.1f} MB = "
                     f"{sum(design) / peaks['bytes'] * 1e3:.4f} ms")
            rec = {"max_abs_err": err, "rel_err_plain": rel_plain,
                   "rel_err_vs_f32_k1": rel_f32, "ms": ms,
                   "host_issued_ms": host_ms, "plain_ms": plain_ms,
                   "plain_host_issued_ms": plain_host_ms,
                   "bound_ms": bound, "bound_by": by, "library_ms": ggn_ms,
                   "library_host_issued_ms": ggn_host_ms}
            phases, _ = _kernel_phases(torch, lambda: op.flat(v))
            if phases:
                print("[fvp-bf16] phases (torch.profiler, device µs per "
                      "call): " + "; ".join(f"{n} x{c:g} = {us:.1f}"
                                            for n, c, us in phases),
                      flush=True)
            del ggn
        print(line, flush=True)
        del op, op32
    _build.reset_launches()
    return rec


def _finite(torch, value) -> bool:
    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value.float()).all().item())
    return math.isfinite(float(value))


def _drive(torch, dev, tag, cfg, n_iter):
    """``n_iter`` ``run_iteration`` calls on a fresh agent (seed 0), every
    launch count set to 0 just before and read just after; checks the
    stats. Returns (agent, state, per-iteration stats, counts)."""
    from trpo_torch.agent import TRPOAgent
    from trpo_torch.ops import _build

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
    _check(counts.get("reverse_scan", 0) >= n_iter,
           f"[{tag}] reverse scan launched {counts.get('reverse_scan', 0)} "
           "times")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    _check(not plain, f"[{tag}] a plain version ran: {plain}")
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
    _check(counts.get("fused_fvp", 0) >= cfg.cg_iters + 1
           and counts.get("fused_fvp", 0) >= 11 * n_iter,
           f"[main] K1 launched {counts.get('fused_fvp', 0)} times")
    print(f"[main] update 1 audit: solve_cosine={rows[0]['solve_cosine']:.6f}"
          f" fallback={rows[0]['solve_fallback']}", flush=True)
    # the next update is unaudited (step 3 of 25); the audited one runs on
    # the ladder advanced to the next audit step
    plain_ms = _stage_breakdown(torch, agent, state, "main", "unaudited")
    lad = state.ladder
    step = -(-lad.step_host // cfg.solve_audit_every) * cfg.solve_audit_every
    audited = state._replace(ladder=lad._replace(
        step=torch.full_like(lad.step, step), step_host=step))
    audit_ms = _stage_breakdown(torch, agent, audited, "main", "audited")
    return counts, {"unaudited": plain_ms, "audited": audit_ms}


def phase_bf16(torch, dev):
    """``humanoid-sim`` on the ladder's bf16 rung: the cheap solve runs on
    K1-bf16, the audit on the f32 ``torch.func`` GGN."""
    from trpo_torch.config import get_preset

    cfg = get_preset("humanoid-sim").replace(fvp_dtype="bf16")
    n_iter = 3
    agent, state, rows, counts = _drive(torch, dev, "bf16", cfg, n_iter)
    unpinned = sum(1 for r in rows if not r["solve_pinned"])
    print(f"[bf16] update 1 audit: solve_cosine={rows[0]['solve_cosine']:.6f}"
          f" fallback={rows[0]['solve_fallback']} (floor "
          f"{cfg.solve_cosine_floor})", flush=True)
    _check(counts.get("fused_fvp_bf16", 0) >= (cfg.cg_iters + 1) * unpinned,
           f"[bf16] K1-bf16 launched {counts.get('fused_fvp_bf16', 0)} times"
           f" over {unpinned} unpinned iterations")
    _check(counts.get("fused_fvp", 0) == 0,
           f"[bf16] f32 K1 ran in the cheap solve: {counts}")
    _stage_breakdown(torch, agent, state, "bf16", "unaudited")
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

    for name in ("cartpole", "cartpole-fleet"):
        _drive(torch, dev, "cartpole", get_preset(name), 2)


def _stage_breakdown(torch, agent, state, tag, label):
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
        state.rng, agent.n_steps, chunk=agent.cfg.rollout_chunk))
    state = state._replace(env_carry=carry)
    _, gae_ms = timed(lambda: agent._advantages(state.vf_state, traj))
    (state, pack), policy_ms = timed(lambda: agent._policy_phase(state, traj))
    _, vf_ms = timed(lambda: agent._vf_stats_phase(state.vf_state, pack))
    print(f"[{tag}] stage ms{' (' + label + ' update)' if label else ''}: "
          f"rollout={roll_ms:.1f} gae={gae_ms:.2f} "
          f"policy_phase(gae+update)={policy_ms:.1f} "
          f"update≈{policy_ms - gae_ms:.1f} vf_fit+stats={vf_ms:.1f}",
          flush=True)
    return {"rollout": roll_ms, "gae": gae_ms, "update": policy_ms - gae_ms,
            "vf_fit": vf_ms}


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
        fvp16 = phase_fvp_bf16(torch, np, peaks, dev)
    torch.cuda.synchronize()
    main_counts, bf16_counts = {}, {}
    if not kernels_only:
        main_counts, stages = phase_main_path(torch, dev)
        bf16_counts = phase_bf16(torch, dev)
        phase_fleet(torch, dev, stages)
        phase_cartpole(torch, dev)
        phase_small_reference(torch, dev)

    kernels = [
        {"name": "fused_gauss_newton_fvp", "route": "cuda",
         "source": "trpo_torch/csrc/fused_fvp.cu",
         "replaces": "trpo_tpu/ops/fused_fvp.py:298",
         "launches": main_counts.get("fused_fvp", 0), **fvp},
        {"name": "fused_gauss_newton_fvp_bf16", "route": "cuda",
         "source": "trpo_torch/csrc/fused_fvp_bf16.cu",
         "replaces": "trpo_tpu/ops/fused_fvp.py:298",
         "launches": bf16_counts.get("fused_fvp_bf16", 0), **fvp16},
        {"name": "reverse_affine_scan", "route": "cuda",
         "source": "trpo_torch/csrc/reverse_scan.cu",
         "replaces": "trpo_tpu/ops/pallas_scan.py:75",
         "launches": main_counts.get("reverse_scan", 0), **scan},
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
