"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload humanoid-sim.update --seed 7 \\
        --seconds 20 --trace 0

Needs a CUDA card (it exits 2 without one, or with fewer cards than the
cell asks for). Set-up draws the weights and a pool of batches from the
seed, builds the program's update, and runs the mix's check updates (a
segment's first updates, then the planted ones) and warm-up updates; the
window then chains updates in the mix's segments for ``--seconds`` and
ends in a synchronize. ``--trace 1`` runs the same window, then traces a
stretch of further updates (the mix's ``trace_seconds``) with ``torch.profiler`` and
reports the per-layer metrics instead of the end-to-end ones. Every run
then checks the program's check updates against the plain reference
(``check.py``), prints each compared number beside its limit as the last
lines of standard error, and prints one JSON line last on standard
output.

The measured program is ``trpo_torch``. The harness refuses to print a
result if ``jax``, ``jaxlib``, ``flax`` or ``trpo_tpu`` was imported.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "trpo_tpu")
# every cache a run may fill lives at a fixed path inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton"}
TRACE_FILE = ROOT / "build" / "benchmark_trace" / "trace.json"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def _peak_for(kind: str):
    from benchmark.spec import HERE, load_json

    for name, peak in load_json(HERE / "peaks.json").items():
        if name == kind or ("H100" in kind and "H100" in name):
            return peak
    return None


def _traced_stretch(wl, dev, seconds: float) -> tuple:
    """Whole updates under ``torch.profiler`` for ``seconds``, inside the
    ``MARKER`` annotation that opens and closes on a synchronized device;
    ``(records, TraceSummary, launches)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import MARKER, TraceSummary
    from trpo_torch.ops import _build

    on_card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    kept = []
    if on_card:
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(MARKER):
            _build.reset_launches()
            t0 = time.perf_counter()
            while not kept or time.perf_counter() - t0 < seconds:
                kept.append(wl.keep(*wl.step()))
            if on_card:
                torch.cuda.synchronize(dev)
            launches = dict(_build.LAUNCHES)
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    del prof
    summary = TraceSummary(TRACE_FILE)
    TRACE_FILE.unlink()
    return wl.records(kept), summary, launches


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault=None, config=None,
             phases: dict = None) -> dict:
    """One run of a cell; returns the result dict. ``device="cpu"``,
    ``fault`` and ``config`` are test levers (``tests/``): the command
    line always runs on the card, as the cell states."""
    import torch

    from benchmark import check
    from benchmark.spec import Cell, metric_reader

    phases = {} if phases is None else phases
    cell = Cell(cell_name)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    t = time.monotonic()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phases["cuda_init"] = time.monotonic() - t

    t = time.monotonic()
    if on_card:
        from trpo_torch.ops import _build

        _build.build()
    phases["library"] = time.monotonic() - t

    t = time.monotonic()
    wl = cell.unit.Workload(cell, seed, dev, fault=fault, config=config)
    wl.build_program()
    if on_card:
        torch.cuda.synchronize(dev)
    phases["inputs"] = time.monotonic() - t

    t = time.monotonic()
    failed = 0
    prog = wl.check_program()
    for _ in range(int(wl.mix["warmup_updates"])):
        wl.step()
    if on_card:
        torch.cuda.synchronize(dev)
    phases["warmup"] = time.monotonic() - t
    _log("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()))

    window = []
    t_start = time.perf_counter()
    setup_s = time.monotonic() - T0
    while True:
        try:
            window.append(wl.keep(*wl.step()))
        except Exception:  # counted against attempted; the window goes on
            failed += 1
            _log(f"update {wl.n_updates} raised:\n{traceback.format_exc()}")
            wl.n_updates += 1
        if time.perf_counter() - t_start >= seconds:
            break
    if on_card:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_start
    attempted = len(window) + failed
    memory_peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0)
    records = wl.records(window)
    del window

    ctx = SimpleNamespace(
        config=wl.config, mix=wl.mix, flops=cell.flops, rows=wl.rows,
        fvp_rows=wl.fvp_rows, subsample_rows=wl.sub_rows,
        records=records, n_updates=len(records), window_s=window_s,
        memory_peak_bytes=memory_peak, setup_s=setup_s, trace=None,
        trace_launches={},
        peak=_peak_for(torch.cuda.get_device_name(dev)) if on_card else None)

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card
                   else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        trace_records, ctx.trace, ctx.trace_launches = _traced_stretch(
            wl, dev, float(wl.mix["trace_seconds"]))
        failed += sum(r["nan_guard"] for r in trace_records)
        attempted += len(trace_records)
        device_info.update(busy_s=ctx.trace.busy_s,
                           window_s=ctx.trace.window_s)
        breakdown = {"device_ops": ctx.trace.top_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    failed += sum(r["nan_guard"] for r in records)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"]).read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    wl.drop_program()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = check.reference_readings(cell, wl)
    nums = check.numbers(prog, ref, wl.params0)
    correct, check_out = check.verdict(nums, cell.limits)
    if on_card:
        device_info["power_limit_w"] = _power_limit_w()
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check_out
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)

    phases = {}
    t = time.monotonic()
    import torch

    import trpo_torch.trpo  # noqa: F401  (the program, imported in set-up)
    from benchmark.spec import Cell

    phases["import"] = time.monotonic() - t
    chips = Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"refused: the cell needs {chips} CUDA card(s); "
             f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), phases=phases)
    found = forbidden_modules()
    if found:
        _log(f"refused: the run imported {found}")
        return 3
    for name, c in result["check"].items():
        _log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
