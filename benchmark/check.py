"""The output check: the program's first updates against the plain
reference (``reference/``), after the window, on the same weights and
batches.

Set-up runs the mix's ``check_updates`` (three) updates through the
window's own call and feed, on batches that all differ, then the mix's
planted batches through the same call (``check_stress``: one whose
actions lie far out, so that the line search backtracks, and one drawn
by a stale, narrower policy, so that the KL rolls the step back); the
window then starts its first segment from the drawn weights. After the
window, with the program's state freed, the reference repeats those
updates from the same weights, in f32 with TF32 off, and four numbers
are compared, each with its limit (``limits/<workload>.json``):

* ``loss``: the widest gap of the surrogate after an update, over the
  window-fed updates, relative to the reference's (a planted update's
  surrogate is a difference of log-densities far from the mean, which
  f32 holds to about 1e-4 of 1 on either side);
* ``search``: the updates whose accepted step fraction or rollback
  differs from the reference's, over all of them (exact);
* ``grad``: the gap of the first update's gradient norm (``TRPOStats
  .grad_norm``), relative to the reference's;
* ``change``: the parameters' change over the updates, by the worst
  leaf: ``|‖Δθ_program‖ − ‖Δθ_reference‖|`` over the larger of the
  reference's ``‖Δθ‖`` of that leaf and of the median leaf. A leaf whose
  reference gradient is under a thousandth of the median leaf's is left
  out: it moves by rounding alone.

The control (``precision="tf32"``) runs the reference with TF32 on in
the program's place; the planted faults (``half_batch=True``) run it on
half of each batch. Neither is part of a benchmark run
(``calibrate.py`` reads them).
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch

NUMBERS = ("loss", "search", "grad", "change")


def program_readings(stats_list: List, params_after: dict) -> dict:
    """What the program's check updates returned, on the host."""
    rows = torch.stack([torch.stack([
        torch.as_tensor(v, device=s.kl.device).float().reshape(())
        for v in (s.surrogate_after, s.kl, s.grad_norm, s.step_fraction,
                  s.rolled_back)]) for s in stats_list]).cpu().tolist()
    return {"surrogate_after": [r[0] for r in rows],
            "kl": [r[1] for r in rows],
            "grad_norm": [r[2] for r in rows],
            "step_fraction": [r[3] for r in rows],
            "rolled_back": [bool(r[4]) for r in rows],
            "params": params_after}


@contextlib.contextmanager
def _precision(precision: str):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = {"f32": False, "tf32": True}[precision]
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_readings(cell, workload, precision: str = "f32",
                       half_batch: bool = False) -> dict:
    """The reference's readings of the same updates."""
    from benchmark.spec import load_module

    algo = load_module("reference", "trpo")
    batches = workload.check_batches()
    with _precision(precision):
        steps = algo.run_updates(cell.reference, workload.config,
                                 workload.params0, batches, len(batches),
                                 pinned=workload.pinned,
                                 half_batch=half_batch)
    return {"surrogate_after": [s["surrogate_after"] for s in steps],
            "kl": [s["kl"] for s in steps],
            "grad_norm": [s["grad_norm"] for s in steps],
            "step_fraction": [s["step_fraction"] for s in steps],
            "rolled_back": [s["rolled_back"] for s in steps],
            "window_fed": int(workload.mix["check_updates"]),
            "grad_leaf_norms": steps[0]["grad_leaf_norms"],
            "params": steps[-1]["params"]}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def numbers(prog: dict, ref: dict, params0: dict,
            detail: bool = False) -> Dict[str, float]:
    """The four compared numbers; with ``detail``, also each update's
    loss gap, each leaf's change gap, and the reference's step fractions
    and rollbacks (for ``calibrate.py``)."""
    fed = ref["window_fed"]
    losses = [_rel(p, r) for p, r in zip(prog["surrogate_after"][:fed],
                                         ref["surrogate_after"][:fed])]
    search = sum(
        (pf, pr) != (rf, rr) for pf, pr, rf, rr in zip(
            prog["step_fraction"], prog["rolled_back"],
            ref["step_fraction"], ref["rolled_back"]))
    search += abs(len(prog["step_fraction"]) - len(ref["step_fraction"]))
    grad = _rel(prog["grad_norm"][0], ref["grad_norm"][0])
    g = ref["grad_leaf_norms"]
    g_med = statistics.median(g.values())
    leaves = [k for k in sorted(g) if g[k] >= 1e-3 * g_med]

    def change(params, k):
        return float(torch.linalg.vector_norm(
            params[k].float() - params0[k].float()))

    d_ref = {k: change(ref["params"], k) for k in leaves}
    d_med = statistics.median(d_ref.values())
    gaps = {k: abs(change(prog["params"], k) - d_ref[k])
            / max(d_ref[k], d_med, 1e-30) for k in leaves}
    out = {"loss": max(losses), "search": float(search), "grad": grad,
           "change": max(gaps.values())}
    out = {k: (v if v == v else float("inf")) for k, v in out.items()}
    if detail:
        out["loss_by_update"] = losses
        out["change_by_leaf"] = gaps
        out["ref_step_fraction"] = ref["step_fraction"]
        out["ref_rolled_back"] = ref["rolled_back"]
    return out


def verdict(nums: Dict[str, float], limits: dict) -> tuple:
    """``(correct, check)``: every number finite and within its limit."""
    check = {k: {"value": nums[k], "limit": float(limits[k])}
             for k in NUMBERS}
    correct = all(v["value"] <= v["limit"] for v in check.values())
    return correct, check
