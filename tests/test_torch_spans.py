"""The update's spans and counters (``utils/timers.span``,
``utils/timers.host_read``, ``ops/_build``'s counters and span buffer).

On the CPU: a profiled flagship-shaped update at small sizes carries the
reference's named stages and their children in its Chrome trace, nested
and counted as the update ran them; with no profiler nothing is recorded;
the profiler changes no output bit; ``reset_launches`` clears every
counter; the buffer's cap drops records and counts them. The ``gpu``
tests check the host-read count of a CUDA solve, that a CUDA line
search syncs once a trial it evaluates and nowhere else, and that
device-timed spans resolve; on the card: ``python -m pytest
tests/test_torch_spans.py -q -m gpu --noconftest``. This file imports
nothing of JAX.
"""

import json
import warnings

import pytest
import torch
from torch.profiler import profile

from trpo_torch.config import get_preset
from trpo_torch.models.policy import BoxSpec, make_policy
from trpo_torch.ops import _build
from trpo_torch.ops.cg import conjugate_gradient
from trpo_torch.ops.flat import tree_leaves, tree_map
from trpo_torch.ops.linesearch import backtracking_linesearch
from trpo_torch.ops.precond import init_gaussian_head_precond
from trpo_torch.trpo import TRPOBatch, init_ladder, make_trpo_update
from trpo_torch.utils.timers import host_read, span

ROWS = 256

# each stage's innermost enclosing trpo/* span (None: none encloses it);
# trpo/fvp is checked apart: in a CG iteration, or the step scale's alone
PARENT = {
    "trpo/grad_and_surrogate": None,
    "trpo/precond_refresh": None,
    "trpo/cg_solve": None,
    "trpo/cg_solve/iteration": "trpo/cg_solve",
    "trpo/linesearch": None,
    "trpo/linesearch/trial": "trpo/linesearch",
    "trpo/kl_rollback_and_stats": None,
}


def _setup(device, pinned=False):
    """The flagship's preset (head block, ¾ subsample) at small widths,
    one batch, the update and its preconditioner and ladder state."""
    cfg = get_preset("humanoid-sim").replace(policy_hidden=(32, 32))
    policy = make_policy((11,), BoxSpec(3), hidden=(32, 32))
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda t: t.to(device), policy.init(gen))
    obs = torch.randn(ROWS, 11, generator=gen).to(device)
    with torch.no_grad():
        dp = policy.apply(params, obs)
    actions = dp["mean"] + torch.randn(ROWS, 3, generator=gen).to(device)
    adv = torch.randn(ROWS, generator=gen).to(device)
    adv = (adv - adv.mean()) / adv.std()
    batch = TRPOBatch(obs, actions, adv, dp, torch.ones(ROWS, device=device))
    ladder = None
    if pinned:
        lad = init_ladder(cfg, torch.device(device))
        ladder = lad._replace(pinned=torch.ones_like(lad.pinned),
                              pinned_host=True)
    return (cfg, make_trpo_update(policy, cfg), params, batch,
            init_gaussian_head_precond(params), ladder)


def _trace_spans(prof, tmp_path):
    """``(name, parent)`` of every ``trpo/*`` range of the profiler's
    Chrome trace, the parent being the innermost ``trpo/*`` range that
    encloses it on its thread."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
               e.get("tid")) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("trpo/")]
    out = []
    for s, t, name, tid in ranges:
        around = [(t2 - s2, n2) for s2, t2, n2, tid2 in ranges
                  if tid2 == tid and (s2, t2, n2) != (s, t, name)
                  and s2 <= s and t <= t2]
        out.append((name, min(around)[1] if around else None))
    return out


@pytest.mark.parametrize("pinned", [False, True], ids=["cheap", "pinned"])
def test_profiled_update_carries_the_stages_nested(tmp_path, pinned):
    """The cheap solve (the fused operator's plain version here) and the
    pinned ladder's full-batch GGN solve: every stage once, a CG iteration
    span per iteration that ran, one product per iteration plus the step
    scale's, every line-search trial evaluated (up to the accepted one)."""
    cfg, update, params, batch, precond, ladder = _setup("cpu", pinned)
    _build.reset_launches()
    with profile() as prof:
        _, stats = update(params, batch, None, precond, ladder)
    spans = _trace_spans(prof, tmp_path)
    iters = int(stats.cg_iterations)
    assert iters >= 1
    expected = {n: 1 for n in PARENT}
    expected["trpo/cg_solve/iteration"] = iters
    expected["trpo/linesearch/trial"] = int(stats.linesearch_trials)
    assert {n: sum(1 for name, _ in spans if name == n)
            for n in PARENT} == expected
    for name, parent in spans:
        if name == "trpo/fvp":
            assert parent in ("trpo/cg_solve/iteration", None)
        else:
            assert parent == PARENT[name], (name, parent)
    fvp_parents = [p for n, p in spans if n == "trpo/fvp"]
    assert fvp_parents.count("trpo/cg_solve/iteration") == iters
    assert fvp_parents.count(None) == 1   # sᵀFs, the step scale
    # the program's own counts agree; a CPU run reads nothing on a device
    assert _build.SPAN_COUNTS["trpo/cg_solve/iteration"] == iters
    assert _build.SPAN_COUNTS["trpo/fvp"] == iters + 1
    assert (_build.SPAN_COUNTS["trpo/linesearch/trial"]
            == int(stats.linesearch_trials))
    assert not _build.HOST_READS
    assert not _build.SPANS.records   # no CUDA device: nothing to time


def test_no_profiler_records_nothing():
    _, update, params, batch, precond, _ = _setup("cpu")
    _build.reset_launches()
    update(params, batch, None, precond)
    assert not _build.SPAN_COUNTS and not _build.HOST_READS
    assert not _build.SPANS.records and _build.SPANS.dropped == 0
    # the off path hands out one shared empty context
    assert span("a") is span("b", torch.device("cpu"))


def test_profiler_changes_no_output_bit():
    _, update, params, batch, precond, _ = _setup("cpu")
    plain = update(params, batch, None, precond)
    with profile():
        traced = update(params, batch, None, precond)
    leaves_a, leaves_b = tree_leaves(plain), tree_leaves(traced)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all())
        else:
            assert a == b or (a != a and b != b)


def test_reset_launches_clears_every_counter():
    _build.LAUNCHES["fused_fvp"] += 2
    _build.SPAN_COUNTS["trpo/fvp"] += 3
    _build.HOST_READS["cg.exit"] += 4
    _build.SPANS.add(_build.SpanRecord("trpo/fvp", None, None, None))
    _build.SPANS.dropped = 5
    _build.reset_launches()
    assert not (_build.LAUNCHES or _build.SPAN_COUNTS or _build.HOST_READS)
    assert not _build.SPANS.records and _build.SPANS.dropped == 0


def test_span_buffer_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(_build, "SPAN_CAP", 2)
    _build.reset_launches()
    for i in range(5):
        _build.SPANS.add(_build.SpanRecord(f"s{i}", None, None, None))
    assert [r.name for r in _build.SPANS.records] == ["s0", "s1"]
    assert _build.SPANS.dropped == 3
    _build.reset_launches()


def test_host_read_counts_only_a_cuda_value_under_a_profiler():
    _build.reset_launches()
    t = torch.tensor(True)
    assert host_read(t, "cg.exit") is True
    with profile():
        assert host_read(torch.tensor(3), "cg.budget") == 3
    assert not _build.HOST_READS   # a CPU read waits on nothing


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (device events and CUDA reads)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_solve_counts_its_exit_reads_and_times_its_span(card):
    n = 64
    gen = torch.Generator(device=card).manual_seed(1)
    a = torch.randn(n, n, device=card, generator=gen)
    A = a @ a.T + n * torch.eye(n, device=card)
    b = torch.randn(n, device=card, generator=gen)
    _build.reset_launches()
    with profile():
        with span("trpo/cg_solve", card):
            cg = conjugate_gradient(lambda v: A @ v, b, cg_iters=10,
                                    residual_tol=1e-30)
    torch.cuda.synchronize(card)
    assert int(cg.iterations) == 10
    assert dict(_build.HOST_READS) == {"cg.exit": 10}
    assert _build.SPAN_COUNTS["trpo/cg_solve/iteration"] == 10
    (rec,) = _build.SPANS.records
    assert rec.name == "trpo/cg_solve" and rec.parent is None
    assert rec.device_ms() > 0.0


@pytest.mark.gpu
def test_cuda_update_spans_resolve(card):
    cfg, update, params, batch, precond, _ = _setup(card)
    update(params, batch, None, precond)   # build the kernels first
    _build.reset_launches()
    with profile():
        _, stats = update(params, batch, None, precond)
    torch.cuda.synchronize(card)
    iters = int(stats.cg_iterations)
    names = [r.name for r in _build.SPANS.records]
    assert names.count("trpo/fvp") == iters + 1
    for stage in ("trpo/grad_and_surrogate", "trpo/precond_refresh",
                  "trpo/cg_solve", "trpo/linesearch",
                  "trpo/kl_rollback_and_stats"):
        assert names.count(stage) == 1, stage
    for rec in _build.SPANS.records:
        assert rec.device_ms() >= 0.0
        if rec.name == "trpo/fvp":
            assert rec.parent in ("trpo/cg_solve/iteration", None)
        else:
            assert rec.parent is None
    assert _build.HOST_READS["cg.exit"] == min(iters + 1, cfg.cg_iters)
    assert _build.HOST_READS["ls.accept"] == int(stats.linesearch_trials)


@pytest.mark.gpu
@pytest.mark.parametrize("scale,trials", [(0.5, 1), (4.0, 3), (-1.0, 10)],
                         ids=["first", "planted", "none"])
def test_cuda_linesearch_syncs_once_a_trial(card, scale, trials):
    """On the card the search waits on the device once a trial it
    evaluates, at its ``ls.accept`` read, and nowhere else: the loss
    |x - c|² from 0 along ``scale``·c passes the first trial, the third
    (4c overshoots to a quarter) or none (-c climbs)."""
    gen = torch.Generator(device=card).manual_seed(2)
    c = torch.randn(64, device=card, generator=gen)
    x, step = torch.zeros(64, device=card), scale * c
    rate = 2.0 * torch.dot(c, step)

    def loss(v):
        return torch.sum((v - c) ** 2), {"x": v}

    def cap(v, aux):
        return torch.sum(aux["x"] ** 2) <= 1e6

    f0, aux0 = loss(x)

    def search():
        return backtracking_linesearch(loss, x, step, rate,
                                       constraint_fn=cap, has_aux=True,
                                       f0=f0, aux0=aux0)

    search()   # the first launches of each kernel
    torch.cuda.synchronize(card)
    _build.reset_launches()
    with profile():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = search()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert int(res.trials) == trials
    assert bool(res.success) == (trials < 10)
    assert len(syncs) == trials
    assert dict(_build.HOST_READS) == {"ls.accept": trials}
    assert _build.SPAN_COUNTS["trpo/linesearch/trial"] == trials
