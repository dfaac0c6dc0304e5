"""The port's DeepSeek-V3 policy family (``models/mla_moe.py``) and the
sequence distribution, against the benchmark's plain reference
(``benchmark/reference/mla_moe.py``) on the CPU at a tiny size: the
logits, the expert shares' identity, the router's rule, the RoPE layout,
causality, the scored positions, the GGN against the double-backward
Hessian, and one whole update against ``benchmark/reference/trpo.py``.

The ``gpu`` tests compare the same at the published widths on one
sequence; on the card: ``python -m pytest tests/test_torch_mla_moe.py -q
-m gpu --noconftest``. This file imports nothing of JAX.
"""

import math

import pytest
import torch

from benchmark import check
from benchmark.spec import Cell, load_module
from trpo_torch.distributions import SequenceCategorical
from trpo_torch.models import make_mla_moe_policy
from trpo_torch.models.mla_moe import (
    apply_rope,
    held_part,
    rope_tables,
    route,
    sort_slots,
)
from trpo_torch.ops.flat import flatten_params
from trpo_torch.ops.fvp import make_ggn_fvp

CELL = "moonlight-ep8.update"
# hidden 64, 4 heads, nope 16 / rope 8 / v 16, kv rank 32, 8 routed experts
# top-2 with experts 0-3 held, 1 shared, vocab 97, 32 positions
TINY = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
            intermediate_size=96, moe_intermediate_size=24,
            n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
            vocab_size=97, num_hidden_layers=3, seq_len=32, prompt_len=8,
            response_len=[4, 20])


def _config(held=(0, 1, 2, 3), **kw):
    base = Cell(CELL).config
    cfg = dict(base, **TINY, **kw)
    cfg["n_routed_experts"] = len(held)
    cfg["deployment"] = dict(base["deployment"], router_experts=8,
                             held_experts=list(held))
    return cfg


def _model(cfg, seed=0, rows=3):
    fam = load_module("families", "mla_moe")
    gen = torch.Generator().manual_seed(seed)
    named = fam.draw_params(cfg, gen, "cpu")
    obs, actions = fam.draw_batch(cfg, gen, "cpu", rows, named)
    return fam, named, obs, actions


def test_logits_match_the_reference():
    cfg = _config()
    fam, named, obs, _ = _model(cfg)
    ref = load_module("reference", "mla_moe")
    got = fam.program_policy(cfg).apply(fam.to_program(named), obs)
    want = ref.forward(cfg, named, obs)
    # f32 on both sides, matmuls in another grouping: 1e-5 of the scale
    scale = want["logits"].abs().max()
    assert torch.allclose(got["logits"], want["logits"], rtol=0,
                          atol=1e-5 * scale)
    assert torch.equal(got["mask"], want["mask"])
    assert 0 < got["mask"].sum() < got["mask"].numel()


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two ranks' shares of an 8-expert layer (experts 0-3 and 4-7), each
    computing its held experts' part for the tokens routed to them, plus
    the shared expert once, give the reference layer holding all 8."""
    ref = load_module("reference", "mla_moe")
    whole = _config(held=tuple(range(8)))
    gen = torch.Generator().manual_seed(3)
    fam = load_module("families", "mla_moe")
    named = fam.draw_params(whole, gen, "cpu")
    p = {k[len("layers.1.moe."):]: v for k, v in named.items()
         if k.startswith("layers.1.moe.")}
    x = torch.randn(40, whole["hidden_size"], generator=gen)
    bias = 0.05 * torch.randn(8, generator=gen)
    want = ref.expert_layer(whole, p, x, bias, list(range(8)))
    chosen, w = route(p["router"], bias, x, 2, whole["routed_scaling_factor"],
                      True)
    total = ref.expert_layer(
        whole, {k: (torch.zeros_like(v) if k.startswith("experts.") else v)
                for k, v in p.items()}, x, bias, list(range(8)))  # shared
    for held in ((0, 1, 2, 3), (4, 5, 6, 7)):
        local = torch.full((8,), len(held), dtype=torch.long)
        local[list(held)] = torch.arange(len(held))
        order, counts = sort_slots(local, chosen, len(held))
        experts = {n: p[f"experts.{n}"][list(held)]
                   for n in ("w_gate", "w_up", "w_down")}
        total = total + held_part(experts, x, order, counts, w, 2)
    assert torch.allclose(total, want, rtol=1e-5, atol=1e-6)


def test_router_chooses_by_biased_score_and_weights_by_unbiased():
    x = torch.eye(4)[:2]                         # token 0, token 1
    router_w = torch.tensor([[2.0, 1.0, 0.0, -1.0],
                             [0.0, 1.0, 2.0, 3.0],
                             [0.0] * 4, [0.0] * 4])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.5])    # lifts expert 3 only
    experts, w = route(router_w, bias, x, 2, 2.446, True)
    s = torch.sigmoid(x @ router_w)
    # token 0: scores 0.88, 0.73, 0.5, 0.27 (+0.5 → 0.77): 0 then 3
    assert experts[0].tolist() == [0, 3]
    assert experts[1].tolist() == [3, 2]
    for row, chosen in enumerate(experts.tolist()):
        un = s[row, chosen]
        assert torch.allclose(w[row], un / un.sum() * 2.446)


def test_correction_bias_is_a_buffer_that_steers_routing():
    """``e_score_correction_bias`` moves the choice and not the weights'
    scores, and the policy keeps it out of the parameter vector."""
    x = torch.randn(16, 4, generator=torch.Generator().manual_seed(3))
    router_w = torch.randn(4, 8, generator=torch.Generator().manual_seed(4))
    zero = torch.zeros(8)
    lifted = torch.tensor([0.0, 0.0, 9.0, 9.0, 0.0, 0.0, 0.0, 0.0])
    plain, _ = route(router_w, zero, x, 2, 2.446, True)
    steered, w = route(router_w, lifted, x, 2, 2.446, True)
    assert not torch.equal(plain, steered)
    assert (steered.sort(-1).values == torch.tensor([2, 3])).all()
    s = torch.sigmoid(x @ router_w).gather(-1, steered)
    assert torch.allclose(w, s / s.sum(-1, keepdim=True) * 2.446)
    cfg = _config()
    fam, named, obs, _ = _model(cfg)
    params = fam.to_program(named)
    assert flatten_params(params)[0].numel() == sum(
        t.numel() for t in named.values())
    assert fam.program_policy(cfg).apply(params, obs)["logits"].isfinite(
    ).all()


def test_rope_follows_the_deepseek_v3_layout():
    d, T, theta = 8, 5, 50000.0
    x = torch.randn(1, T, 2, d)
    cos, sin = rope_tables(T, d, theta, "cpu")
    got = apply_rope(x, cos, sin)
    half = d // 2
    for t in range(T):
        for i in range(half):
            ang = t * theta ** (-2 * i / d)
            # the pair (2i, 2i+1) lands at (i, i + d/2), then rotates
            a, b = x[0, t, :, 2 * i], x[0, t, :, 2 * i + 1]
            assert torch.allclose(got[0, t, :, i],
                                  a * math.cos(ang) - b * math.sin(ang),
                                  atol=1e-6)
            assert torch.allclose(got[0, t, :, i + half],
                                  b * math.cos(ang) + a * math.sin(ang),
                                  atol=1e-6)


def test_causal_and_scored_positions():
    cfg = _config()
    fam, named, obs, actions = _model(cfg)
    policy = fam.program_policy(cfg)
    params = fam.to_program(named)
    d = policy.apply(params, obs)
    later = obs.clone()
    later[:, 0, 20:] = (later[:, 0, 20:] + 1) % cfg["vocab_size"]
    d2 = policy.apply(params, later)
    assert torch.equal(d["logits"][:, :20], d2["logits"][:, :20])
    assert not torch.allclose(d["logits"][:, 20:], d2["logits"][:, 20:])
    # logits and actions at unscored positions (prompt, padding) change
    # neither logp nor kl
    mask = d["mask"].bool()
    noisy = {"logits": torch.where(mask[..., None], d["logits"],
                                   d["logits"] + 3.0 * torch.randn_like(
                                       d["logits"])), "mask": d["mask"]}
    other = torch.where(mask, actions, (actions + 1) % cfg["vocab_size"])
    dist = SequenceCategorical
    assert torch.equal(dist.logp(d, actions), dist.logp(noisy, other))
    pert = {"logits": d["logits"] + 0.1 * torch.randn_like(d["logits"]),
            "mask": d["mask"]}
    pert_noisy = {"logits": torch.where(mask[..., None], pert["logits"],
                                        noisy["logits"]), "mask": d["mask"]}
    assert torch.allclose(dist.kl(d, pert), dist.kl(noisy, pert_noisy))
    assert (dist.kl(d, pert) > 0).all()


def test_ggn_product_equals_the_double_backward_hessian():
    cfg = _config()
    fam, named, obs, _ = _model(cfg, rows=2)
    policy = fam.program_policy(cfg)
    flat, unravel = flatten_params(fam.to_program(named))
    with torch.no_grad():
        d0 = policy.apply(unravel(flat), obs)
    fvp = make_ggn_fvp(lambda x: policy.apply(unravel(x), obs),
                       SequenceCategorical.fisher_weight, flat,
                       torch.ones(2))
    v = torch.randn(flat.shape, generator=torch.Generator().manual_seed(1))
    xg = flat.clone().requires_grad_(True)
    kl = SequenceCategorical.kl(d0, policy.apply(unravel(xg), obs)).mean()
    (g,) = torch.autograd.grad(kl, xg, create_graph=True)
    (hv,) = torch.autograd.grad(g @ v, xg)
    got = fvp(v)
    assert torch.allclose(got, hv, rtol=1e-4, atol=1e-4 * hv.abs().max())


def test_one_update_matches_the_reference_trpo():
    """The cell's own update call (``mixes/update.py``) at the tiny size
    against ``reference/trpo.py``: the check's numbers, the step taken."""
    cell = Cell(CELL)
    cfg = _config(n_envs=4)
    wl = cell.unit.Workload(cell, 4_000_000_007, torch.device("cpu"),
                            config=cfg)
    wl.build_program()
    prog = wl.check_program()
    wl.drop_program()
    ref = check.reference_readings(cell, wl)
    fed = int(wl.mix["check_updates"])
    # the window-fed updates move within the trust region; the planted
    # stale batch rolls back
    assert ref["rolled_back"] == [False] * fed + [True], ref["kl"]
    assert all(s < 0 for s in ref["surrogate_after"][:fed])
    limit = cfg["trpo"]["kl_rollback_factor"] * cfg["trpo"]["max_kl"]
    assert all(0 < k <= limit for k in ref["kl"][:fed])
    nums = check.numbers(prog, ref, wl.params0)
    assert nums["search"] == 0, (prog["step_fraction"], ref["step_fraction"])
    # f32 on both sides; the surrogate after a step is a difference of
    # ratios near 1, so its relative gap is the larger
    assert nums["grad"] < 1e-5
    assert nums["loss"] < 5e-2 and nums["change"] < 5e-2, nums


@pytest.mark.gpu
def test_published_widths_logits_and_ggn_on_the_card():
    """At the published widths on one sequence of 2,048 positions: the
    program's logits against the reference's, and one GGN product against
    the reference's double-backward Hessian-vector product of the mean
    sequence KL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the published widths)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(CELL)
    cfg = cell.config
    fam = cell.family
    ref = cell.reference
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    named = fam.draw_params(cfg, gen, dev)
    obs, _ = fam.draw_batch(cfg, gen, dev, 1, named)
    policy = fam.program_policy(cfg)
    flat, unravel = flatten_params(fam.to_program(named))
    with torch.no_grad():
        got = policy.apply(unravel(flat), obs)
        want = ref.forward(cfg, named, obs)
    # f32 on both sides; the fused attention and another matmul grouping
    # move the logits by f32 rounding through 5 layers: 1e-4 of the scale
    scale = want["logits"].abs().max()
    assert (got["logits"] - want["logits"]).abs().max() <= 1e-4 * scale
    fvp = make_ggn_fvp(lambda x: policy.apply(unravel(x), obs),
                       SequenceCategorical.fisher_weight, flat,
                       torch.ones(1, device=dev))
    v = torch.randn(flat.shape, generator=gen, device=dev)
    mine = fvp(v)
    del fvp
    # the reference's Hessian in its own flat order, mapped back
    from benchmark import tree

    names = sorted(named)
    x = torch.cat([named[k].reshape(-1) for k in names]).requires_grad_(True)
    split = torch.split(x, [named[k].numel() for k in names])
    kl = ref.kl(want, ref.forward(cfg, {k: t.view(named[k].shape) for k, t
                                        in zip(names, split)}, obs)).mean()
    (g,) = torch.autograd.grad(kl, x, create_graph=True)
    v_named = tree.flatten(unravel(v))
    (hv,) = torch.autograd.grad(
        g @ torch.cat([v_named[k].reshape(-1) for k in names]), x)
    hv_named = {k: t.view(named[k].shape) for k, t in
                zip(names, torch.split(hv, [named[k].numel()
                                            for k in names]))}
    want_hv = flatten_params(fam.to_program(hv_named))[0]
    # the GGN equals the Hessian at θ up to f32 rounding on both sides
    rel = (mine - want_hv).norm() / want_hv.norm()
    assert rel < 1e-3, float(rel)
