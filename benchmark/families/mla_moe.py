"""A DeepSeek-V3 decoder over one rank's share of an expert-parallel layer
(``trpo_torch.models.mla_moe``) as a policy over responses: what the
program is handed for a configuration of this family. A row is one
sequence and one action is the response's tokens (``obs (B, 2, T)``:
tokens, then the scored positions; ``actions (B, T)``).

Weights are ``N(0, initializer_range²)`` with RMSNorm gains 1, drawn on the
device; the router's correction bias is 0 (the configuration's
``assumed``). Each sequence is a prompt of ``prompt_len`` tokens and a
response of a log-uniform length in ``response_len``, its tokens drawn
Zipf(``zipf_s``) over the vocabulary slice (id ``i`` of rank ``i + 1``),
right-padded to ``seq_len`` with the slice's last id, the least likely
one. The action at a scored position is the text's own next token: the
response is the sequence the context holds (there is no decode path to
sample it from the policy)."""

from __future__ import annotations

import math

import torch

from benchmark import tree
from benchmark.spec import load_module

# the rollback batch's behaviour policy: the drawn logits plus this much
# N(0, 1) noise a position, a KL of about STALE²/2 nats a scored token
STALE = 0.7


def _shapes(config) -> dict:
    H, nh = config["hidden_size"], config["num_attention_heads"]
    nope, rope = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    vd, r = config["v_head_dim"], config["kv_lora_rank"]
    V, E = config["vocab_size"], config["n_routed_experts"]
    f = config["moe_intermediate_size"]
    out = {"embed": (V, H), "norm": (H,), "head": (H, V)}

    def swiglu(prefix, width, *lead):
        out[prefix + "w_gate"] = (*lead, H, width)
        out[prefix + "w_up"] = (*lead, H, width)
        out[prefix + "w_down"] = (*lead, width, H)

    for i in range(config["num_hidden_layers"]):
        p = f"layers.{i}."
        out.update({p + "attn_norm": (H,), p + "mlp_norm": (H,),
                    p + "attn.wq": (H, nh * (nope + rope)),
                    p + "attn.wkv_a": (H, r + rope),
                    p + "attn.kv_norm": (r,),
                    p + "attn.wkv_b": (r, nh * (nope + vd)),
                    p + "attn.wo": (nh * vd, H)})
        if i < config["first_k_dense_replace"]:
            swiglu(p + "mlp.", config["intermediate_size"])
        else:
            out[p + "moe.router"] = (H, config["deployment"]
                                     ["router_experts"])
            swiglu(p + "moe.experts.", f, E)
            swiglu(p + "moe.shared.", config["n_shared_experts"] * f)
    return out


def draw_params(config, gen: torch.Generator, device) -> dict:
    """Named leaves in sorted order: norms' gains 1, every other leaf
    ``N(0, initializer_range²)``."""
    std = float(config["initializer_range"])
    named = {}
    for name, shape in sorted(_shapes(config).items()):
        if name.endswith("norm"):
            named[name] = torch.ones(shape, device=device)
        else:
            named[name] = torch.randn(shape, generator=gen,
                                      device=device) * std
    return named


def _text(config, gen, device, rows: int):
    """``(obs, actions)``: Zipf text right-padded with the slice's last
    id, the scored positions, and each position's next token."""
    T, P = config["seq_len"], config["prompt_len"]
    lo, hi = config["response_len"]
    V = config["vocab_size"]
    ranks = torch.arange(1, V + 1, device=device, dtype=torch.float64)
    zipf = ranks ** -float(config["zipf_s"])
    tokens = torch.multinomial((zipf / zipf.sum()).float(), rows * T,
                               replacement=True, generator=gen).view(rows, T)
    u = torch.rand(rows, generator=gen, device=device, dtype=torch.float64)
    lengths = torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    lengths = lengths.round().long().clamp(lo, min(hi, T - P))
    pos = torch.arange(T, device=device)
    # position t is scored when the token it predicts, t + 1, is a response
    # token
    scored = (pos[None] >= P - 1) & (pos[None] < P - 1 + lengths[:, None])
    tokens = torch.where(pos[None] < P + lengths[:, None], tokens, V - 1)
    actions = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    return torch.stack([tokens, scored.long()], dim=1), actions


def _plain_logits(config, params: dict, obs: torch.Tensor):
    """The drawn policy's logits (the plain forward, f32, TF32 off)."""
    ref = load_module("reference", "mla_moe")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return ref.forward(config, params, obs)["logits"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def draw_batch(config, gen: torch.Generator, device, rows: int,
               params: dict):
    """``(obs, actions)``: the text, and its next token at each position
    (read only where scored). ``params`` is not read."""
    return _text(config, gen, device, rows)


def stress_batch(kind: str, config, gen: torch.Generator, device,
                 rows: int, params: dict):
    """``(obs, actions, old)`` of a planted batch, or None.

    ``"rollback"``: the text's next tokens scored against a stale
    behaviour policy, the drawn logits plus ``STALE`` N(0, 1) noise a
    position: a mean token KL of about ``STALE²/2``, twelve times the
    rollback's limit (``kl_rollback_factor · max_kl``) whatever the
    step. ``"backtrack"``: None: as for a one-token categorical, no batch
    tried made the search backtrack on this head."""
    if kind != "rollback":
        return None
    obs, actions = _text(config, gen, device, rows)
    logits = _plain_logits(config, params, obs)
    logits = logits + STALE * torch.randn(logits.shape, generator=gen,
                                          device=device)
    return obs, actions, {"logits": logits, "mask": obs[:, 1].float()}


def architecture(config):
    """``config.MLAMoEArch`` from the configuration's keys."""
    from trpo_torch.config import MLAMoEArch

    dep = config["deployment"]
    return MLAMoEArch(
        hidden_size=config["hidden_size"],
        num_hidden_layers=config["num_hidden_layers"],
        first_k_dense_replace=config["first_k_dense_replace"],
        num_attention_heads=config["num_attention_heads"],
        qk_nope_head_dim=config["qk_nope_head_dim"],
        qk_rope_head_dim=config["qk_rope_head_dim"],
        v_head_dim=config["v_head_dim"],
        kv_lora_rank=config["kv_lora_rank"],
        intermediate_size=config["intermediate_size"],
        moe_intermediate_size=config["moe_intermediate_size"],
        router_experts=dep["router_experts"],
        num_experts_per_tok=config["num_experts_per_tok"],
        n_shared_experts=config["n_shared_experts"],
        routed_scaling_factor=config["routed_scaling_factor"],
        norm_topk_prob=config["norm_topk_prob"],
        held_experts=tuple(dep["held_experts"]),
        vocab_size=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        rms_norm_eps=config["rms_norm_eps"],
        kv_norm_eps=config["kv_lora_norm_eps"])


def program_policy(config):
    from trpo_torch.models import make_mla_moe_policy

    return make_mla_moe_policy(architecture(config))


def prepare_program(config) -> None:
    """Nothing: f32 matrix products are the default (TF32 off)."""


def to_program(named: dict):
    return tree.nest(named)


def from_program(params) -> dict:
    return tree.flatten(params)
