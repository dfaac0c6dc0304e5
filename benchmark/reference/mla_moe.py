"""Plain PyTorch forward of a DeepSeek-V3 decoder over one rank's share of
an expert-parallel layer, in f32: latent attention with decoupled RoPE, a
leading dense SwiGLU, sigmoid-routed experts with a correction bias and
shared experts, over a slice of the vocabulary. Written from the
DeepSeek-V3 modeling code that Moonlight-16B-A3B's ``config.json`` names;
the keys read are that file's (``hidden_size``, ``kv_lora_rank``, …), with
``n_routed_experts`` the experts held here and ``deployment`` naming them
and the router's published width.

``obs`` is ``(B, 2, T)``: token ids, then the 0/1 flag of the scored
positions. Parameters are named leaves in ``(in, out)`` layout
(``layers.<i>.attn.wq``; the held experts stacked, ``layers.<i>.moe.
experts.w_gate`` of shape ``(E, H, f)``). Attention materialises its
scores one sequence at a time; routing picks the top ``k`` of
``sigmoid(x Wr) + bias`` over every routed expert, and each held expert is
run in a loop on the tokens that chose it, adding in turn. What the
experts not held would add is left out, as the rank computes it. The auxiliary
sequence-balance loss is a pre-training loss and is left out. Imports
nothing of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """DeepSeek-V3's rotary embedding of ``x (B, T, h, d)`` at positions
    ``0 … T-1``: pairs de-interleaved into halves, then rotated by half."""
    B, T, h, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = torch.outer(torch.arange(T, device=x.device).float(), inv)
    cos = torch.cat([ang, ang], -1).cos()[:, None]
    sin = torch.cat([ang, ang], -1).sin()[:, None]
    x = x.reshape(B, T, h, d // 2, 2).transpose(-1, -2).reshape(B, T, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + rot * sin


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _attention(config, p, x):
    """``x (B, T, H)``: the projections over the batch, the scores one
    sequence at a time."""
    B, T, _ = x.shape
    nh = config["num_attention_heads"]
    nope, rope = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    vd, r = config["v_head_dim"], config["kv_lora_rank"]
    q = (x @ p["wq"]).view(B, T, nh, nope + rope)
    kv_a = x @ p["wkv_a"]
    c, k_pe = kv_a[..., :r], kv_a[..., r:]
    kv = (_rms(c, p["kv_norm"], config["kv_lora_norm_eps"])
          @ p["wkv_b"]).view(B, T, nh, nope + vd)
    theta = float(config["rope_theta"])
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], theta)], -1)
    k_pe = _rope(k_pe.view(B, T, 1, rope), theta).expand(B, T, nh, rope)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    out = []
    for b in range(B):
        scores = torch.einsum("qhd,khd->hqk", q[b], k[b]) / math.sqrt(
            nope + rope)
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
        out.append(torch.einsum("hqk,khd->qhd", probs, v[b]))
    return torch.stack(out).reshape(B, T, nh * vd) @ p["wo"]


def route(config, router_w, bias, x):
    """``(experts, weights)``, each ``(N, k)``."""
    scores = torch.sigmoid(x @ router_w)
    experts = torch.topk(scores + bias, config["num_experts_per_tok"],
                         dim=-1).indices
    w = scores.gather(-1, experts)
    if config["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return experts, w * config["routed_scaling_factor"]


def expert_layer(config, p, x, bias, held):
    """The held experts' part and the shared experts of ``x (N, H)``."""
    experts, w = route(config, p["router"], bias, x)
    out = torch.zeros_like(x)
    for j, e in enumerate(held):
        hit = experts == e                                  # (N, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if len(rows) == 0:
            continue
        we = (w * hit).sum(-1)[rows]
        y = _swiglu(x[rows], p["experts.w_gate"][j], p["experts.w_up"][j],
                    p["experts.w_down"][j])
        out = out.index_add(0, rows, y * we[:, None])
    return out + _swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                         p["shared.w_down"])


def _sub(p, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def forward(config, p: dict, obs: torch.Tensor) -> dict:
    tokens, scored = obs[:, 0], obs[:, 1]
    B, T = tokens.shape
    eps = config["rms_norm_eps"]
    held = config["deployment"]["held_experts"]
    n_router = config["deployment"]["router_experts"]
    h = p["embed"][tokens]
    for i in range(config["num_hidden_layers"]):
        lp = _sub(p, f"layers.{i}.")
        h = h + _attention(config, _sub(lp, "attn."),
                           _rms(h, lp["attn_norm"], eps))
        x = _rms(h, lp["mlp_norm"], eps).reshape(B * T, -1)
        if i < config["first_k_dense_replace"]:
            y = _swiglu(x, lp["mlp.w_gate"], lp["mlp.w_up"], lp["mlp.w_down"])
        else:
            bias = torch.zeros(n_router, device=x.device)
            y = expert_layer(config, _sub(lp, "moe."), x, bias, held)
        h = h + y.view(B, T, -1)
    return {"logits": _rms(h, p["norm"], eps) @ p["head"],
            "mask": scored.float()}


def _mean(x, mask):
    return (x * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)


def logp(d: dict, actions: torch.Tensor) -> torch.Tensor:
    """The mean of the scored positions' log-probabilities, per sequence
    (the length-normalised sequence log-ratio is its difference)."""
    lp = torch.log_softmax(d["logits"], dim=-1)
    return _mean(lp.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1),
                 d["mask"])


def kl(old: dict, new: dict) -> torch.Tensor:
    """KL(old ‖ new), the mean over the scored positions, per sequence."""
    lo = torch.log_softmax(old["logits"], dim=-1)
    ln = torch.log_softmax(new["logits"], dim=-1)
    return _mean((lo.exp() * (lo - ln)).sum(-1), old["mask"])
