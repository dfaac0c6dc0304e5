"""A DeepSeek-V3 decoder as a TRPO policy: latent attention (MLA) with
decoupled RoPE, a leading dense SwiGLU layer, then sparse expert layers
(sigmoid router, top-k of 64 with a correction bias, shared experts), over
one rank's slice of the vocabulary and of the routed experts. The
equations are those of the DeepSeek-V3 modeling code that Moonlight's
``config.json`` names (``model_type`` ``deepseek_v3``); the widths come
from ``config.MLAMoEArch``.

The observation is a ``(B, 2, T)`` integer tensor: the tokens, and a 0/1
flag of the positions that are scored (a position is scored when the
token it predicts is a response token; the prompt and the right padding
are not). ``apply`` returns ``{"logits": (B, T, V), "mask": (B, T)}`` for
``distributions.SequenceCategorical``: one response is one action.

* Blocks are pre-norm residuals, ``h += attn(rms(h)); h += mlp(rms(h))``,
  then a final RMSNorm and the head over the vocabulary slice (the
  embedding and the head are untied). The categorical is over the slice.
* Attention: ``q = x Wq`` (no query LoRA), ``[c, k_pe] = x Wkv_a``,
  ``[k_nope, v] = rms(c) Wkv_b``; RoPE on the 64 ``pe`` dimensions in the
  DeepSeek-V3 layout (each head's interleaved pairs de-interleaved into
  halves, then rotated by half), ``k_pe`` shared by every head; causal,
  scale ``1/sqrt(nope + rope)``. The scores are materialised a sequence
  at a time, in every pass: PyTorch's fused kernels have no forward-mode
  rule (the GGN's tangent forward), and their f32 rounding differs from
  the plain reference's in the last bits, which flips near-tied routes
  between the two. Every operation up to each router is the reference's
  own, on the same shapes, so both choose the same experts.
* Expert layers route each token over every routed expert: the top
  ``num_experts_per_tok`` of ``sigmoid(x Wr) + bias`` choose, the chosen
  experts' unbiased scores, normalised and times the scaling factor,
  weight. ``bias`` (``e_score_correction_bias``) is a buffer outside the
  parameter vector. With ``n_group = topk_group = 1`` the group stage
  keeps every expert, so it is left out. The layer computes only its held
  experts, for exactly the tokens routed to them (no capacity, no token
  dropped), after one host read of their token counts a call (site
  ``moe.counts``); a plain autograd pass (the update's gradient)
  recomputes them backward rather than keep their activations, so its
  memory does not follow the routing; what absent experts would add is
  left out and the
  partial result goes on, as one rank of an expert-parallel layer does
  without its exchange. The shared experts (one SwiGLU of
  ``n_shared · moe_intermediate_size``) run on every token.
* Departure: the auxiliary sequence-balance loss (``seq_aux``) is a
  pre-training loss and is not part of the TRPO surrogate.

Spans (``utils/timers.span``, recorded only under a profiler), one per
layer call in every forward: ``policy/mla`` and ``policy/moe/experts``
device-timed, ``policy/moe/router``, ``policy/moe/shared``,
``policy/dense_mlp`` and ``policy/lm_head``. ``policy/mla`` tallies
``(positions, passes)`` and ``policy/moe/experts`` ``(tokens per
held expert, passes)``, ``passes`` being 2 in a tangent forward (the
tangent's products) and 1 otherwise (``utils/timers.tally``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trpo_torch.config import MLAMoEArch
from trpo_torch.distributions import SequenceCategorical
from trpo_torch.models.policy import Policy
from trpo_torch.utils.timers import host_read, span, tally

__all__ = ["apply_rope", "held_part", "init_mla_moe", "make_mla_moe_policy",
           "rms_norm", "route", "sort_slots"]

INIT_STD = 0.02   # the initializer_range convention of the HF configs


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(T: int, dim: int, theta: float, device):
    """``(cos, sin)`` of shape ``(T, dim)``: ``cat(f, f)`` of the angles
    ``t · theta^(-2i/dim)``."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device).float()
                          / dim)
    f = torch.outer(torch.arange(T, device=device).float(), inv)
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding of ``x (B, T, h, d)``: the
    interleaved pairs ``(0, 1), (2, 3), …`` de-interleaved into halves,
    then ``x cos + rotate_half(x) sin``."""
    B, T, h, d = x.shape
    x = x.reshape(B, T, h, d // 2, 2).transpose(-1, -2).reshape(B, T, h, d)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rot = torch.cat([-x2, x1], dim=-1)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def _forward_mode() -> bool:
    """True inside ``torch.func.jvp`` (the innermost transform)."""
    from torch._C._functorch import TransformType, peek_interpreter_stack

    top = peek_interpreter_stack()
    return top is not None and top.key() == TransformType.Jvp


def _plain_autograd() -> bool:
    """True outside every ``torch.func`` transform."""
    from torch._C._functorch import peek_interpreter_stack

    return peek_interpreter_stack() is None


def _attend(q, k, v, qk_dim: int):
    """Causal attention of one sequence's ``(T, h, ·)`` heads, the scores
    materialised (the plain reference's operations, op for op)."""
    T = q.shape[0]
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(qk_dim)
    future = torch.ones(T, T, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def _swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def route(router_w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
          k: int, scale: float, normalize: bool):
    """``(experts, weights)`` of shape ``(N, k)``: the top ``k`` of
    ``sigmoid(x Wr) + bias`` and their unbiased scores, normalised and
    scaled. The choice carries no gradient; the weights do."""
    scores = torch.sigmoid(x @ router_w)
    experts = torch.topk(scores.detach() + bias, k, dim=-1).indices
    w = scores.gather(-1, experts)
    if normalize:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return experts, w * scale


def sort_slots(local: torch.Tensor, experts: torch.Tensor, n_held: int):
    """``(order, counts)`` for :func:`held_part`: the ``(token, slot)``
    pairs of ``experts (N, k)`` sorted by ``local``'s index of their expert
    (``n_held`` for an absent one), and each held expert's count, read to
    the host in one transfer (site ``moe.counts``)."""
    slot = local[experts].reshape(-1)
    order = torch.argsort(slot, stable=True)
    counts = host_read(torch.bincount(slot, minlength=n_held + 1)[:n_held],
                       "moe.counts")
    return order, [counts] if n_held == 1 else counts


def held_part(experts: dict, x: torch.Tensor, order: torch.Tensor,
              counts: Sequence[int], w: torch.Tensor, k: int) -> torch.Tensor:
    """What the held experts add to ``x (N, H)``: ``order`` sorts the
    ``N·k`` (token, slot) pairs by local expert (absent experts last),
    ``counts`` is each held expert's share of them, ``w (N, k)`` the
    routing weights; expert ``j``'s SwiGLU runs on its tokens only, and
    the experts add in turn (a token's sum in one order every run)."""
    out = torch.zeros_like(x)
    w = w.reshape(-1)
    start = 0
    for j, n in enumerate(counts):
        if n:
            pairs = order[start:start + n]
            tokens = pairs // k
            xj = x[tokens]
            y = (F.silu(xj @ experts["w_gate"][j])
                 * (xj @ experts["w_up"][j])) @ experts["w_down"][j]
            out = out.index_add(0, tokens, y * w[pairs][:, None])
        start += n
    return out


def init_mla_moe(generator: torch.Generator, arch: MLAMoEArch,
                 std: float = INIT_STD) -> dict:
    """Params: every matrix ``N(0, std²)`` in ``(in, out)`` layout, the held
    experts stacked on a leading axis, RMSNorm gains 1. Drawn on the CPU
    ``generator``."""
    H, nh = arch.hidden_size, arch.num_attention_heads
    qk = arch.qk_nope_head_dim + arch.qk_rope_head_dim
    E, f = len(arch.held_experts), arch.moe_intermediate_size

    def w(*shape):
        return torch.randn(*shape, generator=generator) * std

    def swiglu(width, *lead):
        return {"w_gate": w(*lead, H, width), "w_up": w(*lead, H, width),
                "w_down": w(*lead, width, H)}

    layers = []
    for i in range(arch.num_hidden_layers):
        layer = {
            "attn_norm": torch.ones(H),
            "attn": {"wq": w(H, nh * qk),
                     "wkv_a": w(H, arch.kv_lora_rank
                                + arch.qk_rope_head_dim),
                     "kv_norm": torch.ones(arch.kv_lora_rank),
                     "wkv_b": w(arch.kv_lora_rank,
                                nh * (arch.qk_nope_head_dim
                                      + arch.v_head_dim)),
                     "wo": w(nh * arch.v_head_dim, H)},
            "mlp_norm": torch.ones(H),
        }
        if i < arch.first_k_dense_replace:
            layer["mlp"] = swiglu(arch.intermediate_size)
        else:
            layer["moe"] = {"router": w(H, arch.router_experts),
                            "experts": swiglu(f, E),
                            "shared": swiglu(arch.n_shared_experts * f)}
        layers.append(layer)
    return {"embed": w(arch.vocab_size, H), "layers": layers,
            "norm": torch.ones(H), "head": w(H, arch.vocab_size)}


def make_mla_moe_policy(arch: MLAMoEArch) -> Policy:
    """The policy of ``arch`` over ``(B, 2, T)`` observations (module
    docstring). Each expert layer's ``e_score_correction_bias`` is a zero
    buffer (the checkpoint's values are not in the repository), moved to
    the observations' device, never a parameter. No fused-kernel spec and
    no castable forward: the GGN takes it in f32."""
    held = tuple(int(e) for e in arch.held_experts)
    n_held, k = len(held), arch.num_experts_per_tok
    if len(set(held)) != n_held or not all(
            0 <= e < arch.router_experts for e in held):
        raise ValueError(f"held experts {held} must be distinct ids of the "
                         f"{arch.router_experts} routed experts")
    nh, nope, rope = (arch.num_attention_heads, arch.qk_nope_head_dim,
                      arch.qk_rope_head_dim)
    vd = arch.v_head_dim
    local = torch.full((arch.router_experts,), n_held, dtype=torch.long)
    local[list(held)] = torch.arange(n_held)
    # per device: the local index of each routed expert (n_held: absent),
    # the correction bias, and the RoPE tables by length
    cache: dict = {}

    def on(device):
        if device not in cache:
            cache[device] = {"local": local.to(device),
                             "bias": torch.zeros(arch.router_experts,
                                                 device=device)}
        return cache[device]

    def attention(p, x, cos, sin):
        B, T, _ = x.shape
        q = (x @ p["wq"]).view(B, T, nh, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c, k_pe = (x @ p["wkv_a"]).split([arch.kv_lora_rank, rope], dim=-1)
        kv = (rms_norm(c, p["kv_norm"], arch.kv_norm_eps)
              @ p["wkv_b"]).view(B, T, nh, nope + vd)
        k_nope, v = kv.split([nope, vd], dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        k_pe = apply_rope(k_pe.view(B, T, 1, rope), cos, sin)
        k = torch.cat([k_nope, k_pe.expand(B, T, nh, rope)], dim=-1)
        o = torch.stack([_attend(q[b], k[b], v[b], nope + rope)
                         for b in range(B)])
        return o.reshape(B, T, nh * vd) @ p["wo"]

    def experts_layer(p, x, bias, table, tangent, dev):
        """The held experts' part and the shared experts of ``x (N, H)``."""
        with span("policy/moe/router"):
            chosen, w = route(p["router"], bias, x, k,
                              arch.routed_scaling_factor,
                              arch.norm_topk_prob)
            order, counts = sort_slots(table, chosen, n_held)
        with span("policy/moe/experts", dev):
            tally("policy/moe/experts", (counts, 2 if tangent else 1))
            if torch.is_grad_enabled() and _plain_autograd():
                # the gradient pass keeps nothing of the routed experts and
                # recomputes them backward: what it holds does not grow
                # with the tokens routed here (the same bits)
                out = checkpoint(held_part, p["experts"], x, order, counts,
                                 w, k, use_reentrant=False)
            else:
                out = held_part(p["experts"], x, order, counts, w, k)
        with span("policy/moe/shared"):
            return out + _swiglu(p["shared"], x)

    def apply(params, obs):
        tokens, scored = obs[:, 0], obs[:, 1]
        B, T = tokens.shape
        dev = tokens.device
        state = on(dev)
        if ("rope", T) not in state:
            state["rope", T] = rope_tables(T, rope, arch.rope_theta, dev)
        cos, sin = state["rope", T]
        tangent = _forward_mode()
        h = params["embed"][tokens]
        for i, layer in enumerate(params["layers"]):
            with span("policy/mla", dev):
                tally("policy/mla", (B * T, 2 if tangent else 1))
                h = h + attention(layer["attn"],
                                  rms_norm(h, layer["attn_norm"],
                                           arch.rms_norm_eps), cos, sin)
            x = rms_norm(h, layer["mlp_norm"],
                         arch.rms_norm_eps).reshape(B * T, -1)
            if "mlp" in layer:
                with span("policy/dense_mlp"):
                    y = _swiglu(layer["mlp"], x)
            else:
                y = experts_layer(layer["moe"], x, state["bias"],
                                  state["local"], tangent, dev)
            h = h + y.view(B, T, -1)
        with span("policy/lm_head"):
            logits = rms_norm(h, params["norm"],
                              arch.rms_norm_eps) @ params["head"]
        return {"logits": logits, "mask": scored.to(logits.dtype)}

    def init(generator: torch.Generator):
        return init_mla_moe(generator, arch)

    return Policy(init=init, apply=apply, dist=SequenceCategorical,
                  action_spec=None)
