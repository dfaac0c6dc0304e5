"""Operations and bytes of the DeepSeek-V3 policy's update work over one
rank's share of an expert-parallel layer, from the configuration's shapes,
with rows = sequences of ``seq_len`` positions. Counted as 2 operations a
multiply-add, matrix products only (norms, RoPE, softmax, routing's sort
left out): per position, each layer's latent attention projections, its
dense SwiGLU or its router, shared experts and routed experts, and the
head; per sequence, causal attention at ``T(T+1)/2`` query-key pairs a
head (``qk`` wide for the scores, ``v`` wide for the sum). The routed
experts are counted at their expected load, ``k · held / router`` expert
rows a position (0.75 for 6 of 64 with 8 held); ``expert_ops`` and
``expert_bytes`` count a call's own routed tokens. Every counted product
has a weight and an input gradient (the first layer's input is the
embedding, a parameter), so the gradient is 3 forwards and a
Fisher-vector product (tangent forward, then the backward sweep) 4.
About 0.604 GFLOP a position forward at Moonlight's widths, 8 of 64
experts held, 20,480 ids and 2,048 positions."""

from __future__ import annotations


def _attn_params(c) -> int:
    H, nh = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r = c["kv_lora_rank"]
    return (H * nh * qk + H * (r + c["qk_rope_head_dim"])
            + r * nh * (c["qk_nope_head_dim"] + c["v_head_dim"])
            + nh * c["v_head_dim"] * H)


def _routed_rows(c, positions: int) -> int:
    return (positions * c["num_experts_per_tok"] * c["n_routed_experts"]
            // c["deployment"]["router_experts"])


def mla_ops(c, positions: int) -> int:
    """One attention layer over ``positions`` (whole sequences)."""
    T, nh = c["seq_len"], c["num_attention_heads"]
    width = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    pairs = positions // T * T * (T + 1) // 2
    return 2 * positions * _attn_params(c) + 2 * nh * width * pairs


def mla_bytes(c, positions: int) -> int:
    """Its f32 weights, its input and its output, each once."""
    return 4 * (_attn_params(c) + c["kv_lora_rank"]
                + 2 * positions * c["hidden_size"])


def expert_ops(c, tokens: int) -> int:
    """The held experts' SwiGLUs over ``tokens`` routed (token, expert)
    pairs."""
    return 6 * tokens * c["hidden_size"] * c["moe_intermediate_size"]


def expert_bytes(c, counts) -> int:
    """The f32 weights of each held expert that took a token, and each
    routed token's input row and output row."""
    used = sum(1 for n in counts if n)
    return 4 * (used * 3 * c["hidden_size"] * c["moe_intermediate_size"]
                + 2 * sum(counts) * c["hidden_size"])


def forward(c, rows: int) -> int:
    P = rows * c["seq_len"]
    H, V = c["hidden_size"], c["vocab_size"]
    f = c["moe_intermediate_size"]
    total = c["num_hidden_layers"] * mla_ops(c, P) + 2 * P * H * V
    for i in range(c["num_hidden_layers"]):
        if i < c["first_k_dense_replace"]:
            total += 6 * P * H * c["intermediate_size"]
        else:
            total += 2 * P * H * c["deployment"]["router_experts"]
            total += 6 * P * H * c["n_shared_experts"] * f
            total += expert_ops(c, _routed_rows(c, P))
    return total


def n_params(c) -> int:
    H, V, f = c["hidden_size"], c["vocab_size"], c["moe_intermediate_size"]
    total = 2 * V * H + H
    for i in range(c["num_hidden_layers"]):
        total += _attn_params(c) + c["kv_lora_rank"] + 2 * H
        if i < c["first_k_dense_replace"]:
            total += 3 * H * c["intermediate_size"]
        else:
            total += H * c["deployment"]["router_experts"]
            total += 3 * H * f * (c["n_routed_experts"]
                                  + c["n_shared_experts"])
    return total


def gradient(c, rows: int) -> int:
    return 3 * forward(c, rows)


def fvp(c, rows: int) -> int:
    return 4 * forward(c, rows)


def fvp_bytes(c, rows: int) -> int:
    """The int64 tokens and flags, one f32 weight a row, the f32
    parameters and ``v`` in, the product out."""
    return (8 * rows * 2 * c["seq_len"] + 4 * rows
            + 4 * 3 * n_params(c))


def operator_build(c, rows: int) -> int:
    return forward(c, rows)


def precond_refresh(c, rows: int) -> int:
    return 0
