"""The Fisher-vector product's share of its roofline, whatever computes
it (K1, K1-bf16, the ``torch.func`` GGN): the least time one product at
its shape could take on the card, over the median device time of the
stretch's ``trpo/fvp`` spans (CUDA events at the operator's call,
``benchmark/spans.py``). The least time is the larger of the product's
operations, counted once (``flops/<family>.fvp``), at the dense TF32
peak, and its input and output bytes, each once
(``flops/<family>.fvp_bytes``), at the memory bandwidth, on the rows the
solve ran on (``ctx.fvp_rows``): ``k1.roofline``'s yardstick."""

import statistics

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    if s is None or ctx.peak is None or not s.device_ms.get("trpo/fvp"):
        return None
    per_call = statistics.median(s.device_ms["trpo/fvp"]) * 1e-3
    if per_call <= 0:
        return None
    bound = max(ctx.flops.fvp(ctx.config, ctx.fvp_rows)
                / ctx.peak["tf32_flops"],
                ctx.flops.fvp_bytes(ctx.config, ctx.fvp_rows)
                / ctx.peak["hbm_bytes_per_s"])
    return 100.0 * bound / per_call
