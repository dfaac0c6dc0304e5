"""The held experts' share of their roofline: for each
``policy/moe/experts`` span of the traced stretch (CUDA events around an
expert layer's routed experts, ``benchmark/spans.py``), the least time the
call could take on the card over its device time; the median of those
shares. The least time is the larger of the operations of the tokens the
call routed to each held expert (the program's tally of its counts,
``flops/<family>.expert_ops``), counted once, at the dense TF32 peak, and
the weights of the experts that took a token and each routed token's row
in and out (``expert_bytes``), at the memory bandwidth; twice that in a
tangent forward. ``fvp.roofline``'s yardstick, for one layer."""

import statistics

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    from trpo_torch.ops import _build

    tallies = getattr(_build, "TALLIES", {}).get("policy/moe/experts", [])
    times = [] if s is None else s.device_ms.get("policy/moe/experts", [])
    if ctx.peak is None or not times or len(tallies) != len(times):
        return None
    shares = []
    for (counts, passes), ms in zip(tallies, times):
        if ms <= 0:
            return None
        bound = passes * max(
            ctx.flops.expert_ops(ctx.config, sum(counts))
            / ctx.peak["tf32_flops"],
            ctx.flops.expert_bytes(ctx.config, counts)
            / ctx.peak["hbm_bytes_per_s"])
        shares.append(bound / (ms * 1e-3))
    return 100.0 * statistics.median(shares)
