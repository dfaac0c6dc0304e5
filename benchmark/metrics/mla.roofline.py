"""Latent attention's share of its roofline, whatever computes it: for
each ``policy/mla`` span of the traced stretch (CUDA
events at each layer's attention call, ``benchmark/spans.py``), the least
time the call could take on the card over its device time; the median of
those shares. The least time is the larger of the call's operations,
counted once (``flops/<family>.mla_ops`` at the positions it ran on), at
the dense TF32 peak, and its weights, input and output, each once
(``mla_bytes``), at the memory bandwidth; a tangent forward counts its
tangent's products and bytes, twice a forward's (the program's tally of
each call). ``fvp.roofline``'s yardstick, for one layer."""

import statistics

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    from trpo_torch.ops import _build

    tallies = getattr(_build, "TALLIES", {}).get("policy/mla", [])
    times = [] if s is None else s.device_ms.get("policy/mla", [])
    if ctx.peak is None or not times or len(tallies) != len(times):
        return None
    shares = []
    for (positions, passes), ms in zip(tallies, times):
        if ms <= 0:
            return None
        bound = passes * max(
            ctx.flops.mla_ops(ctx.config, positions) / ctx.peak["tf32_flops"],
            ctx.flops.mla_bytes(ctx.config, positions)
            / ctx.peak["hbm_bytes_per_s"])
        shares.append(bound / (ms * 1e-3))
    return 100.0 * statistics.median(shares)
