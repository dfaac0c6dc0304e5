"""How unevenly the router loads the held experts: for each expert-layer
call of the traced stretch, the tokens of the busiest held expert over
the mean of the held experts' tokens (the program's tally of the counts it
reads once a call, ``policy/moe/experts``); the mean over the calls. 1 is
an even load; the call's time follows the busiest expert."""

from benchmark import spans


def read(ctx):
    if spans.stretch() is None:
        return None
    from trpo_torch.ops import _build

    ratios = [max(counts) * len(counts) / sum(counts)
              for counts, _passes in
              getattr(_build, "TALLIES", {}).get("policy/moe/experts", [])
              if sum(counts)]
    return sum(ratios) / len(ratios) if ratios else None
