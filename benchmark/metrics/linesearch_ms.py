"""The line search's device time an update: the summed device time of
the stretch's ``trpo/linesearch`` spans (CUDA events around the
``backtracking_linesearch`` call, ``benchmark/spans.py``) over its
updates."""

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    if s is None or "trpo/linesearch" not in s.device_ms:
        return None
    return sum(s.device_ms["trpo/linesearch"]) / s.updates
