"""The CG solve's device time an iteration: the summed device time of
the stretch's ``trpo/cg_solve`` spans (CUDA events around each
``conjugate_gradient`` call, ``benchmark/spans.py``) over the
``trpo/cg_solve/iteration`` spans that ran (one a loop body)."""

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    iters = 0 if s is None else s.counts.get("trpo/cg_solve/iteration", 0)
    if iters == 0 or "trpo/cg_solve" not in s.device_ms:
        return None
    return sum(s.device_ms["trpo/cg_solve"]) / iters
