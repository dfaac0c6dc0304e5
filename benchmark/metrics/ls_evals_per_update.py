"""Line-search evaluations an update: the stretch's
``trpo/linesearch/trial`` spans (``benchmark/spans.py``) over its
updates. Every trial runs, the ones after the acceptance included;
``ls_trials_per_update`` counts only those up to the acceptance."""

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    if s is None:
        return None
    return s.counts.get("trpo/linesearch/trial", 0) / s.updates
