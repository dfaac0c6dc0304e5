"""The host's reads of a CUDA value an update, each a wait on the
device: the program's host-read counts over every site (CG's exit mask
``cg.exit``, its budget ``cg.budget``, the ladder's ``ladder.pinned``;
``benchmark/spans.py``) over the stretch's updates."""

from benchmark import spans


def read(ctx):
    s = spans.stretch()
    if s is None:
        return None
    return sum(s.host_reads.values()) / s.updates
