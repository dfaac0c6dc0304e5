"""Solver and kernel ops (counterpart: ``trpo_tpu/ops``)."""

from trpo_torch.ops.cg import CGResult, conjugate_gradient  # noqa: F401
from trpo_torch.ops.flat import flatten_params  # noqa: F401
from trpo_torch.ops.fvp import make_ggn_fvp  # noqa: F401
from trpo_torch.ops.linesearch import backtracking_linesearch  # noqa: F401
