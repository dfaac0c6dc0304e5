"""Policy models (counterpart: ``trpo_tpu/models``)."""

from trpo_torch.models.mlp import apply_mlp, init_mlp  # noqa: F401
from trpo_torch.models.policy import BoxSpec, Policy, make_policy  # noqa: F401
