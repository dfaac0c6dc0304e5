"""Policy models (counterpart: ``trpo_tpu/models``)."""

from trpo_torch.models.mla_moe import make_mla_moe_policy  # noqa: F401
from trpo_torch.models.mlp import apply_mlp, init_mlp  # noqa: F401
from trpo_torch.models.policy import (  # noqa: F401
    BoxSpec,
    DiscreteSpec,
    Policy,
    make_policy,
)
