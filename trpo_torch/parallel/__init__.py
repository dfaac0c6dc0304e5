"""Data, sequence and parameter parallelism on ``torch.distributed``
(counterpart: ``trpo_tpu/parallel/``).

One process per rank; a named mesh (``mesh.py``) gives each axis its
process group, and every batch reduction is an explicit collective
(``ops/allreduce.py``).

- ``mesh.py``    — mesh construction and process-group initialization
- ``sharded.py`` — the sharded update and the three sharded FVPs (K1 or
  K1-bf16 per rank in :func:`make_sharded_fused_fvp`)
- ``seq.py``     — sequence (time-axis) parallelism: block-parallel
  returns and GAE on K2 per rank
- ``tp.py``      — parameter sharding over a ``"model"`` (Megatron
  column/row) or ``"expert"`` axis, the differentiable collectives of
  the sharded forward, and the inner product of the tree update's solve
"""

from trpo_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    initialize_distributed,
    make_mesh,
)
from trpo_torch.parallel.sharded import (  # noqa: F401
    gather_leading_axis,
    make_sharded_fused_fvp,
    make_sharded_fvp,
    make_sharded_ggn_fvp,
    make_sharded_update,
    pad_batch,
    shard_batch,
    shard_leading_axis,
)
from trpo_torch.parallel.seq import (  # noqa: F401
    make_seq_gae,
    seq_sharded_gae,
    seq_sharded_returns,
    sharded_reverse_affine_scan,
)
from trpo_torch.parallel.tp import (  # noqa: F401
    gather_policy_params,
    policy_param_shardings,
    shard_policy_params,
)
