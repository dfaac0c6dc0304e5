"""Data and sequence parallelism on ``torch.distributed`` (counterpart:
``trpo_tpu/parallel/``).

One process per rank; a named mesh (``mesh.py``) gives each axis its
process group, and every batch reduction is an explicit collective
(``ops/allreduce.py``).

- ``mesh.py``    — mesh construction and process-group initialization
- ``sharded.py`` — the sharded update and the three sharded FVPs (K1 or
  K1-bf16 per rank in :func:`make_sharded_fused_fvp`)
- ``seq.py``     — sequence (time-axis) parallelism: block-parallel
  returns and GAE on K2 per rank

The reference's ``tp.py`` (parameter sharding over a ``"model"`` or
``"expert"`` axis) is not ported yet (ROADMAP.md Queue 1 item 16.2).
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
