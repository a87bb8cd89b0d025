"""Training over several devices: the ``space`` axis on ``torch.distributed``."""

from desmo_tpu_torch.parallel.sharding import (  # noqa: F401
    SpaceMesh,
    gather_state,
    local_rows,
    local_state,
    make_mesh,
    row_range,
    shard_batch,
)
