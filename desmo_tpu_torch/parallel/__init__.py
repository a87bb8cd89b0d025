"""Training over several devices: the ``space`` axis on ``torch.distributed``."""

from desmo_tpu_torch.parallel.sharding import (  # noqa: F401
    SpaceMesh,
    local_rows,
    make_mesh,
    row_range,
    shard_batch,
)
