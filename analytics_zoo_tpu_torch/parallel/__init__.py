"""Parallel axes (counterpart of analytics_zoo_tpu/parallel/): the
sharding helpers over process groups and ring attention over the "sp"
axis.  `SwitchMoE` and the pipeline functions come with ROADMAP Queue 1
item 8b."""

from analytics_zoo_tpu_torch.parallel.sharding import (  # noqa: F401
    data_axes,
    data_parallelism,
    infer_param_shardings,
    logical_to_sharding,
    mesh_axis_size,
    shard_batch,
)
from analytics_zoo_tpu_torch.parallel.ring_attention import (  # noqa: F401
    RING_FLASH_MIN_TLOCAL,
    ring_attention,
    ring_self_attention,
)
