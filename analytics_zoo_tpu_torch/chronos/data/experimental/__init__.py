"""The XShards-backed TSDataset."""

from analytics_zoo_tpu_torch.chronos.data.experimental.xshards_tsdataset import (  # noqa: E501
    XShardsTSDataset,
)

__all__ = ["XShardsTSDataset"]
