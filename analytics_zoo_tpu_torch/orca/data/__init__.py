"""Sharded host data (counterpart of analytics_zoo_tpu/orca/data/):
`XShards` and the pandas file readers.  Importing it imports no pandas;
only the operations on DataFrame shards and the readers do."""

from analytics_zoo_tpu_torch.orca.data.shard import XShards  # noqa: F401
from analytics_zoo_tpu_torch.orca.data import pandas  # noqa: F401
