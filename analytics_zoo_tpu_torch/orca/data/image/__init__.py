"""Image dataset writers and loaders of the port (counterpart of
analytics_zoo_tpu/orca/data/image/): parquet, TFRecord, MNIST, VOC.
Importing it imports no pandas."""

from analytics_zoo_tpu_torch.orca.data.image.parquet_dataset import (
    ParquetDataset,
    read_parquet_as_xshards,
    write_from_directory,
    write_mnist,
    write_parquet,
    write_voc,
)
from analytics_zoo_tpu_torch.orca.data.image.tfrecord_dataset import (
    TFRecordDataset,
)

__all__ = [
    "ParquetDataset", "TFRecordDataset", "write_parquet",
    "write_from_directory", "write_mnist", "write_voc",
    "read_parquet_as_xshards",
]
