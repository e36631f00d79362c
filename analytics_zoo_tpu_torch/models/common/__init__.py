"""The model-zoo base of the port (counterpart of
analytics_zoo_tpu/models/common/)."""

from analytics_zoo_tpu_torch.models.common.zoo_model import (  # noqa: F401
    ZooModel,
)
