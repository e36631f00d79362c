"""keras2 namespace of the port (counterpart of analytics_zoo_tpu/keras2):
the keras-2 signatures (`units`, `filters`, `kernel_size`, `strides`,
`padding`, `rate`) over the port's keras-1 classes, whose graph engine
and training path they share: a keras2 model is a keras model."""

from analytics_zoo_tpu_torch.keras.engine import Input  # noqa: F401
from analytics_zoo_tpu_torch.keras.models import (  # noqa: F401
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras2 import layers  # noqa: F401
