"""Keras-style model-building API of the port (counterpart of
analytics_zoo_tpu/keras): a symbolic graph of layers that runs as one
torch module and trains through `Estimator.from_keras`."""

from analytics_zoo_tpu_torch.keras.engine import Input, Layer  # noqa: F401
from analytics_zoo_tpu_torch.keras.models import (  # noqa: F401
    Model,
    Sequential,
)
from analytics_zoo_tpu_torch.keras import layers  # noqa: F401
from analytics_zoo_tpu_torch.orca.learn import losses as objectives  # noqa: F401,E501
from analytics_zoo_tpu_torch.orca.learn import metrics  # noqa: F401
from analytics_zoo_tpu_torch.orca.learn import optimizers  # noqa: F401
