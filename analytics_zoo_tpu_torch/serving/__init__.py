"""Serving layer of the port (counterpart of analytics_zoo_tpu/serving/):
the HTTP front end with its dynamic batcher (server.py), its client
(client.py), the wire codec (codec.py), the config and start script
(config.py, start.py), `InferenceModel`, the error taxonomy and the
generation engine (generation/)."""

from analytics_zoo_tpu_torch.serving.client import (  # noqa: F401
    InputQueue,
    OutputQueue,
)
from analytics_zoo_tpu_torch.serving.config import (  # noqa: F401
    ServingConfig,
    start_serving,
    stop_serving,
)
from analytics_zoo_tpu_torch.serving.errors import (  # noqa: F401
    ERROR_HTTP_STATUS,
    ModelNotFound,
    QueueFull,
    ReplicaDiedMidPredict,
    ReplicaStopped,
    RequestTooLarge,
    TenantQuotaExceeded,
    UncommittedCheckpointError,
    http_status_for,
)
from analytics_zoo_tpu_torch.serving.inference_model import (  # noqa: F401
    InferenceModel,
)
from analytics_zoo_tpu_torch.serving.server import ServingServer  # noqa: F401

__all__ = ["ERROR_HTTP_STATUS", "InferenceModel", "ServingServer",
           "InputQueue", "OutputQueue", "http_status_for", "ServingConfig",
           "start_serving", "stop_serving", "QueueFull", "RequestTooLarge",
           "ReplicaStopped", "ReplicaDiedMidPredict", "TenantQuotaExceeded",
           "UncommittedCheckpointError", "ModelNotFound"]
