"""Serving layer of the port (counterpart of analytics_zoo_tpu/serving/):
the HTTP front end with its dynamic batcher (server.py), the gRPC front
end (grpc_frontend.py), their clients (client.py), the wire codec
(codec.py), the config and start script (config.py, start.py),
`InferenceModel`, the worker pool (worker_pool.py), the error taxonomy,
the generation engine (generation/), the replica router (distributed/),
the durable streams (streaming/) and the control plane (control_plane/).
The last four load when one of their names is first read."""

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
from analytics_zoo_tpu_torch.serving.grpc_frontend import (  # noqa: F401
    GrpcInputQueue,
    GrpcServingFrontend,
)
from analytics_zoo_tpu_torch.serving.inference_model import (  # noqa: F401
    InferenceModel,
)
from analytics_zoo_tpu_torch.serving.server import ServingServer  # noqa: F401
from analytics_zoo_tpu_torch.serving.worker_pool import (  # noqa: F401
    WorkerPool,
)

_LAZY = {
    "distributed": ("ReplicaRouter", "RouterStream"),
    "streaming": ("DurableStream", "StreamHub", "StreamLog",
                  "StreamRecord", "StreamBacklogFull", "StreamConsumer",
                  "predict_consumer", "generation_consumer",
                  "poisson_trace", "bursty_trace", "run_open_loop"),
    "control_plane": ("AdmissionCore", "TokenBucket", "TenantLedger",
                      "get_tenant_ledger", "reset_tenant_ledger",
                      "REQUEST_CLASSES", "CLASS_PRIORITY",
                      "ModelRegistry", "ModelVersion", "MODEL_STATES",
                      "WeightedAB", "ShadowSampler", "run_shadow"),
}


def __getattr__(name):
    import importlib
    for sub, names in _LAZY.items():
        if name in names:
            mod = importlib.import_module(
                f"analytics_zoo_tpu_torch.serving.{sub}")
            return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ERROR_HTTP_STATUS", "InferenceModel", "ServingServer",
           "InputQueue", "OutputQueue", "GrpcInputQueue",
           "GrpcServingFrontend", "WorkerPool", "http_status_for",
           "ServingConfig", "start_serving", "stop_serving", "QueueFull",
           "RequestTooLarge", "ReplicaStopped", "ReplicaDiedMidPredict",
           "TenantQuotaExceeded", "UncommittedCheckpointError",
           "ModelNotFound", *[n for names in _LAZY.values() for n in names]]
