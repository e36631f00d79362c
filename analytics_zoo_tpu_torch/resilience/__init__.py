"""Resilience (counterpart of analytics_zoo_tpu/resilience/, copied):
the retry policy, seeded fault injection, the background checkpoint
writer and the elastic restart driver."""

from analytics_zoo_tpu_torch.resilience.checkpointing import (  # noqa: F401
    BackgroundCheckpointer,
    CheckpointWriteError,
    drain_background,
    get_background_checkpointer,
)
from analytics_zoo_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticRestartExceeded,
    ElasticTrainingDriver,
    WorkerCancelled,
    WorkerContext,
    touch_heartbeat,
)
from analytics_zoo_tpu_torch.resilience.faults import (  # noqa: F401
    Fault,
    FaultInjected,
    FaultPlan,
    PoisonedRequestError,
    SimulatedCrash,
    SimulatedWorkerFailure,
    fault_point,
)
from analytics_zoo_tpu_torch.resilience.retry import RetryPolicy  # noqa: F401
