"""Resilience (counterpart of analytics_zoo_tpu/resilience/, the part
the training path uses, copied): the retry policy, seeded fault
injection and the background checkpoint writer."""

from analytics_zoo_tpu_torch.resilience.checkpointing import (  # noqa: F401
    BackgroundCheckpointer,
    CheckpointWriteError,
    drain_background,
    get_background_checkpointer,
)
from analytics_zoo_tpu_torch.resilience.faults import (  # noqa: F401
    Fault,
    FaultInjected,
    FaultPlan,
    SimulatedCrash,
    SimulatedWorkerFailure,
    fault_point,
)
from analytics_zoo_tpu_torch.resilience.retry import RetryPolicy  # noqa: F401
