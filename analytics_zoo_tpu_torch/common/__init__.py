"""Process-wide settings and the runtime entry points of the port
(counterpart of analytics_zoo_tpu/common/)."""

from analytics_zoo_tpu_torch.common.context import (  # noqa: F401
    OrcaContext,
    init_nncontext,
    init_orca_context,
    stop_orca_context,
)
