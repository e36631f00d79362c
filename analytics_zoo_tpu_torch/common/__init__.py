"""Process-wide settings of the port (counterpart of
analytics_zoo_tpu/common/)."""

from analytics_zoo_tpu_torch.common.context import OrcaContext  # noqa: F401
