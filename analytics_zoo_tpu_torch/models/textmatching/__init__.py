"""KNRM of the port (counterpart of analytics_zoo_tpu/models/textmatching/)."""

from analytics_zoo_tpu_torch.models.textmatching.knrm import KNRM  # noqa: F401
