"""AutoARIMA and AutoProphet, the classical legs' searches."""

from analytics_zoo_tpu_torch.chronos.autots.model.auto_arima import AutoARIMA
from analytics_zoo_tpu_torch.chronos.autots.model.auto_prophet import (
    AutoProphet,
)

__all__ = ["AutoARIMA", "AutoProphet"]
