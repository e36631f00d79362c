"""AutoML (counterpart of analytics_zoo_tpu/orca/automl/): the
search-space DSL `hp`, the `SearchEngine` and `AutoEstimator`."""

from analytics_zoo_tpu_torch.orca.automl.auto_estimator import (  # noqa: F401
    AutoEstimator,
)
from analytics_zoo_tpu_torch.orca.automl import hp  # noqa: F401
