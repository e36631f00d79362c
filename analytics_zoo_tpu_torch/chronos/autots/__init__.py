from analytics_zoo_tpu_torch.chronos.autots.autotsestimator import (  # noqa: F401
    AutoTSEstimator,
)
from analytics_zoo_tpu_torch.chronos.autots.tspipeline import TSPipeline  # noqa: F401,E501
