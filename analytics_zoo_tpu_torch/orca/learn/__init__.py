"""The Estimator and what it trains with (counterpart of
analytics_zoo_tpu/orca/learn/): `Estimator.from_torch(module).fit(...)`
on one card."""

from analytics_zoo_tpu_torch.orca.learn.estimator import (  # noqa: F401
    Estimator,
    NaNLossError,
)
from analytics_zoo_tpu_torch.orca.learn.gan import GANEstimator  # noqa: F401
from analytics_zoo_tpu_torch.orca.learn.inference_estimator import (  # noqa: F401,E501
    InferenceEstimator,
)
from analytics_zoo_tpu_torch.orca.learn.trigger import (  # noqa: F401
    EveryEpoch,
    MaxIteration,
    MinLoss,
    SeveralIteration,
    Trigger,
)
