"""Feature pipelines of the port (counterpart of
analytics_zoo_tpu/feature/): chainable Preprocessing transformers and
the ImageSet pipeline (`feature/image/`).  TextSet is not ported yet
(ROADMAP Queue 1 item 9)."""

from analytics_zoo_tpu_torch.feature.common import (
    ArrayToTensor,
    ChainedPreprocessing,
    FeatureLabelPreprocessing,
    Preprocessing,
    ScalarToTensor,
    SeqToTensor,
    TensorToSample,
)

__all__ = [
    "Preprocessing", "ChainedPreprocessing", "ScalarToTensor",
    "SeqToTensor", "ArrayToTensor", "FeatureLabelPreprocessing",
    "TensorToSample",
]
