"""The text classifier of the port (counterpart of
analytics_zoo_tpu/models/textclassification/)."""

from analytics_zoo_tpu_torch.models.textclassification.text_classifier import (  # noqa: F401,E501
    TextClassifier,
)
