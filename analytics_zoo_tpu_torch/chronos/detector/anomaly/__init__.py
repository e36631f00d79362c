"""The anomaly detectors: threshold, autoencoder and DBSCAN."""

from analytics_zoo_tpu_torch.chronos.detector.anomaly.detectors import (  # noqa: F401,E501
    AEDetector,
    DBScanDetector,
    ThresholdDetector,
)
