"""The anomaly detector of the port (counterpart of
analytics_zoo_tpu/models/anomalydetection/)."""

from analytics_zoo_tpu_torch.models.anomalydetection.anomaly_detector import (  # noqa: F401,E501
    AnomalyDetector,
    detect_anomalies,
)
