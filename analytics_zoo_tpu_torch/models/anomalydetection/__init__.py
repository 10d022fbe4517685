from analytics_zoo_tpu_torch.models.anomalydetection.anomaly_detector import (
    AnomalyDetector,
)

__all__ = ["AnomalyDetector"]
