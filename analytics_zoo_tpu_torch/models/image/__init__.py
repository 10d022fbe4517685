"""Image models: ``ImageClassifier`` and object detection
(``ObjectDetector``, ``SSDLite``, ``SSD300VGG``)."""

from analytics_zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier,
)
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    ObjectDetector, SSD300VGG, SSDLite,
)

__all__ = ["ImageClassifier", "ObjectDetector", "SSDLite", "SSD300VGG"]
