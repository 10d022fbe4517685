"""Image models: ``ImageClassifier`` (object detection is ROADMAP A11)."""

from analytics_zoo_tpu_torch.models.image.imageclassification import (
    ImageClassifier,
)

__all__ = ["ImageClassifier"]
