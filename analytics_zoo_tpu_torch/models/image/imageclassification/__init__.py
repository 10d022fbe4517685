from analytics_zoo_tpu_torch.models.image.imageclassification.image_classifier import (  # noqa: E501
    ImageClassifier,
)

__all__ = ["ImageClassifier"]
