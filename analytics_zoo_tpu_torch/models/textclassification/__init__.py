from analytics_zoo_tpu_torch.models.textclassification.text_classifier import (
    TextClassifier,
)

__all__ = ["TextClassifier"]
