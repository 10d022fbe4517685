from analytics_zoo_tpu_torch.nnframes.nn_classifier import (
    NNClassifier, NNClassifierModel, NNEstimator, NNImageReader, NNModel,
)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]
