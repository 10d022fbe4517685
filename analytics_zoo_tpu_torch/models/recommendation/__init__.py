from analytics_zoo_tpu_torch.models.recommendation.recommender import (  # noqa: F401
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from analytics_zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF  # noqa: F401
