from analytics_zoo_tpu_torch.models.recommendation.recommender import (  # noqa: F401
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from analytics_zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF  # noqa: F401
from analytics_zoo_tpu_torch.models.recommendation.wide_and_deep import (  # noqa: F401
    ColumnFeatureInfo,
    WideAndDeep,
)
from analytics_zoo_tpu_torch.models.recommendation.session_recommender import (  # noqa: F401
    SessionRecommender,
)
