from analytics_zoo_tpu_torch.zouwu.feature.time_sequence import (  # noqa: F401
    TimeSequenceFeatureTransformer,
)
