from analytics_zoo_tpu_torch.learn.estimator import (  # noqa: F401
    Estimator, TorchEstimator,
)
