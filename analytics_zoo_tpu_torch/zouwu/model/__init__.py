from analytics_zoo_tpu_torch.zouwu.model.forecast import (  # noqa: F401
    Forecaster, LSTMForecaster, MTNetForecaster, Seq2SeqForecaster,
    TCNForecaster,
)
from analytics_zoo_tpu_torch.zouwu.model.stats_forecast import (  # noqa: F401
    ARIMAForecaster, ProphetForecaster,
)
