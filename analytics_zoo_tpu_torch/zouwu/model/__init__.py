from analytics_zoo_tpu_torch.zouwu.model.forecast import (  # noqa: F401
    Forecaster, LSTMForecaster, Seq2SeqForecaster, TCNForecaster,
)
