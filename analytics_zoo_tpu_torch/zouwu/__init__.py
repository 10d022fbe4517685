"""Zouwu: time-series analysis (ref ``pyzoo/zoo/zouwu/``; counterpart of
``analytics_zoo_tpu/zouwu/``): the forecasters (TCN, LSTM, Seq2Seq,
MTNet, TCMF, ARIMA, Prophet; ``model/``), the feature transform
(``feature/``), the recipes (``config/``), anomaly detection, and AutoTS
(``autots/``, ``pipeline.py``, ``regression.py``)."""
