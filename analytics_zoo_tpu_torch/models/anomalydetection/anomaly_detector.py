"""AnomalyDetector — LSTM forecaster and residual-ranked anomalies.

Counterpart of
``analytics_zoo_tpu/models/anomalydetection/anomaly_detector.py`` (ref
``pyzoo/zoo/models/anomalydetection/anomaly_detector.py``, Scala
``AnomalyDetector.scala``): stacked ``LSTM`` layers, each followed by a
``Dropout``, predict the next point of a rolled window through a
``Dense(1)``; the ``anomaly_size`` largest |y - ŷ| are the anomalies.
Same static ``unroll`` and ``detect_anomalies``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry


@registry.register
class AnomalyDetector(ZooModel):
    """(ref anomaly_detector.py AnomalyDetector(feature_shape,
    hidden_layers=[8, 32, 15], dropouts=[0.2, 0.2, 0.2]))"""

    def __init__(self, feature_shape: Tuple[int, int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2)):
        super().__init__()
        if len(hidden_layers) != len(dropouts):
            raise ValueError("hidden_layers and dropouts must align "
                             "(ref AnomalyDetector.scala require)")
        self.feature_shape = tuple(int(v) for v in feature_shape)
        self.hidden_layers = [int(u) for u in hidden_layers]
        self.dropouts = [float(d) for d in dropouts]
        self.model = self.build_model()

    def build_model(self):
        inp = Input(shape=self.feature_shape)
        h = inp
        for i, (units, drop) in enumerate(zip(self.hidden_layers,
                                              self.dropouts)):
            last = i == len(self.hidden_layers) - 1
            h = zl.LSTM(units, return_sequences=not last)(h)
            h = zl.Dropout(drop)(h)
        out = zl.Dense(1)(h)
        return Model(input=inp, output=out)

    @staticmethod
    def unroll(data: np.ndarray, unroll_length: int,
               predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Roll ``[n, F]`` into (``[n', unroll_length, F]`` windows, the
        ``[n']`` value of feature 0 ``predict_step`` after each)."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[:, None]
        n = len(data) - unroll_length - predict_step + 1
        if n <= 0:
            raise ValueError("series shorter than unroll_length+predict_step")
        idx = np.arange(unroll_length)[None, :] + np.arange(n)[:, None]
        x = data[idx]
        y = data[np.arange(n) + unroll_length + predict_step - 1, 0]
        return x, y.astype(np.float32)

    @staticmethod
    def detect_anomalies(y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_size: int) -> np.ndarray:
        """Indices of the ``anomaly_size`` largest absolute residuals."""
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        dist = np.abs(y_true - y_pred)
        return np.argsort(-dist)[:anomaly_size]

    def _config(self):
        return dict(feature_shape=list(self.feature_shape),
                    hidden_layers=self.hidden_layers,
                    dropouts=self.dropouts)
