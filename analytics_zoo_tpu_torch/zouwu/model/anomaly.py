"""Anomaly detectors (ref ``pyzoo/zoo/zouwu/model/anomaly/anomaly.py``,
171 LoC: ThresholdDetector, AEDetector, DBScanDetector).

Counterpart of ``analytics_zoo_tpu/zouwu/model/anomaly.py``:
``ThresholdDetector`` is JAX's numpy; ``AEDetector``'s autoencoder is an
``nn.Module`` (``Dense_<i>`` as flax names them) trained through
``Estimator.from_torch`` on ``device`` (``cuda`` unless the caller passes
``device="cpu"``; without CUDA that raises); ``DBScanDetector`` needs
scikit-learn, as JAX's does, and names it where it is absent."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.device import (RNG_LOCK, DeviceLike,
                                                   resolve_device)


class ThresholdDetector:
    """Flag |y - y_hat| (or raw y) outside a threshold. ``fit`` derives the
    threshold as mean + ratio·std of the residuals (ref anomaly.py
    ThresholdDetector: absolute threshold or (mode, ratio) estimation)."""

    def __init__(self, mode: str = "default", ratio: float = 3.0,
                 threshold: Optional[float] = None):
        if mode not in ("default", "percentile"):
            raise ValueError(f"mode must be 'default' (mean + ratio·std) or "
                             f"'percentile' (ratio = percentile), got {mode!r}")
        self.mode = mode
        self.ratio = ratio
        self.threshold = threshold

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None):
        res = np.abs(y - y_pred) if y_pred is not None else np.abs(y)
        if self.mode == "percentile":
            self.threshold = float(np.percentile(res, self.ratio))
        else:
            self.threshold = float(res.mean() + self.ratio * res.std())
        return self

    def score(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
              ) -> np.ndarray:
        return np.abs(y - y_pred) if y_pred is not None else np.abs(y)

    def anomaly_indexes(self, y: np.ndarray,
                        y_pred: Optional[np.ndarray] = None) -> np.ndarray:
        if self.threshold is None:
            raise RuntimeError("fit first or pass threshold explicitly")
        return np.nonzero(self.score(y, y_pred) > self.threshold)[0]


class _AE(nn.Module):
    """JAX's ``_AE``: Denses of ``hidden`` with ReLU, back through
    ``hidden[:-1]`` reversed, then a ``Dense`` to ``roll_len`` (flax's
    lecun-normal kernels and zero biases)."""

    def __init__(self, roll_len: int, hidden: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from analytics_zoo_tpu_torch.common.flax_compat import Dense
        from analytics_zoo_tpu_torch.zouwu.model.nets import lecun_normal_
        widths = [roll_len, *hidden, *reversed(hidden[:-1]), roll_len]
        self.n = len(widths) - 1
        for i in range(self.n):
            lin = Dense(widths[i], widths[i + 1])
            lecun_normal_(lin.weight, widths[i], generator)
            with torch.no_grad():
                lin.bias.zero_()
            self.add_module(f"Dense_{i}", lin)

    def forward(self, x, train: bool = False):
        h = x
        for i in range(self.n - 1):
            h = torch.relu(self._modules[f"Dense_{i}"](h))
        return self._modules[f"Dense_{self.n - 1}"](h)


class AEDetector:
    """Autoencoder reconstruction-error detector (ref anomaly.py AEDetector).

    Windows the series, trains a small MLP autoencoder through the zoo
    Estimator, and flags the top ``anomaly_ratio`` fraction of windows by
    reconstruction error."""

    def __init__(self, roll_len: int = 24, hidden: Tuple[int, ...] = (16, 8),
                 anomaly_ratio: float = 0.05, epochs: int = 5,
                 batch_size: int = 32, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.roll_len = roll_len
        self.hidden = tuple(hidden)
        self.anomaly_ratio = anomaly_ratio
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self._est = None
        self._mu = self._sigma = None

    def _windows(self, y: np.ndarray) -> np.ndarray:
        n = len(y) - self.roll_len + 1
        if n <= 0:
            raise ValueError(f"series shorter than roll_len={self.roll_len}")
        idx = np.arange(self.roll_len)[None, :] + np.arange(n)[:, None]
        return y[idx].astype(np.float32)

    def build(self) -> nn.Module:
        """The autoencoder with its initial weights (from ``seed``)."""
        gen = torch.Generator().manual_seed(int(self.seed))
        with RNG_LOCK:
            return _AE(self.roll_len, self.hidden, gen)

    def fit(self, y: np.ndarray, model: Optional[nn.Module] = None):
        """``model``: an autoencoder to start from (default ``build()``;
        a test passes JAX's initial weights)."""
        from analytics_zoo_tpu_torch.learn.estimator import Estimator

        y = np.asarray(y, np.float32).ravel()
        self._mu, self._sigma = float(y.mean()), float(y.std() or 1.0)
        w = (self._windows(y) - self._mu) / self._sigma
        self._est = Estimator.from_torch(
            model=self.build() if model is None else model,
            loss=lambda yt, yp: ((yt - yp) ** 2).mean(),
            seed=self.seed, device=self.device)
        self._est.fit((w, w), epochs=self.epochs,
                      batch_size=min(self.batch_size, len(w)))
        return self

    def score(self, y: np.ndarray) -> np.ndarray:
        """Per-timestep anomaly score = mean reconstruction error of the
        windows covering that step."""
        y = np.asarray(y, np.float32).ravel()
        w = (self._windows(y) - self._mu) / self._sigma
        rec = np.asarray(self._est.predict(w, batch_size=256))
        err = ((rec - w) ** 2).mean(1)                    # per window
        # spread window scores back over timesteps
        score = np.zeros(len(y))
        count = np.zeros(len(y))
        for i, e in enumerate(err):
            score[i:i + self.roll_len] += e
            count[i:i + self.roll_len] += 1
        return score / np.maximum(count, 1)

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        s = self.score(y)
        k = max(1, int(len(s) * self.anomaly_ratio))
        return np.sort(np.argsort(s)[-k:])


class DBScanDetector:
    """Density-based outlier detection (ref anomaly.py DBScanDetector;
    sklearn DBSCAN labels -1 = anomaly)."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5):
        self.eps, self.min_samples = eps, min_samples

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        try:
            from sklearn.cluster import DBSCAN
        except ModuleNotFoundError as e:
            raise ModuleNotFoundError(
                "DBScanDetector needs scikit-learn (sklearn), which is not "
                "installed", name="sklearn") from e
        y = np.asarray(y, np.float32).reshape(len(y), -1)
        labels = DBSCAN(eps=self.eps,
                        min_samples=self.min_samples).fit_predict(y)
        return np.nonzero(labels == -1)[0]
