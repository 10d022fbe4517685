"""Forecaster API.

Counterpart of ``analytics_zoo_tpu/zouwu/model/forecast.py`` (ref
``pyzoo/zoo/zouwu/model/forecast/``): each forecaster wraps a net of
``nets.py`` trained through ``Estimator.from_torch``.

- ``fit(x, y, epochs, batch_size)``: ``x`` ``[n, lookback, features]``,
  ``y`` ``[n, horizon]``; or, with ``y=None``, anything the estimator
  takes: XShards of ``{"x", "y"}`` dicts (a ``DISK_n`` store streams, the
  store's bound kept) or a ``ShardedDataset``. The net is built at the
  first ``fit`` (or ``restore``) from the input's feature count, its
  weights drawn from ``seed``.
- ``predict`` / ``evaluate`` (``automl.metrics.Evaluator``'s names:
  "mse", "mae", "smape", ...), ``save`` / ``restore``: the checkpoints of
  ``learn/checkpoint.py`` with flax's names, so a forecaster saved by
  either package restores in the other.
- ``dtype``: "float32" (default) or "mixed_bfloat16" (``keras/policy.py``:
  bf16 compute with fp32 parameters; the heads and the loss stay fp32;
  the LSTMs keep flax's fp32 carry).
- ``device``: ``cuda`` unless the caller passes ``device="cpu"``, or the
  active context's first device.

``MTNetForecaster`` takes the reference's names and JAX's legacy
aliases; ``TCMFForecaster`` (``tcmf.py``) is re-exported here, as JAX
does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.device import RNG_LOCK, DeviceLike
from analytics_zoo_tpu_torch.data.dataset import ShardedDataset
from analytics_zoo_tpu_torch.data.shard import XShards
from analytics_zoo_tpu_torch.keras.policy import _POLICIES
from analytics_zoo_tpu_torch.learn.estimator import Estimator
from analytics_zoo_tpu_torch.zouwu.model.nets import (MTNetModule,
                                                      Seq2SeqNet,
                                                      TemporalConvNet,
                                                      VanillaLSTMNet)


def _feature_count(data) -> int:
    """The last dimension of the model input in ``data``."""
    if isinstance(data, XShards):
        return int(np.shape(data.first()["x"])[-1])
    if isinstance(data, ShardedDataset):
        if data.x is None:      # a streaming set: read one shard
            return int(np.shape(data._xshards.first()["x"])[-1])
        return int(np.shape(data.x)[-1])
    return int(np.shape(data)[-1])


class Forecaster:
    """Common fit/predict/evaluate surface (ref forecast.py Forecaster)."""

    def __init__(self, *, optimizer="adam", loss="mse",
                 model_dir: Optional[str] = None, seed: int = 0,
                 dtype: str = "float32", device: DeviceLike = None):
        self.optimizer = optimizer
        self.loss = loss
        self.model_dir = model_dir
        self.seed = seed
        self.device = device
        self._est = None
        if dtype not in _POLICIES:
            raise ValueError(
                f"unknown dtype {dtype!r}; one of {sorted(_POLICIES)}")
        self.dtype = dtype

    @property
    def _net_dtype(self) -> Optional[torch.dtype]:
        return _POLICIES[self.dtype]

    def _build_module(self, in_features: int,
                      generator: torch.Generator):  # pragma: no cover
        raise NotImplementedError

    def _ensure_est(self, data):
        if self._est is None:
            gen = torch.Generator().manual_seed(int(self.seed))
            # layers draw their default init from torch's global
            # generator before ``gen`` overwrites it: under RNG_LOCK, so
            # no draw lands inside another thread's seeded step
            with RNG_LOCK:
                module = self._build_module(_feature_count(data), gen)
            self._est = Estimator.from_torch(
                model=module, loss=self.loss, optimizer=self.optimizer,
                model_dir=self.model_dir, seed=self.seed,
                device=self.device)
        return self._est

    def fit(self, x, y=None, epochs: int = 1, batch_size: int = 32,
            validation_data=None, **kwargs):
        """x: ``[n, lookback, F]``, y: ``[n, horizon]``; or XShards / a
        ShardedDataset with ``y=None``. Returns the estimator's history."""
        data = x if y is None else (x, y)
        est = self._ensure_est(x)
        return est.fit(data, epochs=epochs, batch_size=batch_size,
                       validation_data=validation_data, **kwargs)

    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        if self._est is None:
            raise RuntimeError("call fit (or restore) before predict")
        return np.asarray(self._est.predict(x, batch_size=batch_size))

    def evaluate(self, x, y, metrics: Sequence[str] = ("mse",),
                 batch_size: int = 256) -> dict:
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        pred = self.predict(x, batch_size)
        return {m: Evaluator.evaluate(m, y, pred) for m in metrics}

    def save(self, path: str):
        self._est.save(path)

    def restore(self, path: str, sample_x=None):
        if self._est is None:
            if sample_x is None:
                raise ValueError("pass sample_x to restore an unbuilt model")
            self._ensure_est(sample_x)
        self._est.load(path)


class LSTMForecaster(Forecaster):
    """(ref forecast/LSTMForecaster)"""

    def __init__(self, target_dim: int = 1,
                 lstm_units: Tuple[int, ...] = (32, 32),
                 dropouts: Tuple[float, ...] = (0.2, 0.2), **kwargs):
        super().__init__(**kwargs)
        self.target_dim = target_dim
        self.lstm_units = tuple(lstm_units)
        self.dropouts = tuple(dropouts)

    def _build_module(self, in_features, generator):
        return VanillaLSTMNet(in_features, output_dim=self.target_dim,
                              lstm_units=self.lstm_units,
                              dropouts=self.dropouts, dtype=self._net_dtype,
                              generator=generator)


class Seq2SeqForecaster(Forecaster):
    """(ref forecast/Seq2SeqForecaster)"""

    def __init__(self, future_seq_len: int = 1, latent_dim: int = 64,
                 dropout: float = 0.2, **kwargs):
        super().__init__(**kwargs)
        self.future_seq_len = future_seq_len
        self.latent_dim = latent_dim
        self.dropout = dropout

    def _build_module(self, in_features, generator):
        return Seq2SeqNet(in_features, future_seq_len=self.future_seq_len,
                          latent_dim=self.latent_dim, dropout=self.dropout,
                          dtype=self._net_dtype, generator=generator)


class TCNForecaster(Forecaster):
    """(ref forecast/TCNForecaster → zouwu/model/tcn.py)"""

    def __init__(self, future_seq_len: int = 1,
                 num_channels: Tuple[int, ...] = (30, 30, 30),
                 kernel_size: int = 7, dropout: float = 0.2, **kwargs):
        super().__init__(**kwargs)
        self.future_seq_len = future_seq_len
        self.num_channels = tuple(num_channels)
        self.kernel_size = kernel_size
        self.dropout = dropout

    def _build_module(self, in_features, generator):
        return TemporalConvNet(in_features,
                               future_seq_len=self.future_seq_len,
                               num_channels=self.num_channels,
                               kernel_size=self.kernel_size,
                               dropout=self.dropout, dtype=self._net_dtype,
                               generator=generator)


class MTNetForecaster(Forecaster):
    """(ref forecast/MTNetForecaster over MTNet_keras.py; input seq len
    must equal (long_num + 1) * time_step — the ref's [long_input,
    short_input] pair concatenated along time).

    Accepts the REFERENCE hyperparameter names (``time_step``,
    ``long_num``, ``cnn_height``, ``rnn_hid_sizes`` list, ``cnn_dropout``,
    ``rnn_dropout`` — MTNet_keras.py apply_config defaults) and keeps the
    earlier aliases (series_length/long_series_num/cnn_kernel_size/
    rnn_hid_size/dropout) working."""

    def __init__(self, future_seq_len: int = 1,
                 time_step: Optional[int] = None,
                 long_num: Optional[int] = None,
                 cnn_height: Optional[int] = None,
                 cnn_hid_size: int = 32,
                 rnn_hid_sizes: Optional[Sequence[int]] = None,
                 ar_window: int = 4,
                 cnn_dropout: Optional[float] = None,
                 rnn_dropout: Optional[float] = None,
                 # earlier spellings (None = not passed, so a legacy-alias
                 # call is detectable)
                 long_series_num: Optional[int] = None,
                 series_length: Optional[int] = None,
                 rnn_hid_size: Optional[int] = None,
                 cnn_kernel_size: Optional[int] = None,
                 dropout: Optional[float] = None,
                 **kwargs):
        super().__init__(**kwargs)
        legacy_call = any(v is not None for v in (
            long_series_num, series_length, cnn_kernel_size, dropout,
            rnn_hid_size))
        if rnn_hid_sizes is None:
            if rnn_hid_size:
                rnn_hid_sizes = (rnn_hid_size,)
            elif legacy_call:
                # a legacy-alias caller that never chose an RNN size gets
                # the pre-round-4 single 32-unit GRU: the stacked (16, 32)
                # default changes the param-tree shape, so old scripts
                # would silently train a different architecture and old
                # checkpoints would fail to restore
                rnn_hid_sizes = (32,)
            else:
                rnn_hid_sizes = (16, 32)   # MTNet_keras.py apply_config
        if long_series_num is None:
            long_series_num = 4
        if series_length is None:
            series_length = 8
        if cnn_kernel_size is None:
            cnn_kernel_size = 3
        if dropout is None:
            dropout = 0.1
        self.kw = dict(
            output_dim=future_seq_len,
            long_num=long_num if long_num is not None else long_series_num,
            time_step=time_step if time_step is not None else series_length,
            cnn_hid_size=cnn_hid_size,
            rnn_hid_sizes=tuple(int(h) for h in rnn_hid_sizes),
            cnn_height=cnn_height if cnn_height is not None
            else cnn_kernel_size,
            ar_window=ar_window,
            # legacy `dropout` was ONE dropout before the GRU — map it to
            # cnn_dropout only (mapping it to both would stack two layers
            # and double the effective rate vs earlier rounds)
            cnn_dropout=cnn_dropout if cnn_dropout is not None else dropout,
            rnn_dropout=rnn_dropout if rnn_dropout is not None else 0.0)

    def _build_module(self, in_features, generator):
        return MTNetModule(in_features, dtype=self._net_dtype,
                           generator=generator, **self.kw)


# High-dimensional panel forecaster (ref zouwu/model/forecast/
# tcmf_forecaster.py lives beside the per-series forecasters)
from analytics_zoo_tpu_torch.zouwu.model.tcmf import TCMFForecaster  # noqa: E402,F401,E501
