"""AutoTS — automated time-series model selection + tuning.

API-parity with ``zoo.zouwu.autots.forecast`` (ref
pyzoo/zoo/zouwu/autots/forecast.py:22-181: ``AutoTSTrainer.fit(train_df,
validation_df, recipe) -> TSPipeline``; the pipeline bundles the fitted
feature transformer + best model with fit/evaluate/predict/save/load).
The search itself runs on the local search engine instead of Ray Tune
(ref regression/time_sequence_predictor.py:23 + automl/regression/
base_predictor.py:66).

Counterpart of ``analytics_zoo_tpu/zouwu/autots/forecast.py``: the same
trial model (the feature transformer and a forecaster fitted as a unit,
one ``fit_eval`` an epoch), the same pipeline files (``meta.json``,
``transformer.npz``, the forecaster's checkpoint under ``model``, which
either package restores), on the port's search engine and forecasters.
``device`` (``AutoTSTrainer``, ``TSPipeline.load``): ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA that raises. pandas is
imported by the transformer where a DataFrame is read.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.automl.model_builder import ModelBuilder
from analytics_zoo_tpu_torch.automl.search import LocalSearchEngine
from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.learn.optimizers import Adam
from analytics_zoo_tpu_torch.zouwu.config.recipe import Recipe, SmokeRecipe
from analytics_zoo_tpu_torch.zouwu.feature.time_sequence import (
    TimeSequenceFeatureTransformer,
)
from analytics_zoo_tpu_torch.zouwu.model.forecast import (
    LSTMForecaster,
    MTNetForecaster,
    Seq2SeqForecaster,
    TCNForecaster,
)

_MODEL_KEYS = {
    "VanillaLSTM": ("lstm_units", "dropouts"),
    "TCN": ("num_channels", "kernel_size"),
    "Seq2Seq": ("latent_dim", "dropout"),
    "MTNet": ("long_series_num", "series_length", "ar_window"),
}


def _build_forecaster(config: dict, future_seq_len: int,
                      device: DeviceLike = None):
    model = config.get("model", "VanillaLSTM")
    lr = float(config.get("lr", 1e-3))
    kw = {k: config[k] for k in _MODEL_KEYS.get(model, ())
          if k in config}
    kw["device"] = device
    opt = Adam(learningrate=lr)
    if model == "VanillaLSTM":
        if "lstm_units" in kw:
            kw["lstm_units"] = tuple(kw["lstm_units"])
        if "dropouts" in kw:
            d = kw["dropouts"]
            # recipes may sample a scalar rate (e.g. RandomRecipe's
            # hp.uniform) — apply it to every LSTM layer
            if np.isscalar(d):
                n = len(kw.get("lstm_units", (None, None)))
                d = (float(d),) * n
            kw["dropouts"] = tuple(d)
        return LSTMForecaster(target_dim=future_seq_len, optimizer=opt, **kw)
    if model == "TCN":
        if "num_channels" in kw:
            kw["num_channels"] = tuple(kw["num_channels"])
        return TCNForecaster(future_seq_len=future_seq_len, optimizer=opt,
                             **kw)
    if model == "Seq2Seq":
        return Seq2SeqForecaster(future_seq_len=future_seq_len, optimizer=opt,
                                 **kw)
    if model == "MTNet":
        return MTNetForecaster(future_seq_len=future_seq_len, optimizer=opt,
                               **kw)
    raise ValueError(f"unknown model family {model!r}")


def _effective_past_seq_len(config: dict) -> int:
    if config.get("model") == "MTNet":
        # MTNet consumes (long_series_num + 1) contiguous windows of
        # series_length each (ref MTNet input layout).
        lsn = int(config.get("long_series_num", 4))
        sl = int(config.get("series_length", 8))
        return (lsn + 1) * sl
    return int(config.get("past_seq_len", 24))


class _TSTrialModel:
    """One AutoTS trial: feature transformer + forecaster trained as a
    unit (the search engine drives ``fit_eval`` once per epoch)."""

    def __init__(self, config: dict, dt_col: str, target_col: str,
                 extra_features_col, future_seq_len: int,
                 device: DeviceLike = None):
        self.config = dict(config)
        self.dt_col, self.target_col = dt_col, target_col
        self.extra_features_col = extra_features_col
        self.future_seq_len = future_seq_len
        self.transformer = TimeSequenceFeatureTransformer(
            past_seq_len=_effective_past_seq_len(config),
            future_seq_len=future_seq_len, dt_col=dt_col,
            target_col=target_col, extra_features_col=extra_features_col,
            selected_features=config.get("selected_features"))
        self.forecaster = _build_forecaster(config, future_seq_len, device)
        self._train_xy = None
        self._val_xy = None

    def fit_eval(self, data, validation_data=None, epochs: int = 1,
                 metric: str = "mse", batch_size: Optional[int] = None
                 ) -> float:
        if self._train_xy is None:
            self._train_xy = self.transformer.fit_transform(data)
        x, y = self._train_xy
        bs = int(batch_size or self.config.get("batch_size", 32))
        bs = min(bs, len(x))
        self.forecaster.fit(x, y, epochs=epochs, batch_size=bs)
        if validation_data is not None:
            if self._val_xy is None:
                self._val_xy = self.transformer.transform(validation_data)
            vx, vy = self._val_xy
        else:
            vx, vy = x, y
        pred = self.forecaster.predict(vx)
        return Evaluator.evaluate(metric, vy, pred)

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.transformer.save(os.path.join(path, "transformer"))
        self.forecaster.save(os.path.join(path, "model"))
        meta = {"config": {k: (list(v) if isinstance(v, tuple) else v)
                           for k, v in self.config.items()},
                "dt_col": self.dt_col, "target_col": self.target_col,
                "extra_features_col": list(self.extra_features_col or []),
                "future_seq_len": self.future_seq_len}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def restore(self, path: str, sample_x=None):
        self.transformer.restore(os.path.join(path, "transformer"))
        n_feat = self.transformer.n_features
        dummy = np.zeros((1, self.transformer.past_seq_len, n_feat),
                         np.float32)
        self.forecaster.restore(os.path.join(path, "model"), sample_x=dummy)


class _TSModelBuilder(ModelBuilder):
    def __init__(self, dt_col, target_col, extra_features_col,
                 future_seq_len, device: DeviceLike = None):
        self.kw = dict(dt_col=dt_col, target_col=target_col,
                       extra_features_col=extra_features_col,
                       future_seq_len=future_seq_len, device=device)

    def build(self, config):
        return _TSTrialModel(config, **self.kw)


class TSPipeline:
    """Fitted transformer + model bundle (ref
    pyzoo/zoo/zouwu/pipeline/time_sequence.py:27 TimeSequencePipeline)."""

    def __init__(self, trial_model: _TSTrialModel):
        self._m = trial_model

    # -- inference ---------------------------------------------------------
    def predict(self, input_df: "pd.DataFrame") -> np.ndarray:
        """[n_windows, horizon] forecasts in original target units."""
        x = self._m.transformer.transform(input_df, with_y=False)
        pred = self._m.forecaster.predict(x)
        return self._m.transformer.unscale_y(pred)

    def evaluate(self, input_df: "pd.DataFrame",
                 metrics: Sequence[str] = ("mse",)) -> dict:
        x, y = self._m.transformer.transform(input_df)
        pred = self._m.forecaster.predict(x)
        y_true = self._m.transformer.unscale_y(y)
        y_pred = self._m.transformer.unscale_y(pred)
        return {m: Evaluator.evaluate(m, y_true, y_pred) for m in metrics}

    # -- incremental fit ---------------------------------------------------
    def fit(self, input_df: "pd.DataFrame", epochs: int = 1,
            batch_size: Optional[int] = None):
        """Continue training on new data with the fitted scaling."""
        x, y = self._m.transformer.transform(input_df)
        bs = int(batch_size or self._m.config.get("batch_size", 32))
        self._m.forecaster.fit(x, y, epochs=epochs,
                               batch_size=min(bs, len(x)))
        return self

    # -- persistence -------------------------------------------------------
    def save(self, path: str):
        self._m.save(path)
        return path

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TSPipeline":
        device = resolve_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        model = _TSTrialModel(meta["config"], meta["dt_col"],
                              meta["target_col"],
                              meta["extra_features_col"] or None,
                              int(meta["future_seq_len"]),
                              device=device)
        model.restore(path)
        return TSPipeline(model)

    @property
    def config(self) -> dict:
        return dict(self._m.config)


class AutoTSTrainer:
    """(ref autots/forecast.py:22 AutoTSTrainer). ``n_parallel`` (the
    port's addition, ``LocalSearchEngine``'s) runs trials from a thread
    pool."""

    def __init__(self, dt_col: str = "datetime", target_col: str = "value",
                 horizon: int = 1,
                 extra_features_col: Optional[Sequence[str]] = None,
                 logs_dir: Optional[str] = None,
                 name: str = "autots", seed: int = 0,
                 device: DeviceLike = None, n_parallel=1):
        self.device = resolve_device(device)
        self.dt_col, self.target_col = dt_col, target_col
        self.horizon = int(horizon)
        self.extra_features_col = extra_features_col
        self.builder = _TSModelBuilder(dt_col, target_col,
                                       extra_features_col, self.horizon,
                                       device=self.device)
        self.engine = LocalSearchEngine(self.builder, logs_dir=logs_dir,
                                        name=name, seed=seed,
                                        n_parallel=n_parallel,
                                        device=self.device)

    def fit(self, train_df: "pd.DataFrame",
            validation_df: "Optional[pd.DataFrame]" = None,
            recipe: Recipe = None, metric: str = "mse",
            scheduler: Optional[str] = None) -> TSPipeline:
        recipe = recipe or SmokeRecipe()
        rt = recipe.runtime_params()
        # what the recipe's selected_features axis may draw from
        available = TimeSequenceFeatureTransformer(
            dt_col=self.dt_col, target_col=self.target_col,
            extra_features_col=self.extra_features_col
        ).all_available_features
        self.engine.compile(train_df, recipe.search_space(available),
                            n_sampling=rt["n_sampling"], epochs=rt["epochs"],
                            validation_data=validation_df, metric=metric,
                            scheduler=scheduler,
                            search_alg=rt.get("search_alg"))
        self.engine.run()
        best = self.engine.get_best_trial()
        model = self.builder.build(best.config)
        model.restore(best.checkpoint)
        return TSPipeline(model)
