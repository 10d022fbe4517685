"""ModelBuilders — construct a trainable model from a sampled config.

Counterpart of ``analytics_zoo_tpu/automl/model_builder.py`` (ref
pyzoo/zoo/automl/model/base_keras_model.py:165 ``KerasModelBuilder``,
pyzoo/zoo/automl/model/base_pytorch_model.py:318 ``PytorchModelBuilder``):
``builder.build(config)`` returns a *trial model* exposing

    fit_eval(data, validation_data, epochs, metric, batch_size) -> float
    evaluate / predict / save / restore

which is what the search engine drives.

``TorchModelBuilder`` takes ``model_creator(config) -> nn.Module`` and
trains it through ``Estimator.from_torch`` on ``device`` (``cuda`` unless
the caller passes ``device="cpu"``); ``FlaxModelBuilder`` is its JAX
name. The module is built under ``torch.manual_seed(config["seed"])``
(default 0), so a config gives the same initial weights each time; they
are not JAX's (flax draws from threefry keys).
"""

from __future__ import annotations

import inspect
import os
from typing import Callable, Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.common.device import RNG_LOCK, DeviceLike


class ModelBuilder:
    def build(self, config: dict):  # pragma: no cover - interface
        raise NotImplementedError


def build_module(model_creator: Callable[[dict], object], config: dict):
    """``model_creator(config)`` with torch's default generator seeded
    from ``config["seed"]`` inside ``fork_rng`` (under ``RNG_LOCK``): the
    same config builds the same initial weights, and the caller's stream
    is left alone."""
    with RNG_LOCK, torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(config.get("seed", 0)))
        return model_creator(config)


class _EstimatorTrialModel:
    """Trial model over a ``TorchEstimator`` built from an ``nn.Module``."""

    def __init__(self, config, model_creator, loss_creator,
                 optimizer_creator, device: DeviceLike = None):
        self.config = dict(config)
        self.model_creator = model_creator
        self.loss_creator = loss_creator
        self.optimizer_creator = optimizer_creator
        self.device = device
        self._est = None

    def _ensure(self):
        if self._est is not None:
            return self._est
        from analytics_zoo_tpu_torch.learn import losses as loss_lib
        from analytics_zoo_tpu_torch.learn.estimator import Estimator
        module = build_module(self.model_creator, self.config)
        loss = (self.loss_creator(self.config) if self.loss_creator
                else loss_lib.get(self.config.get("loss", "mse")))
        if self.optimizer_creator:
            optimizer = self.optimizer_creator(self.config)
        else:
            from analytics_zoo_tpu_torch.learn.optimizers import Adam
            optimizer = Adam(learningrate=float(self.config.get("lr", 1e-3)))
        self._est = Estimator.from_torch(
            model=module, loss=loss, optimizer=optimizer,
            seed=int(self.config.get("seed", 0)), device=self.device)
        return self._est

    def fit_eval(self, data, validation_data=None, epochs: int = 1,
                 metric: str = "mse", batch_size: Optional[int] = None) -> float:
        x, y = data
        bs = int(batch_size or self.config.get("batch_size", 32))
        est = self._ensure()
        est.fit((x, y), epochs=epochs, batch_size=bs, shuffle=True)
        vx, vy = validation_data if validation_data is not None else (x, y)
        pred = np.asarray(est.predict(vx, batch_size=max(bs, 256)))
        return Evaluator.evaluate(metric, vy, pred)

    def predict(self, x, batch_size: int = 256):
        if self._est is None:
            raise RuntimeError("fit_eval or restore first")
        return np.asarray(self._est.predict(x, batch_size=batch_size))

    def evaluate(self, x, y, metrics=("mse",)) -> dict:
        pred = self.predict(x)
        return {m: Evaluator.evaluate(m, y, pred) for m in metrics}

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._est.save(os.path.join(path, "model"))

    def restore(self, path: str, sample_x=None):
        self._ensure()
        self._est.load(os.path.join(path, "model"))


class TorchModelBuilder(ModelBuilder):
    """``model_creator(config) -> torch.nn.Module`` (JAX's
    ``FlaxModelBuilder``, whose creator returns a flax module)."""

    def __init__(self, model_creator: Callable[[dict], object],
                 loss_creator: Optional[Callable] = None,
                 optimizer_creator: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.model_creator = model_creator
        self.loss_creator = loss_creator
        self.optimizer_creator = optimizer_creator
        self.device = device

    def build(self, config):
        return _EstimatorTrialModel(config, self.model_creator,
                                    self.loss_creator, self.optimizer_creator,
                                    self.device)


#: the JAX package's name
FlaxModelBuilder = TorchModelBuilder


class _ObjectTrialModel:
    """Trial model over any object with fit/predict (zoo-keras KerasNet,
    Forecaster, sklearn-style estimators)."""

    def __init__(self, config, creator):
        self.config = dict(config)
        with RNG_LOCK:
            self._model = creator(config)

    def fit_eval(self, data, validation_data=None, epochs: int = 1,
                 metric: str = "mse", batch_size: Optional[int] = None) -> float:
        x, y = data
        bs = int(batch_size or self.config.get("batch_size", 32))
        fit = getattr(self._model, "fit")
        epoch_kw = ("nb_epoch" if "nb_epoch" in
                    inspect.signature(fit).parameters else "epochs")
        fit(x, y, batch_size=bs, **{epoch_kw: epochs})
        vx, vy = validation_data if validation_data is not None else (x, y)
        pred = np.asarray(self._model.predict(vx))
        return Evaluator.evaluate(metric, vy, pred)

    def predict(self, x, batch_size: int = 256):
        return np.asarray(self._model.predict(x))

    def evaluate(self, x, y, metrics=("mse",)) -> dict:
        pred = self.predict(x)
        return {m: Evaluator.evaluate(m, y, pred) for m in metrics}

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        saver = getattr(self._model, "save_weights", None) or self._model.save
        saver(os.path.join(path, "model"))

    def restore(self, path: str, sample_x=None):
        loader = (getattr(self._model, "load_weights", None)
                  or getattr(self._model, "restore", None)
                  or getattr(self._model, "load", None))
        if loader is None:
            raise TypeError(
                f"{type(self._model).__name__} has none of load_weights/"
                f"restore/load — cannot restore trial checkpoint")
        loader(os.path.join(path, "model"))

    @property
    def model(self):
        return self._model


class KerasModelBuilder(ModelBuilder):
    """``model_creator(config) -> compiled zoo-keras model`` (ref
    base_keras_model.py KerasModelBuilder); the model's ``compile`` names
    its device."""

    def __init__(self, model_creator: Callable[[dict], object]):
        self.model_creator = model_creator

    def build(self, config):
        return _ObjectTrialModel(config, self.model_creator)
