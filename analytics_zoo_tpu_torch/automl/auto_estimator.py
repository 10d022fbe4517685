"""AutoEstimator — sklearn-style hyperparameter search entry point.

API-parity with ``zoo.orca.automl.auto_estimator.AutoEstimator`` (ref
pyzoo/zoo/orca/automl/auto_estimator.py:20-125: ``from_torch``/``from_keras``
constructors, ``fit(data, search_space, n_sampling, epochs, metric)``,
``get_best_model``).

Counterpart of ``analytics_zoo_tpu/automl/auto_estimator.py``:
``from_torch`` (``model_creator(config) -> nn.Module``, trained through
``Estimator.from_torch``; ``from_flax`` is its JAX name) and
``from_keras``. ``device``: ``cuda`` unless the caller passes
``device="cpu"``; without CUDA that raises.
"""

from __future__ import annotations

from typing import Callable, Optional

from analytics_zoo_tpu_torch.automl.model_builder import (
    KerasModelBuilder,
    ModelBuilder,
    TorchModelBuilder,
)
from analytics_zoo_tpu_torch.automl.search import LocalSearchEngine
from analytics_zoo_tpu_torch.common.device import DeviceLike


class AutoEstimator:
    def __init__(self, model_builder: ModelBuilder,
                 logs_dir: Optional[str] = None,
                 name: str = "auto_estimator", seed: int = 0,
                 device: DeviceLike = None):
        self.builder = model_builder
        self.engine = LocalSearchEngine(model_builder, logs_dir=logs_dir,
                                        name=name, seed=seed, device=device)
        self._best_trial = None
        self._best_model = None

    @staticmethod
    def from_torch(*, model_creator: Callable[[dict], object],
                   loss_creator: Optional[Callable] = None,
                   optimizer_creator: Optional[Callable] = None,
                   logs_dir: Optional[str] = None,
                   name: str = "auto_torch", seed: int = 0,
                   device: DeviceLike = None) -> "AutoEstimator":
        """``model_creator(config) -> torch.nn.Module`` (ref
        auto_estimator.py:from_torch)."""
        return AutoEstimator(
            TorchModelBuilder(model_creator, loss_creator, optimizer_creator,
                              device=device),
            logs_dir=logs_dir, name=name, seed=seed, device=device)

    #: the JAX package's name
    from_flax = from_torch

    @staticmethod
    def from_keras(*, model_creator: Callable[[dict], object],
                   logs_dir: Optional[str] = None,
                   name: str = "auto_keras", seed: int = 0,
                   device: DeviceLike = None) -> "AutoEstimator":
        """``model_creator(config) -> compiled zoo-keras model`` (ref
        auto_estimator.py:from_keras); the model's ``compile`` names
        where it trains."""
        return AutoEstimator(KerasModelBuilder(model_creator),
                             logs_dir=logs_dir, name=name, seed=seed,
                             device=device)

    def fit(self, data, validation_data=None, search_space: dict = None,
            n_sampling: int = 1, epochs: int = 1, metric: str = "mse",
            mode: Optional[str] = None, scheduler: Optional[str] = None,
            batch_size: Optional[int] = None,
            search_alg: Optional[str] = None,
            n_parallel=None) -> "AutoEstimator":
        """``data``: ``(x, y)`` numpy pair (the reference also accepts
        XShards/DataFrames — use ``.to_numpy()`` paths upstream).

        ``search_alg="bayes"`` → sequential model-based proposals (ref
        tune skopt/bayesopt); ``scheduler="hyperband"`` → successive
        halving; ``n_parallel=N|"auto"`` → trials from a thread pool over
        the cards."""
        if search_space is None:
            raise ValueError("search_space is required")
        self._best_trial = None
        self._best_model = None
        if n_parallel is not None:
            self.engine.n_parallel = n_parallel
        self.engine.compile(data, search_space, n_sampling=n_sampling,
                            epochs=epochs, validation_data=validation_data,
                            metric=metric, mode=mode, scheduler=scheduler,
                            batch_size=batch_size, search_alg=search_alg)
        self.engine.run()
        self._best_trial = self.engine.get_best_trial()
        return self

    def get_best_trial(self):
        if self._best_trial is None:
            raise RuntimeError("fit first")
        return self._best_trial

    def get_best_config(self) -> dict:
        return dict(self.get_best_trial().config)

    def get_best_model(self):
        """Rebuild the best config's model and restore its checkpoint."""
        if self._best_model is None:
            trial = self.get_best_trial()
            model = self.builder.build(trial.config)
            x = self.engine.data[0]
            model.restore(trial.checkpoint, sample_x=x)
            self._best_model = model
        return self._best_model
