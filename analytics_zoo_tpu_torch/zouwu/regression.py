"""TimeSequencePredictor — the AutoTS search entry below AutoTSTrainer.

API parity with ref ``pyzoo/zoo/zouwu/regression/time_sequence_predictor.py:23``
(``TimeSequencePredictor(name, logs_dir, future_seq_len, dt_col,
target_col, extra_features_col).fit(input_df, validation_df, metric,
recipe) -> TimeSequencePipeline``; fit impl inherited from
``automl/regression/base_predictor.py:66``). Here it is a thin facade
over the same search engine that backs ``AutoTSTrainer`` — the Ray Tune
trial machinery collapses into the local engine. The port's copy of
``analytics_zoo_tpu/zouwu/regression.py``; ``device`` as
``AutoTSTrainer``'s."""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

from analytics_zoo_tpu_torch.common.device import DeviceLike
from analytics_zoo_tpu_torch.zouwu.autots.forecast import (AutoTSTrainer,
                                                           TSPipeline)
from analytics_zoo_tpu_torch.zouwu.config.recipe import Recipe, SmokeRecipe

__all__ = ["TimeSequencePredictor"]


class TimeSequencePredictor:
    """Trains a forecaster by hyperparameter search over recipes;
    ``fit`` returns a ``TSPipeline`` (the ref's TimeSequencePipeline).

    ``search_alg_params`` and ``scheduler_params`` are accepted for
    signature parity with the reference's Ray Tune configuration and are
    ignored — the local engine's bayes/hyperband implementations are not
    parameterized per-call."""

    def __init__(self, name: str = "automl",
                 logs_dir: str = "~/zoo_automl_logs",
                 future_seq_len: int = 1,
                 dt_col: str = "datetime",
                 target_col: Union[str, Sequence[str]] = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 drop_missing: bool = True,
                 search_alg: Optional[str] = None,
                 search_alg_params=None,   # Ray-Tune-ism, parity only
                 scheduler: Optional[str] = None,
                 scheduler_params=None,    # Ray-Tune-ism, parity only
                 device: DeviceLike = None):
        if not isinstance(target_col, str):
            if len(target_col) != 1:
                raise ValueError("only a single target_col is supported")
            target_col = target_col[0]
        self.name = name
        self.logs_dir = os.path.expanduser(logs_dir)
        self.future_seq_len = int(future_seq_len)
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = extra_features_col
        self.drop_missing = drop_missing
        self.search_alg = search_alg
        self.scheduler = scheduler
        self.device = device
        self.pipeline: Optional[TSPipeline] = None

    def fit(self, input_df, validation_df=None, metric: str = "mse",
            recipe: Optional[Recipe] = None, mc: bool = False,
            resources_per_trial=None, upload_dir=None) -> TSPipeline:
        """(ref base_predictor.py:66 — mc / resources_per_trial /
        upload_dir are Ray-Tune-isms accepted for signature parity;
        trials pack over the mesh instead)."""
        recipe = recipe or SmokeRecipe()
        if self.search_alg is not None and recipe.search_alg is None:
            # shallow-copy so the caller's recipe object is not mutated
            import copy
            recipe = copy.copy(recipe)
            recipe.search_alg = self.search_alg
        if self.drop_missing:
            input_df = input_df.dropna()
            if validation_df is not None:
                validation_df = validation_df.dropna()
        trainer = AutoTSTrainer(
            dt_col=self.dt_col, target_col=self.target_col,
            horizon=self.future_seq_len,
            extra_features_col=self.extra_features_col,
            logs_dir=self.logs_dir, name=self.name, device=self.device)
        self.pipeline = trainer.fit(input_df, validation_df, recipe=recipe,
                                    metric=metric, scheduler=self.scheduler)
        return self.pipeline

    def evaluate(self, input_df, metric=None):
        """(ref base_predictor.py:125)"""
        if self.pipeline is None:
            raise RuntimeError("call fit first")
        metrics = ([metric] if isinstance(metric, str)
                   else list(metric or ["mse"]))
        return self.pipeline.evaluate(input_df, metrics=metrics)

    def predict(self, input_df):
        """(ref base_predictor.py:142)"""
        if self.pipeline is None:
            raise RuntimeError("call fit first")
        return self.pipeline.predict(input_df)
