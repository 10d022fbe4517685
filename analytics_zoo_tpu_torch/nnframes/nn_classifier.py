"""NNFrames — Estimator/Transformer ML-pipeline stages over DataFrames.

Counterpart of ``analytics_zoo_tpu/nnframes/nn_classifier.py`` (ref
zoo/.../pipeline/nnframes/NNEstimator.scala:202 ``NNEstimator.fit(df) ->
NNModel``, ``NNModel:679`` transform adds a prediction column,
``NNClassifier.scala`` argmax variant, ``NNImageReader.scala:182`` reads an
image directory into a DataFrame; python mirror
pyzoo/zoo/pipeline/nnframes/nn_classifier.py:714). The frame is a pandas
DataFrame and the engine the port's estimator: a zoo keras model trains
through its own ``compile`` / estimator, any other ``nn.Module`` through
``Estimator.from_torch``. The pipeline-stage contract (set params -> fit
-> model.transform) is the JAX package's, and so is a fitted model's
``save`` / ``load``: the estimator's checkpoint, which either package
reads. Training runs on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common.device import DeviceLike, resolve_device
from analytics_zoo_tpu_torch.learn.estimator import Estimator, TorchEstimator


def _df_to_xy(df, feature_cols, label_cols=None,
              feature_preprocessing=None):
    """DataFrame columns → (x, y) ndarrays. Array-valued cells (lists /
    ndarrays, e.g. an image column) are stacked; scalar columns are
    column-stacked into one feature matrix (the reference's
    SeqToTensor/ArrayToTensor preprocessing analog)."""
    def col_to_array(col):
        vals = df[col].tolist()
        first = vals[0]
        if isinstance(first, (list, tuple, np.ndarray)):
            return np.stack([np.asarray(v, np.float32) for v in vals])
        return np.asarray(vals, np.float32)

    feats = [col_to_array(c) for c in feature_cols]
    if len(feats) == 1:
        x = feats[0]
    elif all(f.ndim == 1 for f in feats):
        x = np.column_stack(feats)
    else:
        x = tuple(feats)
    if feature_preprocessing is not None:
        x = feature_preprocessing(x)
    if label_cols is None:
        return x, None
    labels = [col_to_array(c) for c in label_cols]
    y = labels[0] if len(labels) == 1 else np.column_stack(labels)
    return x, y


class NNModel:
    """Fitted transformer: ``transform(df)`` appends a prediction column
    (ref NNModel.scala:679 / python NNModel)."""

    def __init__(self, estimator: TorchEstimator,
                 feature_cols: Sequence[str] = ("features",),
                 prediction_col: str = "prediction",
                 feature_preprocessing=None, batch_size: int = 256):
        self.estimator = estimator
        self.feature_cols = list(feature_cols)
        self.prediction_col = prediction_col
        self.feature_preprocessing = feature_preprocessing
        self.batch_size = batch_size

    def set_feature_cols(self, cols) -> "NNModel":
        self.feature_cols = list(cols)
        return self

    def set_prediction_col(self, col: str) -> "NNModel":
        self.prediction_col = col
        return self

    def _predict_array(self, df) -> np.ndarray:
        x, _ = _df_to_xy(df, self.feature_cols,
                         feature_preprocessing=self.feature_preprocessing)
        return np.asarray(self.estimator.predict(
            x, batch_size=self.batch_size))

    def transform(self, df):
        preds = self._predict_array(df)
        out = df.copy()
        out[self.prediction_col] = (
            list(preds) if preds.ndim > 1 else preds)
        return out

    # -- persistence (ref NNModel.save/load) --
    def save(self, path: str):
        self.estimator.save(path)
        return path

    def load(self, path: str) -> "NNModel":
        self.estimator.load(path)
        return self


class NNEstimator:
    """``NNEstimator(model, loss).setBatchSize(...).fit(df) → NNModel``
    (ref NNEstimator.scala:202; python NNEstimator in nn_classifier.py).

    ``model``: a zoo-keras model (KerasNet / ZooModel) or an ``nn.Module``
    (JAX's flax module). ``device``: where it trains (``cuda`` unless
    given; raises without CUDA).
    """

    _model_cls = NNModel

    def __init__(self, model, loss, optimizer="adam",
                 feature_preprocessing=None, label_preprocessing=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.feature_cols: List[str] = ["features"]
        self.label_cols: List[str] = ["label"]
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 1
        self.caching_sample = True
        self._validation = None
        self._checkpoint_path = None

    # -- param setters (Spark-ML style, ref setFeaturesCol etc.) --
    def set_features_col(self, cols) -> "NNEstimator":
        self.feature_cols = [cols] if isinstance(cols, str) else list(cols)
        return self

    def set_label_col(self, cols) -> "NNEstimator":
        self.label_cols = [cols] if isinstance(cols, str) else list(cols)
        return self

    def set_prediction_col(self, col: str) -> "NNEstimator":
        self.prediction_col = col
        return self

    def set_batch_size(self, bs: int) -> "NNEstimator":
        self.batch_size = int(bs)
        return self

    def set_max_epoch(self, n: int) -> "NNEstimator":
        self.max_epoch = int(n)
        return self

    def set_validation(self, df, trigger=None) -> "NNEstimator":
        self._validation = df
        return self

    def set_checkpoint(self, path: str) -> "NNEstimator":
        self._checkpoint_path = path
        return self

    # camelCase aliases matching the reference python API
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setPredictionCol = set_prediction_col
    setBatchSize = set_batch_size
    setMaxEpoch = set_max_epoch
    setValidation = set_validation
    setCheckpoint = set_checkpoint

    def _build_estimator(self) -> TorchEstimator:
        from analytics_zoo_tpu_torch.keras.models import KerasNet
        model = self.model
        if hasattr(model, "model") and isinstance(
                getattr(model, "model", None), KerasNet):
            model = model.model  # ZooModel wrapper
        if isinstance(model, KerasNet):
            model.compile(optimizer=self.optimizer, loss=self.loss,
                          device=self.device)
            est = model._ensure_estimator(for_training=True)
            if self._checkpoint_path:
                est.model_dir = self._checkpoint_path
            return est
        # an nn.Module (JAX's flax module case: the port needs no sample
        # input to initialise it)
        return Estimator.from_torch(
            model=model, loss=self.loss, optimizer=self.optimizer,
            model_dir=self._checkpoint_path, device=self.device)

    def fit(self, df) -> NNModel:
        x, y = _df_to_xy(df, self.feature_cols, self.label_cols,
                         self.feature_preprocessing)
        if self.label_preprocessing is not None:
            y = self.label_preprocessing(y)
        est = self._build_estimator()
        val = None
        if self._validation is not None:
            vx, vy = _df_to_xy(self._validation, self.feature_cols,
                               self.label_cols, self.feature_preprocessing)
            if self.label_preprocessing is not None:
                vy = self.label_preprocessing(vy)
            val = (vx, vy)
        est.fit((x, y), epochs=self.max_epoch, batch_size=self.batch_size,
                validation_data=val)
        return self._model_cls(
            est, feature_cols=self.feature_cols,
            prediction_col=self.prediction_col,
            feature_preprocessing=self.feature_preprocessing,
            batch_size=max(self.batch_size, 32))


class NNClassifierModel(NNModel):
    """Prediction column holds the argmax class (ref NNClassifierModel)."""

    def transform(self, df):
        preds = self._predict_array(df)
        out = df.copy()
        if preds.ndim > 1 and preds.shape[-1] > 1:
            out[self.prediction_col] = np.argmax(preds, axis=-1).astype(
                np.float64)
        else:
            out[self.prediction_col] = (preds.reshape(-1) > 0.5).astype(
                np.float64)
        return out


class NNClassifier(NNEstimator):
    """NNEstimator whose fitted model emits class labels
    (ref NNClassifier.scala / python NNClassifier)."""

    _model_cls = NNClassifierModel


class NNImageReader:
    """Read an image directory into a DataFrame with ``image`` (HWC float
    array) and ``origin`` (path) columns — the reference reads into a Spark
    DataFrame of image schema rows (ref NNImageReader.scala:182)."""

    @staticmethod
    def read_images(path: str, resize_h: Optional[int] = None,
                    resize_w: Optional[int] = None, with_label: bool = False):
        import pandas as pd
        from analytics_zoo_tpu_torch.feature.image import ImageSet
        from analytics_zoo_tpu_torch.feature.image.transforms import \
            ImageResize

        iset = ImageSet.read(path, with_label=with_label)
        if resize_h:
            iset = iset.transform(ImageResize(resize_h, resize_w or resize_h))
        feats = iset._features()
        data = {"image": [np.asarray(f.image, np.float32) for f in feats],
                "origin": [f.get("uri", "") for f in feats]}
        if with_label:
            data["label"] = [f.label for f in feats]
        return pd.DataFrame(data)
