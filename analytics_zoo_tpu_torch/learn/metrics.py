"""Metrics, in PyTorch (ref ``pyzoo/zoo/orca/learn/metrics.py``).

Counterpart of ``analytics_zoo_tpu/learn/metrics.py``: each metric is an
accumulator, ``init_state(device) -> state``, ``update(state, y_true,
y_pred, mask) -> state``, ``result(state) -> float``. States are dicts of
tensors on the model's device, so evaluation sums on the device and only
``result`` reads back to the host. The same registry names and formulas:
Accuracy, SparseCategoricalAccuracy, CategoricalAccuracy, BinaryAccuracy,
Top5Accuracy, AUC, MAE, MSE, RMSE, BinaryCrossentropy,
CategoricalCrossentropy, SparseCategoricalCrossentropy, KLDivergence,
Poisson.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from analytics_zoo_tpu_torch.learn.losses import _take_label

_EPS = 1e-7


def _align(y_true, y_pred):
    """Flatten both to [batch, features] so (n,) labels vs (n, 1)
    predictions do not broadcast into an (n, n) matrix."""
    b = y_pred.shape[0]
    return y_true.reshape(b, -1), y_pred.reshape(b, -1)


def _masked(values, mask):
    """Reduce per-sample values with an optional {0, 1} validity mask."""
    values = values.float()
    if values.ndim > 1:
        values = values.reshape(values.shape[0], -1).mean(dim=-1)
    if mask is None:
        return values.sum(), torch.tensor(float(values.shape[0]),
                                          device=values.device)
    return (values * mask).sum(), mask.sum()


class Metric:
    name = "metric"

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {"total": torch.zeros((), device=device),
                "count": torch.zeros((), device=device)}

    def update(self, state, y_true, y_pred, mask=None):
        total, count = _masked(self._per_sample(y_true, y_pred), mask)
        return {"total": state["total"] + total,
                "count": state["count"] + count}

    def _per_sample(self, y_true, y_pred):
        raise NotImplementedError

    def result(self, state) -> float:
        return float(state["total"] / torch.clamp(state["count"], min=1.0))

    def __repr__(self):
        return f"{type(self).__name__}()"


class Accuracy(Metric):
    """Auto-dispatching accuracy (ref metrics.py Accuracy: zero-based
    labels): binary if y_pred has 1 output, sparse-categorical if labels
    are class ids, categorical if labels are one-hot."""
    name = "accuracy"

    def _per_sample(self, y_true, y_pred):
        if y_pred.ndim <= 1 or y_pred.shape[-1] == 1:
            p = y_pred.reshape(y_pred.shape[0], -1)[:, 0]
            t = y_true.reshape(y_true.shape[0], -1)[:, 0]
            return ((p > 0.5) == (t > 0.5)).float()
        pred_cls = torch.argmax(y_pred, dim=-1)
        if y_true.ndim == y_pred.ndim:
            true_cls = torch.argmax(y_true, dim=-1)
        else:
            true_cls = y_true.to(torch.int64)
        return (pred_cls == true_cls).float()


class SparseCategoricalAccuracy(Accuracy):
    name = "sparse_categorical_accuracy"

    def _per_sample(self, y_true, y_pred):
        return (torch.argmax(y_pred, -1) == y_true.to(torch.int64)).float()


class CategoricalAccuracy(Metric):
    name = "categorical_accuracy"

    def _per_sample(self, y_true, y_pred):
        return (torch.argmax(y_pred, -1)
                == torch.argmax(y_true, -1)).float()


class BinaryAccuracy(Metric):
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def _per_sample(self, y_true, y_pred):
        t, p = _align(y_true, y_pred)
        return ((p > self.threshold) == (t > 0.5)).float()


class Top5Accuracy(Metric):
    """(ref metrics.py Top5Accuracy)"""
    name = "top5_accuracy"

    def _per_sample(self, y_true, y_pred):
        if y_true.ndim == y_pred.ndim:
            y_true = torch.argmax(y_true, -1)
        # the last five of an ascending stable sort, as jnp.argsort gives
        top5 = torch.argsort(y_pred, dim=-1, stable=True)[..., -5:]
        return torch.any(top5 == y_true.to(torch.int64)[..., None],
                         dim=-1).float()


class MAE(Metric):
    name = "mae"

    def _per_sample(self, y_true, y_pred):
        t, p = _align(y_true, y_pred)
        return torch.abs(p - t)


class MSE(Metric):
    name = "mse"

    def _per_sample(self, y_true, y_pred):
        t, p = _align(y_true, y_pred)
        return torch.square(p - t)


class RMSE(MSE):
    name = "rmse"

    def result(self, state):
        return float(torch.sqrt(state["total"]
                                / torch.clamp(state["count"], min=1.0)))


class BinaryCrossentropy(Metric):
    name = "binary_crossentropy"

    def _per_sample(self, y_true, y_pred):
        t, p = _align(y_true, y_pred)
        p = torch.clamp(p, _EPS, 1 - _EPS)
        return -(t * torch.log(p) + (1 - t) * torch.log1p(-p))


class CategoricalCrossentropy(Metric):
    name = "categorical_crossentropy"

    def _per_sample(self, y_true, y_pred):
        p = torch.clamp(y_pred, _EPS, 1.0)
        return -(y_true * torch.log(p)).sum(-1)


class SparseCategoricalCrossentropy(Metric):
    name = "sparse_categorical_crossentropy"

    def _per_sample(self, y_true, y_pred):
        p = torch.clamp(y_pred, _EPS, 1.0)
        return -torch.log(_take_label(p, y_true))


class KLDivergence(Metric):
    name = "kld"

    def _per_sample(self, y_true, y_pred):
        t = torch.clamp(y_true, _EPS, 1.0)
        p = torch.clamp(y_pred, _EPS, 1.0)
        return (t * torch.log(t / p)).sum(-1)


class Poisson(Metric):
    name = "poisson"

    def _per_sample(self, y_true, y_pred):
        t, p = _align(y_true, y_pred)
        return p - t * torch.log(p + _EPS)


class AUC(Metric):
    """Streaming ROC-AUC over ``num_thresholds`` buckets (ref metrics.py
    AUC -> BigDL AUC(20 thresholds); default raised to 200)."""
    name = "auc"

    def __init__(self, num_thresholds: int = 200):
        self.k = num_thresholds

    def init_state(self, device=None):
        z = torch.zeros((self.k,), device=device)
        return {"tp": z, "fp": z.clone(),
                "pos": torch.zeros((), device=device),
                "neg": torch.zeros((), device=device)}

    def update(self, state, y_true, y_pred, mask=None):
        y_pred = y_pred.reshape(-1)
        y_true = (y_true.reshape(-1) > 0.5).float()
        m = torch.ones_like(y_true) if mask is None else mask.reshape(-1)
        thresholds = torch.linspace(0.0, 1.0, self.k, device=y_pred.device)
        pred_ge = (y_pred[None, :] >= thresholds[:, None]).float()
        tp = (pred_ge * (y_true * m)[None, :]).sum(-1)
        fp = (pred_ge * ((1 - y_true) * m)[None, :]).sum(-1)
        return {"tp": state["tp"] + tp, "fp": state["fp"] + fp,
                "pos": state["pos"] + (y_true * m).sum(),
                "neg": state["neg"] + ((1 - y_true) * m).sum()}

    def result(self, state):
        tpr = state["tp"].cpu().numpy() / max(float(state["pos"]), 1.0)
        fpr = state["fp"].cpu().numpy() / max(float(state["neg"]), 1.0)
        # thresholds ascending -> fpr descending; integrate |dx| * mean(y)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2
        return float(np.abs(trapezoid(tpr, fpr)))


_REGISTRY: Dict[str, type] = {
    "accuracy": Accuracy, "acc": Accuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "binary_accuracy": BinaryAccuracy,
    "top5": Top5Accuracy, "top5_accuracy": Top5Accuracy,
    "mae": MAE, "mean_absolute_error": MAE,
    "mse": MSE, "mean_squared_error": MSE,
    "rmse": RMSE,
    "auc": AUC,
    "binary_crossentropy": BinaryCrossentropy,
    "categorical_crossentropy": CategoricalCrossentropy,
    "sparse_categorical_crossentropy": SparseCategoricalCrossentropy,
    "kld": KLDivergence, "kullback_leibler_divergence": KLDivergence,
    "poisson": Poisson,
}


def get(metric) -> Metric:
    """Resolve a metric name or instance (ref metrics.py Metric.get)."""
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        key = metric.lower()
        if key not in _REGISTRY:
            raise ValueError(f"unknown metric {metric!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[key]()
    raise TypeError(f"metric must be str or Metric, got {type(metric)}")

