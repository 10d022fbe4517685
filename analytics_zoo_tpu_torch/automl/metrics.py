"""Evaluator — named-metric evaluation (numpy).

The port's copy of ``analytics_zoo_tpu/automl/metrics.py`` (ref
pyzoo/zoo/automl/common/metrics.py: sMAPE/MPE/MAPE/MSPE/MSE/RMSE/MAE/R2,
accuracy, logloss, AUC): the same functions, values and names, so the
forecasters' ``evaluate`` reports what JAX's does.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

EPS = 1e-8


def _flat(y_true, y_pred):
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.shape != y_pred.shape:
        y_pred = y_pred.reshape(y_true.shape)
    return y_true.reshape(-1), y_pred.reshape(-1)


def mse(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean((t - p) ** 2))


def rmse(y_true, y_pred):
    return float(np.sqrt(mse(y_true, y_pred)))


def mae(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean(np.abs(t - p)))


def r2(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    ss_res = np.sum((t - p) ** 2)
    ss_tot = np.sum((t - np.mean(t)) ** 2)
    return float(1.0 - ss_res / (ss_tot + EPS))


def mape(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean(np.abs((t - p) / np.maximum(np.abs(t), EPS))) * 100)


def smape(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean(2 * np.abs(t - p)
                         / np.maximum(np.abs(t) + np.abs(p), EPS)) * 100)


def mpe(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean((t - p) / np.maximum(np.abs(t), EPS)) * 100)


def mspe(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    return float(np.mean(((t - p) / np.maximum(np.abs(t), EPS)) ** 2) * 100)


def accuracy(y_true, y_pred):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_pred.ndim > y_true.ndim and y_pred.shape[-1] == 1:
        y_pred = y_pred.reshape(y_pred.shape[:-1])   # (n,1) sigmoid → (n,)
    if y_pred.ndim > y_true.ndim and y_pred.shape[-1] > 1:
        y_pred = np.argmax(y_pred, axis=-1)          # class logits/probs
    elif y_pred.dtype.kind == "f" and set(np.unique(y_true)) <= {0, 1}:
        # binary labels (any dtype) with float scores: threshold the
        # probabilities. Multiclass float label arrays compare directly.
        y_pred = (y_pred > 0.5).astype(y_true.dtype)
    return float(np.mean(y_true.reshape(-1) == y_pred.reshape(-1)))


def logloss(y_true, y_pred):
    t, p = _flat(y_true, y_pred)
    p = np.clip(p, EPS, 1 - EPS)
    return float(-np.mean(t * np.log(p) + (1 - t) * np.log(1 - p)))


def auc(y_true, y_pred):
    """Binary ROC AUC via the Mann-Whitney rank statistic (ref Evaluator
    AUC). ``y_pred``: scores, or 2-column probabilities (column 1 used)."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_pred.ndim == 2 and y_pred.shape[1] == 2:
        y_pred = y_pred[:, 1]
    y_pred = y_pred.reshape(-1)
    pos = y_true == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC needs both classes present")
    # average ranks so ties contribute 0.5
    order = np.argsort(y_pred)
    ranks = np.empty(len(y_pred), np.float64)
    ranks[order] = np.arange(1, len(y_pred) + 1)
    sorted_p = y_pred[order]
    i = 0
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


_METRICS: Dict[str, Callable] = {
    "mse": mse, "rmse": rmse, "mae": mae, "r2": r2, "mape": mape,
    "smape": smape, "mpe": mpe, "mspe": mspe, "accuracy": accuracy,
    "logloss": logloss, "auc": auc,
}

# metrics where smaller is better (used to orient the search)
_MINIMIZED = {"mse", "rmse", "mae", "mape", "smape", "mpe", "mspe", "logloss"}


class Evaluator:
    """``Evaluator.evaluate("rmse", y_true, y_pred)``."""

    metrics = sorted(_METRICS)

    @staticmethod
    def evaluate(metric: str, y_true, y_pred) -> float:
        m = metric.lower()
        if m not in _METRICS:
            raise ValueError(
                f"unknown metric '{metric}'; available: {Evaluator.metrics}")
        return _METRICS[m](y_true, y_pred)

    @staticmethod
    def get_metric_mode(metric: str) -> str:
        """'min' or 'max' — which direction improves ``metric``."""
        return "min" if metric.lower() in _MINIMIZED else "max"
