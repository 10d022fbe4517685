"""XGBoost-style gradient-boosted trees + AutoXGBoost search.

The port's copy of ``analytics_zoo_tpu/automl/xgboost.py`` (host numpy,
the same trees and predictions bit for bit); the search runs on the
port's ``AutoEstimator`` (on the host: no device is involved).

API-parity with the reference's AutoXGBoost stack
(ref ``pyzoo/zoo/orca/automl/xgboost/XGBoost.py:189`` — sklearn-style
``XGBRegressor``/``XGBClassifier`` models driven by the hp search — and
``auto_xgb.py`` AutoXGBRegressor/AutoXGBClassifier).

The baked environment has no ``xgboost`` package, so the default backend
is a NATIVE second-order gradient-boosting implementation (quantile-binned
histogram splits, exact greedy gain ``G²/(H+λ)``, shrinkage, row
subsampling — the core XGBoost algorithm) in vectorized numpy; when the
real ``xgboost`` package is importable it is used instead. Trees are a
host-side ETL-adjacent workload — the TPU adds nothing to depth-6 splits,
so numpy is the right engine (same reasoning as the reference running
xgboost on CPU executors).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _has_xgboost() -> bool:
    try:
        import xgboost  # noqa: F401
        return True
    except ImportError:
        return False


# ------------------------------------------------------------- native GBDT

class _Node:
    __slots__ = ("feature", "bin_threshold", "left", "right", "leaf")

    def __init__(self, leaf=None, feature=None, threshold=None,
                 left=None, right=None):
        self.leaf = leaf
        self.feature = feature
        self.bin_threshold = threshold
        self.left = left
        self.right = right


class _Tree:
    """One regression tree on (grad, hess) — exact greedy over quantile
    bins, XGBoost gain = ½[G_l²/(H_l+λ) + G_r²/(H_r+λ) − G²/(H+λ)] − γ."""

    def __init__(self, max_depth=6, min_child_weight=1.0, reg_lambda=1.0,
                 gamma=0.0, n_bins=32):
        self.max_depth = max_depth
        self.min_child_weight = min_child_weight
        self.lam = reg_lambda
        self.gamma = gamma
        self.n_bins = n_bins
        self.root: Optional[_Node] = None

    def fit(self, x, g, h):
        # per-feature quantile bin edges (computed once per tree)
        self._edges = [
            np.unique(np.quantile(x[:, f], np.linspace(0, 1, self.n_bins)
                                  [1:-1]))
            for f in range(x.shape[1])]
        self.root = self._build(x, g, h, 0)
        return self

    def _leaf(self, g, h):
        return _Node(leaf=-g.sum() / (h.sum() + self.lam))

    def _build(self, x, g, h, depth):
        if depth >= self.max_depth or len(g) < 2 \
                or h.sum() < 2 * self.min_child_weight:
            return self._leaf(g, h)
        G, H = g.sum(), h.sum()
        parent = G * G / (H + self.lam)
        best = (self.gamma, None, None)        # (gain, feature, threshold)
        for f in range(x.shape[1]):
            edges = self._edges[f]
            if len(edges) == 0:
                continue
            bins = np.searchsorted(edges, x[:, f], side="right")
            gs = np.bincount(bins, weights=g, minlength=len(edges) + 1)
            hs = np.bincount(bins, weights=h, minlength=len(edges) + 1)
            gl = np.cumsum(gs)[:-1]
            hl = np.cumsum(hs)[:-1]
            gr, hr = G - gl, H - hl
            ok = (hl >= self.min_child_weight) & (hr >= self.min_child_weight)
            gain = 0.5 * (gl * gl / (hl + self.lam)
                          + gr * gr / (hr + self.lam) - parent)
            gain = np.where(ok, gain, -np.inf)
            j = int(np.argmax(gain))
            if gain[j] > best[0]:
                best = (float(gain[j]), f, float(edges[j]))
        if best[1] is None:
            return self._leaf(g, h)
        f, thr = best[1], best[2]
        mask = x[:, f] <= thr
        node = _Node(feature=f, threshold=thr)
        node.left = self._build(x[mask], g[mask], h[mask], depth + 1)
        node.right = self._build(x[~mask], g[~mask], h[~mask], depth + 1)
        return node

    def predict(self, x):
        out = np.zeros(len(x), np.float64)
        stack = [(self.root, np.arange(len(x)))]
        while stack:
            node, idx = stack.pop()
            if node.leaf is not None:
                out[idx] = node.leaf
                continue
            mask = x[idx, node.feature] <= node.bin_threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out


class _NativeBooster:
    """Second-order boosting loop shared by regressor/classifier."""

    def __init__(self, objective: str, n_estimators=50, max_depth=6,
                 learning_rate=0.3, min_child_weight=1.0, reg_lambda=1.0,
                 gamma=0.0, subsample=1.0, seed=0):
        self.objective = objective
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.learning_rate = float(learning_rate)
        self.min_child_weight = float(min_child_weight)
        self.reg_lambda = float(reg_lambda)
        self.gamma = float(gamma)
        self.subsample = float(subsample)
        self.seed = seed
        self.trees: List[_Tree] = []
        self.base_score = 0.0

    def _grad_hess(self, y, pred):
        if self.objective == "binary:logistic":
            p = 1.0 / (1.0 + np.exp(-pred))
            return p - y, np.maximum(p * (1 - p), 1e-6)
        return pred - y, np.ones_like(y)       # reg:squarederror

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64).reshape(-1)
        self.base_score = float(y.mean()) if \
            self.objective == "reg:squarederror" else 0.0
        pred = np.full(len(y), self.base_score)
        rng = np.random.default_rng(self.seed)
        self.trees = []
        for _ in range(self.n_estimators):
            g, h = self._grad_hess(y, pred)
            if self.subsample < 1.0:
                keep = rng.random(len(y)) < self.subsample
                if not keep.any():  # tiny n x low subsample: keep one row
                    keep[rng.integers(len(y))] = True
            else:
                keep = slice(None)
            tree = _Tree(self.max_depth, self.min_child_weight,
                         self.reg_lambda, self.gamma)
            tree.fit(x[keep], g[keep], h[keep])
            self.trees.append(tree)
            pred = pred + self.learning_rate * tree.predict(x)
        return self

    def margin(self, x):
        x = np.asarray(x, np.float64)
        out = np.full(len(x), self.base_score)
        for tree in self.trees:
            out = out + self.learning_rate * tree.predict(x)
        return out


# -------------------------------------------------------- sklearn-style API

class XGBRegressor:
    """(ref XGBoost.py XGBRegressor wrapper) — real xgboost when
    installed, native booster otherwise."""

    _objective = "reg:squarederror"

    def __init__(self, n_estimators=50, max_depth=6, learning_rate=0.3,
                 min_child_weight=1.0, reg_lambda=1.0, gamma=0.0,
                 subsample=1.0, seed=0, **extra):
        self.params = dict(n_estimators=n_estimators, max_depth=max_depth,
                           learning_rate=learning_rate,
                           min_child_weight=min_child_weight,
                           reg_lambda=reg_lambda, gamma=gamma,
                           subsample=subsample, seed=seed)
        self._model = None

    def fit(self, x, y, **kw):
        if _has_xgboost():
            import xgboost as xgb
            cls = (xgb.XGBRegressor
                   if self._objective == "reg:squarederror"
                   else xgb.XGBClassifier)
            params = {k: v for k, v in self.params.items() if k != "seed"}
            params["random_state"] = self.params.get("seed", 0)
            self._model = cls(**params)
            self._model.fit(np.asarray(x), np.asarray(y))
        else:
            self._model = _NativeBooster(self._objective,
                                         **self.params).fit(x, y)
        return self

    def _margin(self, x):
        if isinstance(self._model, _NativeBooster):
            return self._model.margin(x)
        return np.asarray(self._model.predict(np.asarray(x)))

    def predict(self, x):
        if self._model is None:
            raise RuntimeError("fit first")
        return self._margin(x)

    def evaluate(self, x, y, metrics=("mse",)) -> Dict[str, float]:
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        pred = self.predict(x)
        return {m: Evaluator.evaluate(m, np.asarray(y), pred)
                for m in metrics}


class XGBClassifier(XGBRegressor):
    """Binary classifier (logistic objective)."""

    _objective = "binary:logistic"

    def predict_proba(self, x):
        if isinstance(self._model, _NativeBooster):
            p = 1.0 / (1.0 + np.exp(-self._model.margin(x)))
            return np.stack([1 - p, p], axis=1)
        return np.asarray(self._model.predict_proba(np.asarray(x)))

    def predict(self, x):
        if self._model is None:
            raise RuntimeError("fit first")
        if isinstance(self._model, _NativeBooster):
            return (self._model.margin(x) > 0).astype(np.int64)
        return np.asarray(self._model.predict(np.asarray(x)))


# ------------------------------------------------------------- auto search

class _XGBTrialModel:
    def __init__(self, config, cls, metric_needs_proba):
        self.config = dict(config)
        self._m = cls(**{k: v for k, v in config.items()
                         if k not in ("metric",)})
        self._proba = metric_needs_proba

    def fit_eval(self, data, validation_data=None, epochs=1, metric="mse",
                 batch_size=None):
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        x, y = data
        self._m.fit(x, y)
        vx, vy = validation_data if validation_data is not None else (x, y)
        if self._proba and hasattr(self._m, "predict_proba"):
            pred = self._m.predict_proba(vx)[:, 1]
        else:
            pred = self._m.predict(vx)
        return Evaluator.evaluate(metric, np.asarray(vy), pred)

    def predict(self, x, batch_size=None):
        return self._m.predict(x)

    def evaluate(self, x, y, metrics=("mse",)):
        return self._m.evaluate(x, y, metrics)

    def save(self, path):
        import os
        import pickle
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "xgb.pkl"), "wb") as fh:
            pickle.dump(self._m, fh)

    def restore(self, path, sample_x=None):
        import os
        import pickle
        with open(os.path.join(path, "xgb.pkl"), "rb") as fh:
            self._m = pickle.load(fh)


class _XGBBuilder:
    def __init__(self, cls, metric_needs_proba=False):
        self.cls = cls
        self.metric_needs_proba = metric_needs_proba

    def build(self, config):
        return _XGBTrialModel(config, self.cls, self.metric_needs_proba)


class AutoXGBRegressor:
    """hp search over XGBRegressor (ref orca/automl/xgboost auto_xgb.py
    AutoXGBRegressor: .fit(data, search_space, metric) → best model)."""

    _cls = XGBRegressor
    _needs_proba = False

    def __init__(self, logs_dir: Optional[str] = None,
                 name: str = "auto_xgb", seed: int = 0, **fixed_params):
        from analytics_zoo_tpu_torch.automl.auto_estimator import AutoEstimator
        self.fixed = fixed_params
        # the trees are host numpy: the search needs no device
        self._auto = AutoEstimator(
            _XGBBuilder(self._cls, self._needs_proba),
            logs_dir=logs_dir, name=name, seed=seed, device="cpu")

    def fit(self, data, validation_data=None, search_space=None,
            n_sampling: int = 4, metric: str = "rmse", mode=None,
            search_alg=None, **kw):
        space = dict(self.fixed)
        space.update(search_space or {})
        self._auto.fit(data, validation_data=validation_data,
                       search_space=space, n_sampling=n_sampling,
                       epochs=1, metric=metric, mode=mode,
                       search_alg=search_alg)
        return self

    def get_best_model(self):
        return self._auto.get_best_model()

    def get_best_config(self):
        return self._auto.get_best_config()


class AutoXGBClassifier(AutoXGBRegressor):
    _cls = XGBClassifier
    _needs_proba = True


AutoXGBoost = AutoXGBRegressor  # reference spelling
