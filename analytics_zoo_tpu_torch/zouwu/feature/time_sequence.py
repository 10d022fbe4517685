"""Rolling-window + datetime feature engineering for time series.

Rebuild of ref ``pyzoo/zoo/zouwu/feature/time_sequence.py``
(TimeSequenceFeatureTransformer: fit_transform → rolling windows over a
datetime-indexed frame, derived datetime features, min-max scaling with
inverse transform for the target; ``:31``).

Output discipline: fixed-shape float32 arrays [n, lookback, F] / [n, horizon].

The port's copy of ``analytics_zoo_tpu/zouwu/feature/time_sequence.py``:
host numpy, the same arrays bit for bit; pandas is imported where a
DataFrame is read, never when the module is."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_DT_FEATURES = ("HOUR", "DAY", "DAYOFWEEK", "MONTH", "IS_WEEKEND")


class TimeSequenceFeatureTransformer:
    """fit_transform(df) → (x, y); transform(df) for val/test;
    ``unscale_y`` inverts target scaling for metric reporting."""

    def __init__(self, past_seq_len: int = 50, future_seq_len: int = 1,
                 dt_col: str = "datetime", target_col: str = "value",
                 extra_features_col: Optional[Sequence[str]] = None,
                 with_dt_features: bool = True, scale: bool = True,
                 selected_features: Optional[Sequence[str]] = None):
        self.past_seq_len = int(past_seq_len)
        self.future_seq_len = int(future_seq_len)
        self.dt_col = dt_col
        self.target_col = target_col
        self.extra_features_col = list(extra_features_col or [])
        self.with_dt_features = with_dt_features
        self.scale = scale
        # feature-selection axis (ref recipes sample `selected_features`
        # from all_available_features): names among the non-target features
        # to keep; the target itself is always feature 0
        self.selected_features = (None if selected_features is None
                                  else [str(s) for s in selected_features])
        if self.selected_features is not None:
            unknown = set(self.selected_features) - set(
                self.all_available_features)
            if unknown:
                raise ValueError(f"unknown selected_features {sorted(unknown)}"
                                 f"; available: {self.all_available_features}")
        self._mins: Optional[np.ndarray] = None
        self._maxs: Optional[np.ndarray] = None

    # ---------- feature matrix ----------

    def _dt_features(self, dt: "pd.Series") -> np.ndarray:
        import pandas as pd
        dt = pd.to_datetime(dt)
        cols = [
            dt.dt.hour.to_numpy(np.float32) / 23.0,
            (dt.dt.day.to_numpy(np.float32) - 1) / 30.0,
            dt.dt.dayofweek.to_numpy(np.float32) / 6.0,
            (dt.dt.month.to_numpy(np.float32) - 1) / 11.0,
            (dt.dt.dayofweek >= 5).to_numpy(np.float32),
        ]
        return np.stack(cols, axis=1)

    def _feature_matrix(self, df: pd.DataFrame) -> np.ndarray:
        feats = [df[self.target_col].to_numpy(np.float32)[:, None]]
        for c in self.extra_features_col:
            feats.append(df[c].to_numpy(np.float32)[:, None])
        if self.with_dt_features:
            feats.append(self._dt_features(df[self.dt_col]))
        mat = np.concatenate(feats, axis=1)
        if self.selected_features is not None:
            keep = set(self.selected_features)
            cols = [0] + [i for i, n in enumerate(
                self.all_available_features, start=1) if n in keep]
            mat = mat[:, cols]
        return mat

    @property
    def all_available_features(self) -> List[str]:
        """Every selectable (non-target) feature name — what a recipe's
        ``selected_features`` axis draws from (ref
        TimeSequenceFeatureTransformer.get_feature_list)."""
        names = list(self.extra_features_col)
        if self.with_dt_features:
            names += list(_DT_FEATURES)
        return names

    @property
    def feature_names(self) -> List[str]:
        if self.selected_features is not None:
            keep = set(self.selected_features)
            return [self.target_col] + [n for n in
                                        self.all_available_features
                                        if n in keep]
        return [self.target_col] + self.all_available_features

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    # ---------- scaling ----------

    def _fit_scale(self, mat: np.ndarray):
        self._mins = mat.min(0)
        self._maxs = mat.max(0)

    def _apply_scale(self, mat: np.ndarray) -> np.ndarray:
        span = np.where(self._maxs - self._mins == 0, 1.0,
                        self._maxs - self._mins)
        return (mat - self._mins) / span

    def unscale_y(self, y: np.ndarray) -> np.ndarray:
        """Invert target scaling (target is feature 0)."""
        if not self.scale or self._mins is None:
            return y
        return y * (self._maxs[0] - self._mins[0]) + self._mins[0]

    # ---------- rolling ----------

    def _roll(self, mat: np.ndarray, with_y: bool) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        p, f = self.past_seq_len, self.future_seq_len
        n = len(mat) - p - (f if with_y else 0) + 1
        if n <= 0:
            raise ValueError(
                f"need at least {p + (f if with_y else 0)} rows, have {len(mat)}")
        idx = np.arange(p)[None, :] + np.arange(n)[:, None]
        x = mat[idx]                                   # [n, p, F]
        y = None
        if with_y:
            yidx = p + np.arange(f)[None, :] + np.arange(n)[:, None]
            y = mat[yidx, 0]                           # [n, f] target only
        return x.astype(np.float32), None if y is None else y.astype(np.float32)

    # ---------- public API (ref time_sequence.py fit_transform/transform) --

    def fit_transform(self, df: pd.DataFrame) -> Tuple[np.ndarray, np.ndarray]:
        mat = self._feature_matrix(df)
        if self.scale:
            self._fit_scale(mat)
            mat = self._apply_scale(mat)
        return self._roll(mat, with_y=True)

    def transform(self, df: pd.DataFrame, with_y: bool = True):
        mat = self._feature_matrix(df)
        if self.scale:
            if self._mins is None:
                raise RuntimeError("call fit_transform first")
            mat = self._apply_scale(mat)
        x, y = self._roll(mat, with_y=with_y)
        return (x, y) if with_y else x

    def save(self, path: str):
        scaled = self._mins is not None
        np.savez(
            path,
            mins=self._mins if scaled else np.zeros(0, np.float32),
            maxs=self._maxs if scaled else np.zeros(0, np.float32),
            fitted_scale=scaled,
            past=self.past_seq_len, future=self.future_seq_len,
            dt_col=self.dt_col, target_col=self.target_col,
            extra_features_col=np.asarray(self.extra_features_col, dtype=object)
            if self.extra_features_col else np.zeros(0, dtype="U1"),
            with_dt_features=self.with_dt_features, scale=self.scale,
            has_selected=self.selected_features is not None,
            selected_features=np.asarray(self.selected_features, dtype=object)
            if self.selected_features else np.zeros(0, dtype="U1"))

    def restore(self, path: str):
        d = np.load(path if path.endswith(".npz") else path + ".npz",
                    allow_pickle=True)
        if bool(d["fitted_scale"]):
            self._mins, self._maxs = d["mins"], d["maxs"]
        else:
            self._mins = self._maxs = None
        self.past_seq_len = int(d["past"])
        self.future_seq_len = int(d["future"])
        self.dt_col = str(d["dt_col"])
        self.target_col = str(d["target_col"])
        self.extra_features_col = [str(c) for c in d["extra_features_col"]]
        self.with_dt_features = bool(d["with_dt_features"])
        self.scale = bool(d["scale"])
        if "has_selected" in d and bool(d["has_selected"]):
            self.selected_features = [str(c) for c in d["selected_features"]]
        else:
            self.selected_features = None
