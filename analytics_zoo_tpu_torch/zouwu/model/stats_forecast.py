"""Statistical forecasters — ARIMA and a Prophet-class seasonal model.

The port's copy of ``analytics_zoo_tpu/zouwu/model/stats_forecast.py``
(host numpy and pandas: the same fits and forecasts bit for bit).

The reference wraps external native libraries: ``pmdarima``/statsmodels for
ARIMA (pyzoo/zoo/zouwu/model/arima.py) and ``fbprophet`` (Stan) for Prophet
(pyzoo/zoo/zouwu/model/prophet.py). Neither is in the baked TPU image, and
both are per-series CPU solvers — so these are re-implemented natively on
numpy least squares (closed-form, no iterative MLE):

- ``ARIMAForecaster(p, d, q)``: d-fold differencing + Hannan–Rissanen
  two-stage ARMA estimation (long-AR residual proxy, then lstsq on AR+MA
  lags), recursive forecasting, inverse differencing. Matches the
  reference's fit(series) → predict(horizon) usage.
- ``ProphetForecaster``: additive model = piecewise-linear trend
  (changepoints at quantiles, ridge-penalized slope deltas — Prophet's
  core construction) + Fourier seasonality blocks (yearly/weekly/daily)
  solved in ONE lstsq. fit takes the same ``(ds, y)`` DataFrame as the
  reference; predict returns a ``yhat`` DataFrame.

Same Forecaster surface (fit/predict/evaluate/save/restore) as the neural
forecasters in zouwu/model/forecast.py.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


class ARIMAForecaster:
    """ARIMA(p, d, q) via CSS/Hannan–Rissanen (ref zouwu arima.py wrapper).

    fit on a 1-D series; predict rolls the model ``horizon`` steps ahead.
    """

    def __init__(self, p: int = 2, d: int = 0, q: int = 2, seed: int = 0):
        if min(p, d, q) < 0 or p + q == 0:
            raise ValueError("need p,d,q >= 0 and p+q > 0")
        self.p, self.d, self.q = int(p), int(d), int(q)
        self._coef = None       # [mu, phi_1..p, theta_1..q]
        self._resid_tail: Optional[np.ndarray] = None
        self._series_tail: Optional[np.ndarray] = None
        self._last_values: Optional[np.ndarray] = None

    # ------------------------------------------------------------ internals
    @staticmethod
    def _difference(y: np.ndarray, d: int):
        """Returns (d-times differenced series, tails) where tails[k] is
        the LAST value of the k-times differenced series — exactly the
        anchors inverse differencing needs (y_k[t+1] = y_k[t] +
        y_{k+1}[t+1])."""
        tails: List[float] = []
        for _ in range(d):
            tails.append(float(y[-1]))
            y = np.diff(y)
        return y, tails

    def _design(self, z: np.ndarray, resid: np.ndarray):
        p, q = self.p, self.q
        m = max(p, q)
        n = len(z) - m
        cols = [np.ones(n)]
        for i in range(1, p + 1):
            cols.append(z[m - i:m - i + n])
        for j in range(1, q + 1):
            cols.append(resid[m - j:m - j + n])
        return np.stack(cols, 1), z[m:m + n]

    def fit(self, y: np.ndarray, validation_data=None, **kwargs):
        y = np.asarray(y, np.float64).reshape(-1)
        if len(y) < max(self.p, self.q) + self.d + 10:
            raise ValueError(
                f"series too short ({len(y)}) for ARIMA"
                f"({self.p},{self.d},{self.q})")
        z, self._tails = self._difference(y, self.d)

        # stage 1: long AR to proxy the innovations
        k = min(max(self.p + self.q + 5, 10), len(z) // 2)
        Xar = np.stack([np.ones(len(z) - k)]
                       + [z[k - i:len(z) - i] for i in range(1, k + 1)], 1)
        beta, *_ = np.linalg.lstsq(Xar, z[k:], rcond=None)
        resid_long = z[k:] - Xar @ beta
        resid = np.concatenate([np.zeros(k), resid_long])

        # stage 2: regression on p AR lags + q MA (residual) lags
        X, target = self._design(z, resid)
        coef, *_ = np.linalg.lstsq(X, target, rcond=None)
        self._coef = coef
        fitted = X @ coef
        final_resid = np.concatenate(
            [np.zeros(max(self.p, self.q)), target - fitted])
        m = max(self.p, self.q, 1)
        self._resid_tail = final_resid[-m:]
        self._series_tail = z[-m:]
        self._last_values = y.copy()
        return self

    def predict(self, horizon: int = 1, **kwargs) -> np.ndarray:
        if self._coef is None:
            raise RuntimeError("fit before predict")
        p, q = self.p, self.q
        z = list(self._series_tail)
        resid = list(self._resid_tail)
        mu = self._coef[0]
        phi = self._coef[1:1 + p]
        theta = self._coef[1 + p:1 + p + q]
        out = []
        for _ in range(horizon):
            val = mu
            for i in range(p):
                val += phi[i] * z[-1 - i]
            for j in range(q):
                val += theta[j] * resid[-1 - j]
            z.append(val)
            resid.append(0.0)  # expected future innovation
            out.append(val)
        out = np.asarray(out)
        # invert the d differencings, innermost level first: the forecast
        # of the k-times-differenced series is cumsum of level k+1 anchored
        # on that level's last observed value
        for tail in reversed(self._tails):
            out = np.cumsum(out) + tail
        return out

    def evaluate(self, y_true: np.ndarray, metrics=("mse",)) -> Dict:
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        pred = self.predict(len(np.asarray(y_true).reshape(-1)))
        return {m: Evaluator.evaluate(m, np.asarray(y_true).reshape(-1),
                                      pred) for m in metrics}

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "arima.npz"),
                 coef=self._coef, resid_tail=self._resid_tail,
                 series_tail=self._series_tail,
                 last_values=self._last_values,
                 tails=np.asarray(self._tails),
                 pdq=np.array([self.p, self.d, self.q]))
        return path

    def restore(self, path: str):
        blob = np.load(os.path.join(path, "arima.npz"))
        self.p, self.d, self.q = (int(v) for v in blob["pdq"])
        self._coef = blob["coef"]
        self._resid_tail = blob["resid_tail"]
        self._series_tail = blob["series_tail"]
        self._last_values = blob["last_values"]
        self._tails = list(blob["tails"])
        return self


class ProphetForecaster:
    """Additive trend+seasonality model (ref zouwu prophet.py wrapper).

    ``fit(df)`` takes the Prophet input frame: columns ``ds`` (datetime)
    and ``y``. ``predict(horizon, freq)`` returns a DataFrame with ``ds``
    and ``yhat`` — the reference forecaster's shape.
    """

    def __init__(self, n_changepoints: int = 10,
                 changepoint_prior_scale: float = 0.05,
                 yearly_seasonality="auto", weekly_seasonality="auto",
                 daily_seasonality="auto", seasonality_order: int = 5):
        self.n_changepoints = int(n_changepoints)
        self.cp_penalty = 1.0 / max(changepoint_prior_scale, 1e-6)
        self.yearly = yearly_seasonality
        self.weekly = weekly_seasonality
        self.daily = daily_seasonality
        self.order = int(seasonality_order)
        self._beta = None

    # ------------------------------------------------------------ features
    def _seasonal_blocks(self, span_seconds: float) -> List[float]:
        periods = []
        for flag, period, need in (
                (self.yearly, 365.25 * 86400, 2 * 365.25 * 86400),
                (self.weekly, 7 * 86400, 2 * 7 * 86400),
                (self.daily, 86400, 2 * 86400)):
            on = (flag is True) or (flag == "auto" and span_seconds >= need)
            if on:
                periods.append(period)
        return periods

    def _features(self, t: np.ndarray) -> np.ndarray:
        """t: seconds since t0. Columns: 1, t, relu(t - cp_i)..., fourier."""
        cols = [np.ones_like(t), t / self._scale]
        for cp in self._changepoints:
            cols.append(np.maximum(t - cp, 0.0) / self._scale)
        for period in self._periods:
            for k in range(1, self.order + 1):
                ang = 2 * np.pi * k * t / period
                cols.append(np.sin(ang))
                cols.append(np.cos(ang))
        return np.stack(cols, 1)

    def fit(self, df, validation_data=None, **kwargs):
        import pandas as pd
        ds = pd.to_datetime(df["ds"])
        y = np.asarray(df["y"], np.float64)
        t = (ds - ds.iloc[0]).dt.total_seconds().to_numpy()
        self._t0 = ds.iloc[0]
        self._t_max = float(t[-1])
        self._scale = max(self._t_max, 1.0)
        span = float(t[-1] - t[0])
        self._periods = self._seasonal_blocks(span)
        # changepoints at quantiles of the first 80% (Prophet's default)
        qs = np.linspace(0, 0.8, self.n_changepoints + 2)[1:-1]
        self._changepoints = np.quantile(t, qs) if self.n_changepoints \
            else np.array([])
        X = self._features(t)
        # ridge only on the changepoint slope deltas (Prophet's laplace
        # prior analog); trend/seasonality unpenalized
        n_cp = len(self._changepoints)
        penalty = np.zeros(X.shape[1])
        penalty[2:2 + n_cp] = self.cp_penalty
        A = X.T @ X + np.diag(penalty)
        b = X.T @ y
        self._beta = np.linalg.solve(A, b)
        self._y_last = y
        return self

    def predict(self, horizon: int = 1, freq: str = "D", **kwargs):
        import pandas as pd
        if self._beta is None:
            raise RuntimeError("fit before predict")
        # date_range handles calendar frequencies ('M', 'Y', ...) that have
        # no fixed timedelta
        last = self._t0 + pd.to_timedelta(self._t_max, unit="s")
        ds = pd.date_range(start=last, periods=horizon + 1, freq=freq)[1:]
        t = (ds - self._t0).total_seconds().to_numpy()
        yhat = self._features(t) @ self._beta
        return pd.DataFrame({"ds": ds, "yhat": yhat})

    def evaluate(self, target_df, metrics=("mse",)) -> Dict:
        import pandas as pd
        from analytics_zoo_tpu_torch.automl.metrics import Evaluator
        ds = pd.to_datetime(target_df["ds"])
        t = (ds - self._t0).dt.total_seconds().to_numpy()
        yhat = self._features(t) @ self._beta
        y = np.asarray(target_df["y"], np.float64)
        return {m: Evaluator.evaluate(m, y, yhat) for m in metrics}

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "prophet.npz"),
                 beta=self._beta, changepoints=self._changepoints,
                 periods=np.asarray(self._periods),
                 meta=np.array([self._t_max, self._scale, self.order]))
        with open(os.path.join(path, "prophet_t0.json"), "w") as f:
            json.dump({"t0": str(self._t0)}, f)
        return path

    def restore(self, path: str):
        import pandas as pd
        blob = np.load(os.path.join(path, "prophet.npz"))
        self._beta = blob["beta"]
        self._changepoints = blob["changepoints"]
        self._periods = list(blob["periods"])
        self._t_max, self._scale, order = blob["meta"]
        self.order = int(order)
        with open(os.path.join(path, "prophet_t0.json")) as f:
            self._t0 = pd.Timestamp(json.load(f)["t0"])
        return self
