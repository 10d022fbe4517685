"""Zouwu's anomaly detectors and statistical forecasters in the port
against the JAX package's, on the CPU (mirrors JAX's test_zouwu.py
TestAnomaly and tests/test_stats_forecast.py).

- ``ThresholdDetector``, ``ARIMAForecaster`` and ``ProphetForecaster``
  are host numpy copies: thresholds, scores, coefficients and forecasts
  equal JAX's bit for bit, and saved models cross packages.
- ``AEDetector`` from JAX's initial weights (carried with ``convert``):
  after the same training its per-step scores are within 1e-5 of JAX's
  (measured 1.5e-7) and the anomaly indexes are equal.
- ``DBScanDetector`` gives JAX's indexes; without scikit-learn it raises
  ``ModuleNotFoundError`` naming it.
- ``AEDetector`` raises without CUDA unless ``device="cpu"``.

JAX is imported by fixtures only.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu_torch.convert import flax_layout, flax_to_state_dict
from analytics_zoo_tpu_torch.zouwu.model import (ARIMAForecaster,
                                                 ProphetForecaster)
from analytics_zoo_tpu_torch.zouwu.model.anomaly import (AEDetector,
                                                         DBScanDetector,
                                                         ThresholdDetector)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "tb"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.learn.estimator import Estimator
    from analytics_zoo_tpu.zouwu.model import anomaly, stats_forecast
    return dict(jax=jax, Estimator=Estimator, anomaly=anomaly,
                stats=stats_forecast)


def _ar_series(n=400, phi=0.7, seed=0):
    rng = np.random.RandomState(seed)
    y = np.zeros(n)
    for i in range(1, n):
        y[i] = phi * y[i - 1] + rng.randn() * 0.3
    return y


def _seasonal_df(n_days=120, seed=0):
    rng = np.random.RandomState(seed)
    ds = pd.date_range("2025-01-01", periods=n_days, freq="D")
    t = np.arange(n_days, dtype=float)
    y = 0.5 * t + 5 * np.sin(2 * np.pi * t / 7) + rng.randn(n_days) * 0.3
    return pd.DataFrame({"ds": ds, "y": y})


def _spiky(n=300):
    rng = np.random.RandomState(0)
    y = np.sin(np.arange(n) * 2 * np.pi / 24) + rng.normal(0, 0.02, n)
    y[150:153] += 6.0
    return y


# --------------------------------------------------------- anomaly

@pytest.mark.parametrize("kw", [dict(ratio=4.0),
                                dict(mode="percentile", ratio=99.0)])
def test_threshold_detector_matches_jax_bitwise(jx, kw):
    rng = np.random.RandomState(0)
    y = rng.normal(0, 1, 500)
    y[[50, 300]] += 12.0
    pred = y + rng.normal(0, 0.1, 500)
    for args in ((y,), (y, pred)):
        mine = ThresholdDetector(**kw).fit(*args)
        theirs = jx["anomaly"].ThresholdDetector(**kw).fit(*args)
        assert mine.threshold == theirs.threshold
        np.testing.assert_array_equal(mine.score(*args), theirs.score(*args))
        np.testing.assert_array_equal(mine.anomaly_indexes(*args),
                                      theirs.anomaly_indexes(*args))


def test_ae_detector_matches_jax_from_its_weights(jx, monkeypatch):
    y = _spiky()
    kw = dict(roll_len=12, hidden=(8, 4), anomaly_ratio=0.03, epochs=4)
    start = {}
    made = jx["Estimator"].from_flax

    def capture(**a):
        est = made(**a)
        start["params"] = jx["jax"].device_get(est.adapter.params)
        return est

    monkeypatch.setattr(jx["Estimator"], "from_flax", staticmethod(capture))
    theirs = jx["anomaly"].AEDetector(**kw).fit(y)
    mine = AEDetector(device="cpu", **kw)
    model = mine.build()
    assert jx["jax"].tree_util.tree_map(
        lambda a: tuple(a.shape), flax_layout(model)) == \
        jx["jax"].tree_util.tree_map(lambda a: tuple(a.shape),
                                     start["params"])
    model.load_state_dict(flax_to_state_dict(start["params"]))
    mine.fit(y, model=model)
    np.testing.assert_allclose(mine.score(y), theirs.score(y), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(mine.anomaly_indexes(y),
                                  theirs.anomaly_indexes(y))


class TestAnomaly:
    def test_threshold_detector(self):
        rng = np.random.RandomState(0)
        y = rng.normal(0, 1, 500)
        y[[50, 300]] += 12.0
        idx = ThresholdDetector(ratio=4.0).fit(y).anomaly_indexes(y)
        assert {50, 300} <= set(idx.tolist())

    def test_threshold_with_forecast(self):
        y, y_pred = np.zeros(100), np.zeros(100)
        y[10] = 5.0
        det = ThresholdDetector(threshold=1.0)
        assert det.anomaly_indexes(y, y_pred).tolist() == [10]
        with pytest.raises(ValueError, match="mode"):
            ThresholdDetector(mode="nope")

    def test_ae_detector(self):
        det = AEDetector(roll_len=12, hidden=(8, 4), anomaly_ratio=0.03,
                         epochs=4, device="cpu")
        y = _spiky()
        det.fit(y)
        assert any(148 <= i <= 155 for i in det.anomaly_indexes(y))

    def test_ae_needs_cuda_or_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device resolves")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            AEDetector()

    def test_dbscan_detector(self, jx):
        pytest.importorskip("sklearn")
        y = np.concatenate([np.zeros(100), [10.0], np.zeros(100)])
        idx = DBScanDetector(eps=0.5, min_samples=3).anomaly_indexes(y)
        assert 100 in idx
        np.testing.assert_array_equal(
            idx, jx["anomaly"].DBScanDetector(eps=0.5, min_samples=3)
            .anomaly_indexes(y))

    def test_dbscan_names_scikit_learn_where_absent(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
        with pytest.raises(ModuleNotFoundError, match="scikit-learn"):
            DBScanDetector().anomaly_indexes(np.zeros(10))


# ------------------------------------------------ ARIMA and Prophet

@pytest.mark.parametrize("pdq", [(1, 0, 0), (2, 0, 1), (1, 1, 1), (1, 2, 0)])
def test_arima_matches_jax_bitwise(jx, tmp_path, pdq):
    t = np.arange(300, dtype=float)
    y = 0.01 * t ** 2 * (pdq[1] == 2) + 2.0 * t * (pdq[1] == 1) + \
        _ar_series(300, seed=1)
    mine = ARIMAForecaster(*pdq).fit(y)
    theirs = jx["stats"].ARIMAForecaster(*pdq).fit(y)
    np.testing.assert_array_equal(mine._coef, theirs._coef)
    np.testing.assert_array_equal(mine.predict(12), theirs.predict(12))
    assert mine.evaluate(y[:10]) == theirs.evaluate(y[:10])
    theirs.save(str(tmp_path / "j"))
    np.testing.assert_array_equal(
        ARIMAForecaster().restore(str(tmp_path / "j")).predict(12),
        theirs.predict(12))


@pytest.mark.parametrize("kw,freq", [
    (dict(daily_seasonality=False), "D"),
    (dict(daily_seasonality=False, weekly_seasonality=False), "MS"),
    (dict(n_changepoints=4, seasonality_order=3, daily_seasonality=False),
     "D")])
def test_prophet_matches_jax_bitwise(jx, tmp_path, kw, freq):
    df = _seasonal_df(200)
    mine = ProphetForecaster(**kw).fit(df)
    theirs = jx["stats"].ProphetForecaster(**kw).fit(df)
    np.testing.assert_array_equal(mine._beta, theirs._beta)
    a, b = mine.predict(14, freq=freq), theirs.predict(14, freq=freq)
    np.testing.assert_array_equal(a["yhat"].to_numpy(), b["yhat"].to_numpy())
    assert (a["ds"] == b["ds"]).all()
    assert mine.evaluate(df) == theirs.evaluate(df)
    mine.save(str(tmp_path / "p"))
    back = jx["stats"].ProphetForecaster().restore(str(tmp_path / "p"))
    np.testing.assert_array_equal(back.predict(7, freq=freq)["yhat"],
                                  mine.predict(7, freq=freq)["yhat"])


class TestARIMA:
    def test_ar1_coefficient_recovered(self):
        f = ARIMAForecaster(p=1, d=0, q=0).fit(_ar_series())
        assert abs(f._coef[1] - 0.7) < 0.12

    def test_forecast_decays_to_mean(self):
        pred = ARIMAForecaster(p=1, d=0, q=0).fit(_ar_series()).predict(50)
        assert pred.shape == (50,)
        assert abs(pred[-1]) < abs(pred[0]) + 0.1

    def test_trend_with_differencing(self):
        t = np.arange(300, dtype=float)
        y = 2.0 * t + _ar_series(300, phi=0.3, seed=1)
        pred = ARIMAForecaster(p=1, d=1, q=1).fit(y).predict(10)
        assert pred[-1] > y[-1] + 10
        assert abs((pred[-1] - pred[0]) / 9 - 2.0) < 0.5

    def test_double_differencing_quadratic(self):
        t = np.arange(200, dtype=float)
        pred = ARIMAForecaster(p=1, d=2, q=0).fit(t ** 2).predict(5)
        want = np.arange(200, 205, dtype=float) ** 2
        assert (np.abs(pred - want) / want).max() < 0.02

    def test_save_restore(self, tmp_path):
        f = ARIMAForecaster(p=2, d=0, q=1).fit(_ar_series())
        f.save(str(tmp_path))
        np.testing.assert_array_equal(
            ARIMAForecaster().restore(str(tmp_path)).predict(5),
            f.predict(5))

    def test_too_short_and_bad_order_raise(self):
        with pytest.raises(ValueError, match="too short"):
            ARIMAForecaster(p=2, d=0, q=2).fit(np.ones(8))
        with pytest.raises(ValueError):
            ARIMAForecaster(p=0, d=0, q=0)


class TestProphet:
    def test_learns_trend_and_weekly_cycle(self):
        f = ProphetForecaster(daily_seasonality=False).fit(_seasonal_df())
        out = f.predict(horizon=14, freq="D")
        assert list(out.columns) == ["ds", "yhat"]
        t_future = np.arange(120, 134, dtype=float)
        want = 0.5 * t_future + 5 * np.sin(2 * np.pi * t_future / 7)
        assert np.abs(out["yhat"].to_numpy() - want).max() < 1.5

    def test_evaluate_in_sample(self):
        df = _seasonal_df()
        f = ProphetForecaster(daily_seasonality=False).fit(df)
        assert f.evaluate(df, metrics=("mse", "mae"))["mse"] < 0.5

    def test_monthly_frequency(self):
        f = ProphetForecaster(daily_seasonality=False,
                              weekly_seasonality=False).fit(_seasonal_df(200))
        out = f.predict(horizon=3, freq="MS")
        assert out["ds"].dt.day.tolist() == [1, 1, 1]

    def test_predict_before_fit_raises(self):
        with pytest.raises(RuntimeError):
            ProphetForecaster().predict(3)
