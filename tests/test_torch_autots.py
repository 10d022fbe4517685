"""AutoTS in the port against the JAX package's, on the CPU (mirrors
JAX's tests/test_autots.py and test_zouwu.py's TestFeatureTransformer).

- Every recipe's search space draws JAX's configs bit for bit from the
  same seed (with and without the feature-selection axis).
- ``TimeSequenceFeatureTransformer``: ``fit_transform``, ``transform``
  (with and without labels), ``unscale_y``, extra and selected features
  give JAX's arrays bit for bit; a transformer saved by either package
  restores in the other.
- One trial's ``fit_eval`` (``_TSTrialModel``: the transformer and the
  forecaster) for VanillaLSTM, TCN, Seq2Seq and MTNet, dropout 0, from
  JAX's initial weights: the metric within 1e-5 relative over two epochs
  (measured 1.6e-7 at worst).
- A ``TSPipeline`` saved by JAX loads in the port and predicts within
  1e-5 of JAX, and the reverse (measured 3.6e-7 at worst).
- JAX's AutoTS tests mirrored (``device="cpu"``), and ``AutoTSTrainer``
  raises without CUDA unless ``device="cpu"``.

JAX is imported by fixtures only.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from analytics_zoo_tpu_torch.automl import hp
from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.zouwu.autots import AutoTSTrainer, TSPipeline
from analytics_zoo_tpu_torch.zouwu.autots.forecast import _TSModelBuilder
from analytics_zoo_tpu_torch.zouwu.config import (
    BayesRecipe, GridRandomRecipe, LSTMGridRandomRecipe,
    LSTMSeq2SeqRandomRecipe, MTNetGridRandomRecipe, MTNetSmokeRecipe,
    PastSeqParamHandler, RandomRecipe, Seq2SeqRandomRecipe, SmokeRecipe,
    TCNGridRandomRecipe, TCNSmokeRecipe, XgbRegressorGridRandomRecipe,
    XgbRegressorSkOptRecipe,
)
from analytics_zoo_tpu_torch.zouwu.feature import (
    TimeSequenceFeatureTransformer,
)

RECIPES = ["SmokeRecipe", "MTNetSmokeRecipe", "TCNSmokeRecipe",
           "GridRandomRecipe", "LSTMGridRandomRecipe",
           "LSTMSeq2SeqRandomRecipe", "TCNGridRandomRecipe",
           "Seq2SeqRandomRecipe", "MTNetGridRandomRecipe", "RandomRecipe",
           "BayesRecipe", "XgbRegressorGridRandomRecipe",
           "XgbRegressorSkOptRecipe"]


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
    from analytics_zoo_tpu.automl import hp as jhp
    from analytics_zoo_tpu.zouwu import autots
    from analytics_zoo_tpu.zouwu import config as jconfig
    from analytics_zoo_tpu.zouwu.autots import forecast as jforecast
    from analytics_zoo_tpu.zouwu.feature import (
        TimeSequenceFeatureTransformer as JTF)
    return dict(jax=jax, hp=jhp, config=jconfig, autots=autots,
                forecast=jforecast, TF=JTF)


def sine_df(n=240, extra=False):
    t = pd.date_range("2024-01-01", periods=n, freq="h")
    rng = np.random.RandomState(0)
    v = np.sin(np.arange(n) * 2 * np.pi / 24) + rng.normal(0, 0.05, n)
    df = pd.DataFrame({"datetime": t, "value": v})
    if extra:
        df["extra"] = np.cos(np.arange(n) / 5.0)
    return df


# --------------------------------------------------------------- recipes

@pytest.mark.parametrize("name", RECIPES)
@pytest.mark.parametrize("features", [None, ["HOUR", "DAY", "IS_WEEKEND"]])
def test_recipe_configs_match_jax_bitwise(jx, name, features):
    import analytics_zoo_tpu_torch.zouwu.config as pconfig
    mine = getattr(pconfig, name)().search_space(features)
    theirs = getattr(jx["config"], name)().search_space(features)
    assert getattr(pconfig, name)().runtime_params() == \
        getattr(jx["config"], name)().runtime_params()
    assert hp.grid_points(mine) == jx["hp"].grid_points(theirs)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for gp in hp.grid_points(mine) * 8:
        assert hp.sample_config(mine, a, gp) == \
            jx["hp"].sample_config(theirs, b, gp)


class TestRecipes:
    def test_search_spaces_materialize(self):
        rng = np.random.default_rng(0)
        for recipe in [SmokeRecipe(), MTNetSmokeRecipe(), TCNSmokeRecipe(),
                       GridRandomRecipe(), LSTMGridRandomRecipe(),
                       LSTMSeq2SeqRandomRecipe(), TCNGridRandomRecipe(),
                       Seq2SeqRandomRecipe(), MTNetGridRandomRecipe(),
                       RandomRecipe(), BayesRecipe()]:
            space = recipe.search_space()
            for gp in hp.grid_points(space):
                assert "model" in hp.sample_config(space, rng, gp)
            rt = recipe.runtime_params()
            assert rt["n_sampling"] >= 1 and rt["epochs"] >= 1
        for recipe in [XgbRegressorGridRandomRecipe(),
                       XgbRegressorSkOptRecipe()]:
            space = recipe.search_space()
            for gp in hp.grid_points(space):
                cfg = hp.sample_config(space, rng, gp)
                assert "n_estimators" in cfg and "max_depth" in cfg

    def test_bayes_recipe_declares_search_alg(self):
        assert BayesRecipe().runtime_params()["search_alg"] == "bayes"
        assert XgbRegressorSkOptRecipe().runtime_params()["search_alg"] == \
            "bayes"

    def test_look_back_range(self):
        s = LSTMGridRandomRecipe(look_back=(10, 20)).search_space()
        rng = np.random.default_rng(0)
        for _ in range(20):
            assert 10 <= s["past_seq_len"].sample(rng) <= 20
        with pytest.raises(ValueError):
            PastSeqParamHandler.get_past_seq_config((20, 10))


# ----------------------------------------------------------- transformer

TF_CASES = {
    "default": dict(past_seq_len=24, future_seq_len=3),
    "extra_no_dt": dict(past_seq_len=8, extra_features_col=["extra"],
                        with_dt_features=False),
    "selected": dict(past_seq_len=8, extra_features_col=["extra"],
                     selected_features=["HOUR", "IS_WEEKEND"]),
    "unscaled": dict(past_seq_len=10, scale=False),
}


@pytest.mark.parametrize("case", sorted(TF_CASES))
def test_transformer_matches_jax_bitwise(jx, tmp_path, case):
    kw = TF_CASES[case]
    train, test = sine_df(200, extra=True), sine_df(90, extra=True)
    mine, theirs = TimeSequenceFeatureTransformer(**kw), jx["TF"](**kw)
    for a, b in zip(mine.fit_transform(train), theirs.fit_transform(train)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(mine.transform(test), theirs.transform(test)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.transform(test, with_y=False),
                                  theirs.transform(test, with_y=False))
    y = mine.transform(test)[1]
    np.testing.assert_array_equal(mine.unscale_y(y), theirs.unscale_y(y))
    assert mine.feature_names == theirs.feature_names
    # saved by one package, restored by the other
    mine.save(str(tmp_path / "p"))
    theirs.save(str(tmp_path / "j"))
    back, fwd = jx["TF"](), TimeSequenceFeatureTransformer()
    back.restore(str(tmp_path / "p"))
    fwd.restore(str(tmp_path / "j"))
    np.testing.assert_array_equal(back.transform(test, with_y=False),
                                  fwd.transform(test, with_y=False))


class TestFeatureTransformer:
    def test_fit_transform_shapes(self):
        tf = TimeSequenceFeatureTransformer(past_seq_len=24, future_seq_len=3)
        x, y = tf.fit_transform(sine_df(200))
        assert x.shape == (200 - 24 - 3 + 1, 24, tf.n_features)
        assert y.shape == (174, 3) and x.dtype == np.float32

    def test_scaling_and_unscale(self):
        tf = TimeSequenceFeatureTransformer(past_seq_len=10)
        df = sine_df(200)
        x, y = tf.fit_transform(df)
        assert x[..., 0].min() >= 0.0 and x[..., 0].max() <= 1.0
        assert tf.unscale_y(y).min() >= df["value"].min() - 1e-4

    def test_transform_uses_train_scale(self):
        tf = TimeSequenceFeatureTransformer(past_seq_len=10)
        tf.fit_transform(sine_df(150))
        x, y = tf.transform(sine_df(60))
        x_only = tf.transform(sine_df(60), with_y=False)
        assert x_only.shape[0] == x.shape[0] + tf.future_seq_len

    def test_selected_features_validation_and_restore(self, tmp_path):
        with pytest.raises(ValueError, match="unknown selected_features"):
            TimeSequenceFeatureTransformer(selected_features=["NOPE"])
        tf = TimeSequenceFeatureTransformer(past_seq_len=8,
                                            selected_features=["HOUR"])
        tf.fit_transform(sine_df(200))
        tf.save(str(tmp_path / "tf"))
        tf2 = TimeSequenceFeatureTransformer()
        tf2.restore(str(tmp_path / "tf"))
        assert tf2.selected_features == ["HOUR"]
        assert tf2.transform(sine_df(40), with_y=False).shape[-1] == 2


# ------------------------------------------------- one trial against JAX

TRIALS = {
    "VanillaLSTM": {"model": "VanillaLSTM", "past_seq_len": 12,
                    "lstm_units": (8, 8), "dropouts": (0.0, 0.0),
                    "lr": 1e-2, "batch_size": 32},
    "TCN": {"model": "TCN", "past_seq_len": 12, "num_channels": (8, 8),
            "kernel_size": 3, "lr": 1e-2, "batch_size": 32},
    "Seq2Seq": {"model": "Seq2Seq", "past_seq_len": 12, "latent_dim": 8,
                "dropout": 0.0, "lr": 1e-2, "batch_size": 32},
    "MTNet": {"model": "MTNet", "long_series_num": 2, "series_length": 4,
              "ar_window": 2, "lr": 1e-2, "batch_size": 32},
}


def _no_dropout(forecaster):
    """TCN and MTNet trials keep their forecasters' dropout (the recipes
    do not set it): take it out in both packages alike."""
    if hasattr(forecaster, "kw"):
        forecaster.kw["cnn_dropout"] = 0.0
    elif hasattr(forecaster, "num_channels"):
        forecaster.dropout = 0.0


@pytest.mark.parametrize("model", sorted(TRIALS))
def test_trial_fit_eval_matches_jax(jx, orca_ctx, model):
    cfg = TRIALS[model]
    df = sine_df(200)
    train, val = df.iloc[:160], df.iloc[140:]
    jm = jx["forecast"]._TSModelBuilder("datetime", "value", None,
                                        2).build(cfg)
    pm = _TSModelBuilder("datetime", "value", None, 2,
                         device="cpu").build(cfg)
    for m in (jm, pm):
        _no_dropout(m.forecaster)
        m._train_xy = m.transformer.fit_transform(train)
    x = jm._train_xy[0]
    np.testing.assert_array_equal(pm._train_xy[0], x)
    jm.forecaster._ensure_est(x)
    pm.forecaster._ensure_est(x).model.load_state_dict(flax_to_state_dict(
        jx["jax"].device_get(jm.forecaster._est.adapter.params)))
    for _ in range(2):
        got = pm.fit_eval(train, val, epochs=1, metric="mse")
        want = jm.fit_eval(train, val, epochs=1, metric="mse")
        assert got == pytest.approx(want, rel=1e-5)


# -------------------------------------------- pipelines across packages

def test_pipeline_crosses_packages(jx, tmp_path, orca_ctx):
    df = sine_df(200)
    train, val = df.iloc[:160], df.iloc[140:]
    jtrainer = jx["autots"].AutoTSTrainer(horizon=2,
                                          logs_dir=str(tmp_path / "jl"))
    jts = jtrainer.fit(train, val, recipe=jx["config"].TCNSmokeRecipe())
    jts.save(str(tmp_path / "jpipe"))
    mine = TSPipeline.load(str(tmp_path / "jpipe"), device="cpu")
    np.testing.assert_allclose(mine.predict(val), jts.predict(val),
                               rtol=0, atol=1e-5)
    assert mine.config == {k: list(v) if isinstance(v, tuple) else v
                           for k, v in jts.config.items()}
    trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path / "pl"),
                            device="cpu")
    ts = trainer.fit(train, val, recipe=SmokeRecipe())
    ts.save(str(tmp_path / "ppipe"))
    theirs = jx["autots"].TSPipeline.load(str(tmp_path / "ppipe"))
    np.testing.assert_allclose(theirs.predict(val), ts.predict(val),
                               rtol=0, atol=1e-5)


# ------------------------------------------------------ JAX's mirrors

class TestAutoTS:
    def test_smoke_fit_predict_evaluate(self, tmp_path):
        df = sine_df()
        train, val = df.iloc[:200], df.iloc[180:]
        trainer = AutoTSTrainer(dt_col="datetime", target_col="value",
                                horizon=3, logs_dir=str(tmp_path),
                                device="cpu")
        ts = trainer.fit(train, val, recipe=SmokeRecipe(), metric="mse")
        assert isinstance(ts, TSPipeline)
        pred = ts.predict(val)
        assert pred.ndim == 2 and pred.shape[1] == 3
        res = ts.evaluate(val, metrics=["mse", "smape"])
        assert set(res) == {"mse", "smape"} and np.isfinite(res["mse"])

    def test_pipeline_save_load_roundtrip(self, tmp_path):
        df = sine_df()
        train, val = df.iloc[:200], df.iloc[180:]
        trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path / "logs"),
                                device="cpu")
        ts = trainer.fit(train, val, recipe=SmokeRecipe())
        ts.save(str(tmp_path / "pipe"))
        ts2 = TSPipeline.load(str(tmp_path / "pipe"), device="cpu")
        np.testing.assert_array_equal(ts.predict(val), ts2.predict(val))
        assert ts2.config["model"] == "VanillaLSTM"

    def test_pipeline_incremental_fit(self, tmp_path):
        df = sine_df()
        train, val = df.iloc[:200], df.iloc[180:]
        trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path),
                                device="cpu")
        ts = trainer.fit(train, val, recipe=SmokeRecipe())
        before = ts.evaluate(val, metrics=["mse"])["mse"]
        ts.fit(train, epochs=3)
        after = ts.evaluate(val, metrics=["mse"])["mse"]
        assert np.isfinite(after) and after <= before * 2.0

    def test_tcn_recipe_search_and_features(self, tmp_path):
        df = sine_df(160)
        train, val = df.iloc[:120], df.iloc[100:]
        trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path),
                                device="cpu")
        recipe = TCNGridRandomRecipe(num_rand_samples=1, epochs=1,
                                     look_back=12)
        assert "selected_features" in recipe.search_space(
            ["HOUR", "DAY", "IS_WEEKEND"])
        ts = trainer.fit(train, val, recipe=recipe)
        assert ts.config["model"] == "TCN"
        assert len(trainer.engine.trials) == 2
        sel = ts.config.get("selected_features")
        assert sel and set(sel) <= {"HOUR", "DAY", "DAYOFWEEK", "MONTH",
                                    "IS_WEEKEND"}
        assert ts.predict(val).shape[1] == 2
        ts.save(str(tmp_path / "pipe"))
        ts2 = TSPipeline.load(str(tmp_path / "pipe"), device="cpu")
        np.testing.assert_array_equal(ts.predict(val), ts2.predict(val))

    def test_bayes_and_mtnet_recipes(self, tmp_path):
        df = sine_df(160)
        train, val = df.iloc[:120], df.iloc[100:]
        trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path),
                                name="bayes", device="cpu")
        ts = trainer.fit(train, val, recipe=BayesRecipe(
            num_samples=2, epochs=1, look_back=12))
        assert ts.config["model"] == "TCN"
        assert ts.predict(val).shape[1] == 2
        trainer = AutoTSTrainer(horizon=2, logs_dir=str(tmp_path),
                                name="mtnet", device="cpu")
        ts = trainer.fit(train, val, recipe=MTNetSmokeRecipe())
        assert ts.config["model"] == "MTNet"
        assert ts.predict(val).shape[1] == 2

    def test_needs_cuda_or_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device resolves")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            AutoTSTrainer()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TSPipeline.load("unused")


class TestTimeSequencePredictor:
    def test_fit_predict_evaluate(self, tmp_path):
        from analytics_zoo_tpu_torch.zouwu.regression import (
            TimeSequencePredictor)
        df = sine_df(200)
        df.loc[5, "value"] = np.nan          # drop_missing path
        train, val = df.iloc[:160], df.iloc[140:].dropna()
        tsp = TimeSequencePredictor(logs_dir=str(tmp_path),
                                    future_seq_len=2, target_col=["value"],
                                    device="cpu")
        pipe = tsp.fit(train, val, recipe=SmokeRecipe())
        assert isinstance(pipe, TSPipeline)
        assert tsp.predict(val).shape[1] == 2
        res = tsp.evaluate(val, metric=["mse", "smape"])
        assert set(res) == {"mse", "smape"}
        with pytest.raises(ValueError, match="single target_col"):
            TimeSequencePredictor(target_col=["a", "b"])

    def test_predict_before_fit_raises(self, tmp_path):
        from analytics_zoo_tpu_torch.zouwu.regression import (
            TimeSequencePredictor)
        with pytest.raises(RuntimeError, match="fit first"):
            TimeSequencePredictor(logs_dir=str(tmp_path)).predict(
                sine_df(40))

    def test_search_alg_override_does_not_mutate_recipe(self, tmp_path):
        from analytics_zoo_tpu_torch.zouwu.regression import (
            TimeSequencePredictor)
        recipe = SmokeRecipe()
        tsp = TimeSequencePredictor(logs_dir=str(tmp_path),
                                    search_alg="bayes", device="cpu")
        tsp.fit(sine_df(120), recipe=recipe)
        assert recipe.search_alg is None


def test_time_sequence_pipeline_alias(tmp_path):
    from analytics_zoo_tpu_torch.zouwu.pipeline import (TimeSequencePipeline,
                                                        load_ts_pipeline)
    assert TimeSequencePipeline is TSPipeline
    trainer = AutoTSTrainer(horizon=1, logs_dir=str(tmp_path), device="cpu")
    df = sine_df(120)
    ts = trainer.fit(df.iloc[:100], df.iloc[90:], recipe=SmokeRecipe())
    ts.save(str(tmp_path / "p"))
    restored = load_ts_pipeline(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(ts.predict(df.iloc[90:]),
                                  restored.predict(df.iloc[90:]))
