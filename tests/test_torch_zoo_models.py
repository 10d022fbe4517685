"""The port's Wide&Deep, SessionRecommender and AnomalyDetector against the
JAX package's, on the CPU.

Each model is built in both packages from the same parameters (the JAX
model's initial tree through ``convert.flax_to_state_dict``), compiled
alike and trained on the same numpy data in the same batch order, at a
small size:

- ``WideAndDeep`` (wide base (10, 10), cross (20,), indicator (4,), embed
  in (30, 40) out (8, 16): unequal widths, as bench.py's; 1 continuous;
  hidden (16, 8); 2 classes), each variant (``wide``, ``deep``,
  ``wide_n_deep``), batch 32, 4 steps an epoch, 2 epochs: ``fit``,
  ``evaluate`` and ``predict``;
- ``SessionRecommender`` (20 items, embed 8, GRUs (12, 8), session 5;
  with history: 6 items, MLP (10,)), batch 16, 4 steps an epoch, 2
  epochs: ``fit``, ``predict`` and ``recommend_for_session``;
- ``AnomalyDetector`` (windows of 8, LSTMs (8, 8), dropouts 0), batch 32,
  3 steps an epoch, 2 epochs: ``fit``, ``predict``, ``unroll`` and
  ``detect_anomalies``; with dropouts 0.2 by its properties (dropout's
  bits differ from JAX's).

Held as tests/test_torch_keras_train.py holds NCF: the loss of each epoch
within rtol 1e-5 (measured: 1.1e-7); after SGD every parameter within
atol 1e-6 (measured: 6.0e-8); after Adam within atol 1e-5 in all but 1%
of each leaf's elements and within 2 lr per step everywhere (measured:
7.6e-7 at most, no element past 1e-5); ``evaluate``'s loss rtol 1e-5;
``predict`` atol 1e-6 and the recommended items equal. Each model saved
by either package loads in the other and predicts within 1e-5 of the
saver. JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.learn.optimizers import SGD, Adam
from analytics_zoo_tpu_torch.models import (AnomalyDetector,
                                            ColumnFeatureInfo,
                                            SessionRecommender, WideAndDeep,
                                            registry)
from analytics_zoo_tpu_torch.models.common import ZooModel

LOSS = "sparse_categorical_crossentropy"
LR = {"adam": 1e-2, "sgd": 0.1}
COLUMNS = dict(
    wide_base_cols=["a", "b"], wide_base_dims=[10, 10],
    wide_cross_cols=["ab"], wide_cross_dims=[20],
    indicator_cols=["c"], indicator_dims=[4],
    embed_cols=["u", "i"], embed_in_dims=[30, 40], embed_out_dims=[8, 16],
    continuous_cols=["age"])
WND_ROWS = 128
ITEMS, SESSION, HISTORY = 20, 5, 6
SR_ARGS = dict(item_count=ITEMS, item_embed=8, rnn_hidden_layers=[12, 8],
               session_length=SESSION, mlp_hidden_layers=[10],
               history_length=HISTORY)
SR_ROWS = 64
AD_ARGS = dict(feature_shape=(8, 1), hidden_layers=(8, 8))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    # the port's summaries go to tmp_path, not ./zoo_tpu_logs
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jax_api():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models import anomalydetection, recommendation
    from analytics_zoo_tpu.models.common import ZooModel as JZooModel
    return dict(jax=jax, opt={"adam": JAdam, "sgd": JSGD},
                WideAndDeep=recommendation.WideAndDeep,
                ColumnFeatureInfo=recommendation.ColumnFeatureInfo,
                SessionRecommender=recommendation.SessionRecommender,
                AnomalyDetector=anomalydetection.AnomalyDetector,
                ZooModel=JZooModel)


# ------------------------------------------------------------------ models

def make(api, kind):
    """``kind``'s model from the package ``api`` names (the JAX fixture, or
    None for the port)."""
    get = (lambda name: api[name]) if api is not None else \
        (lambda name: globals()[name])
    if kind.startswith("wnd_"):
        info = get("ColumnFeatureInfo")(**COLUMNS)
        return get("WideAndDeep")(2, info, model_type=kind[4:],
                                  hidden_layers=(16, 8))
    if kind.startswith("session"):
        return get("SessionRecommender")(
            include_history=kind == "session_hist", **SR_ARGS)
    return get("AnomalyDetector")(dropouts=(0.0, 0.0), **AD_ARGS)


def wnd_data(variant, n, seed):
    rng = np.random.default_rng(seed)
    wide = np.zeros((n, 40), np.float32)
    wide[np.arange(n), rng.integers(0, 40, n)] = 1.0
    ind = np.zeros((n, 4), np.float32)
    ind[np.arange(n), rng.integers(0, 4, n)] = 1.0
    emb = np.stack([rng.integers(0, 31, n), rng.integers(0, 41, n)],
                   1).astype(np.float32)
    con = rng.normal(size=(n, 1)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    x = {"wide": wide, "deep": [ind, emb, con],
         "wide_n_deep": [wide, ind, emb, con]}[variant]
    return x, y


def session_data(history, n, seed):
    rng = np.random.default_rng(seed)
    xs = rng.integers(1, ITEMS + 1, (n, SESSION)).astype(np.float32)
    xh = rng.integers(1, ITEMS + 1, (n, HISTORY)).astype(np.float32)
    y = rng.integers(0, ITEMS, n).astype(np.int32)
    return ([xs, xh] if history else xs), y


def series(n=120):
    t = np.arange(n, dtype=np.float32)
    return (np.sin(t / 5) + 0.1 * np.cos(t / 3)).astype(np.float32)


def data(kind, n, seed):
    if kind.startswith("wnd_"):
        return wnd_data(kind[4:], n, seed)
    if kind.startswith("session"):
        return session_data(kind == "session_hist", n, seed)
    x, y = AnomalyDetector.unroll(series(n + 8), 8)
    return x, y


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_params(tnet, jparams, opt, lr, steps):
    got = dict(_leaves(state_dict_to_flax(tnet.module.state_dict(),
                                          jparams)))
    for path, want in _leaves(jparams):
        diff = np.abs(got[path] - want)
        if opt == "sgd":
            assert diff.max() <= 1e-6, (path, diff.max())
        else:
            assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
            assert diff.max() <= 2 * lr * steps, (path, diff.max())


def pair(jax_api, kind, opt, loss):
    """(JAX model, port model) compiled alike from the same parameters."""
    jm, tm = make(jax_api, kind), make(None, kind)
    jm.compile(optimizer=jax_api["opt"][opt](LR[opt]), loss=loss)
    tm.model.module.load_state_dict(flax_to_state_dict(
        jax_api["jax"].device_get(jm.model.get_weights())))
    tm.compile(optimizer=(Adam if opt == "adam" else SGD)(LR[opt]),
               loss=loss, device="cpu")
    return jm, tm


def fit_both(jax_api, jm, tm, x, y, batch, epochs, opt):
    want = jm.fit(x, y, batch_size=batch, nb_epoch=epochs)
    got = tm.fit(x, y, batch_size=batch, nb_epoch=epochs)
    assert len(got["loss"]) == epochs
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_params(tm.model, jax_api["jax"].device_get(jm.model.get_weights()),
                  opt, LR[opt], epochs * (len(y) // batch))


# -------------------------------------------------------------- Wide&Deep

@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("variant", ["wide", "deep", "wide_n_deep"])
def test_wide_and_deep_matches_jax(jax_api, variant, opt):
    kind = f"wnd_{variant}"
    jm, tm = pair(jax_api, kind, opt, LOSS)
    x, y = wnd_data(variant, WND_ROWS, 0)
    np.testing.assert_allclose(tm.predict(x), np.asarray(jm.predict(x)),
                               rtol=0, atol=1e-6)
    fit_both(jax_api, jm, tm, x, y, 32, 2, opt)
    xe, ye = wnd_data(variant, 50, 1)       # a padded final batch
    np.testing.assert_allclose(tm.evaluate(xe, ye, batch_size=32)["loss"],
                               jm.evaluate(xe, ye, batch_size=32)["loss"],
                               rtol=1e-5)
    pred = tm.predict(xe)
    assert pred.shape == (50, 2)
    np.testing.assert_allclose(pred, np.asarray(jm.predict(xe)), rtol=0,
                               atol=1e-6)


def test_wide_and_deep_graph_and_layout(jax_api):
    info = ColumnFeatureInfo(**COLUMNS)
    wnd = WideAndDeep(2, info)
    tables = {n: tuple(p.shape) for n, p in
              wnd.model.module.named_parameters() if "embed_" in n}
    assert tables == {"embed_0.embedding": (31, 8),
                      "embed_1.embedding": (41, 16)}
    assert WideAndDeep.tp_param_rules() == \
        jax_api["WideAndDeep"].tp_param_rules()
    assert registry.get("WideAndDeep") is WideAndDeep
    # JAX's rules are kept; training under the layout needs its ranks
    assert wnd.set_strategy("dp2,tp4", WideAndDeep.tp_param_rules()) \
        is wnd.model
    assert wnd.model._param_rules == WideAndDeep.tp_param_rules()
    with pytest.raises(TypeError, match="model_type"):
        WideAndDeep(2, info, model_type="narrow")
    with pytest.raises(ValueError):
        WideAndDeep(2, ColumnFeatureInfo(embed_cols=["u"],
                                         embed_in_dims=[3]))


# ---------------------------------------------------- SessionRecommender

@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("history", [False, True])
def test_session_recommender_matches_jax(jax_api, history, opt):
    kind = "session_hist" if history else "session"
    jm, tm = pair(jax_api, kind, opt, LOSS)
    x, y = session_data(history, SR_ROWS, 0)
    fit_both(jax_api, jm, tm, x, y, 16, 2, opt)
    xe, _ = session_data(history, 12, 1)
    pred = tm.predict(xe)
    assert pred.shape == (12, ITEMS)
    np.testing.assert_allclose(pred, np.asarray(jm.predict(xe)), rtol=0,
                               atol=1e-6)
    for zero_based in (True, False):
        got = tm.recommend_for_session(xe, max_items=4,
                                       zero_based_label=zero_based)
        want = jm.recommend_for_session(xe, max_items=4,
                                        zero_based_label=zero_based)
        assert [[i for i, _ in r] for r in got] == \
            [[i for i, _ in r] for r in want]
        np.testing.assert_allclose([[p for _, p in r] for r in got],
                                   [[p for _, p in r] for r in want],
                                   rtol=0, atol=1e-6)


def test_session_recommender_surface():
    sr = SessionRecommender(include_history=True, **SR_ARGS)
    # the history branch's Lambda is written against the array API
    # (x.sum(axis=1)) and runs on torch tensors, its shape found on meta
    names = [n for n, _ in sr.model.module.named_parameters()]
    assert "history_embed.embedding" in names
    assert "session_embed.embedding" in names
    with pytest.raises(Exception, match="Unsupported"):
        sr.recommend_for_user(None, 3)
    with pytest.raises(Exception, match="Unsupported"):
        sr.recommend_for_item(None, 3)
    with pytest.raises(ValueError, match="session_length"):
        SessionRecommender(ITEMS, 8, session_length=0)
    with pytest.raises(ValueError, match="history_length"):
        SessionRecommender(ITEMS, 8, session_length=3, include_history=True)
    x, _ = session_data(True, 3, 2)
    recs = sr.recommend_for_session(x, max_items=2, device="cpu")
    assert [len(r) for r in recs] == [2, 2, 2]
    assert all(r[0][1] >= r[1][1] for r in recs)


# ------------------------------------------------------- AnomalyDetector

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_anomaly_detector_matches_jax(jax_api, opt):
    jm, tm = pair(jax_api, "anomaly", opt, "mse")
    x, y = data("anomaly", 96, 0)
    assert x.shape == (96, 8, 1)
    fit_both(jax_api, jm, tm, x, y, 32, 2, opt)
    pred = tm.predict(x)
    jpred = np.asarray(jm.predict(x))
    assert pred.shape == (96, 1)
    np.testing.assert_allclose(pred, jpred, rtol=0, atol=1e-6)
    spiked = y.copy()
    spiked[[5, 40, 77]] += np.float32(3.0)
    JA = jax_api["AnomalyDetector"]
    got = AnomalyDetector.detect_anomalies(spiked, pred, 3)
    np.testing.assert_array_equal(got, JA.detect_anomalies(spiked, jpred, 3))
    assert sorted(got.tolist()) == [5, 40, 77]


def test_anomaly_detector_static_helpers_match_jax(jax_api):
    JA = jax_api["AnomalyDetector"]
    for data_, length, step in ((np.arange(20, dtype=np.float32), 5, 1),
                                (np.random.RandomState(0).randn(30, 3), 4,
                                 2)):
        got, want = AnomalyDetector.unroll(data_, length, step), \
            JA.unroll(data_, length, step)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        AnomalyDetector.unroll(np.zeros(4), 4)
    with pytest.raises(ValueError):
        AnomalyDetector((8, 1), hidden_layers=(8, 8), dropouts=(0.1,))
    rng = np.random.RandomState(1)
    y_true, y_pred = rng.randn(50), rng.randn(50)
    np.testing.assert_array_equal(
        AnomalyDetector.detect_anomalies(y_true, y_pred, 7),
        JA.detect_anomalies(y_true, y_pred, 7))


def test_anomaly_detector_dropout_by_its_properties():
    """With dropouts 0.2 the bits differ from JAX's; held instead: the
    dropout acts in training only, draws from the estimator's seed (two
    fits from the same weights agree bitwise), and the loss falls."""
    x, y = data("anomaly", 96, 0)
    nets = []
    for drops in ((0.2, 0.2), (0.2, 0.2), (0.0, 0.0)):
        m = AnomalyDetector(dropouts=drops, **AD_ARGS)
        m.compile(optimizer=Adam(1e-2), loss="mse", device="cpu")
        nets.append(m)
    state = nets[0].model.module.state_dict()
    for m in nets[1:]:
        m.model.module.load_state_dict(state)
    # inference: no dropout, so the three agree before training
    np.testing.assert_array_equal(nets[0].predict(x), nets[2].predict(x))
    hist = [m.fit(x, y, batch_size=32, nb_epoch=4)["loss"] for m in nets]
    assert hist[0] == hist[1]
    assert hist[0] != hist[2]
    assert hist[0][-1] < hist[0][0]
    pred = nets[0].predict(x)
    np.testing.assert_array_equal(pred, nets[0].predict(x))
    assert np.isfinite(pred).all()
    idx = AnomalyDetector.detect_anomalies(y, pred, 5)
    assert len(set(idx.tolist())) == 5


# --------------------------------------------- checkpoints across packages

KINDS = ["wnd_wide", "wnd_deep", "wnd_wide_n_deep", "session",
         "session_hist", "anomaly"]


@pytest.mark.parametrize("kind", KINDS)
def test_port_saves_jax_loads(jax_api, tmp_path, kind):
    tm = make(None, kind)
    x, _ = data(kind, 24, 3)
    want = tm.predict(x, device="cpu")
    tm.save_model(str(tmp_path / "m"))
    loaded = jax_api["ZooModel"].load_model(str(tmp_path / "m"))
    assert type(loaded).__name__ == type(tm).__name__
    np.testing.assert_allclose(np.asarray(loaded.predict(x)), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saves_port_loads(jax_api, tmp_path, kind):
    jm = make(jax_api, kind)
    x, _ = data(kind, 24, 4)
    want = np.asarray(jm.predict(x))
    jm.save_model(str(tmp_path / "m"))
    loaded = ZooModel.load_model(str(tmp_path / "m"))
    assert type(loaded) is type(make(None, kind))
    np.testing.assert_allclose(loaded.predict(x, device="cpu"), want,
                               rtol=0, atol=1e-5)
