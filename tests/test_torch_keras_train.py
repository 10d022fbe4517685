"""Keras training in the port (``compile``/``fit``/``evaluate``/``predict``)
against the JAX package's, on the CPU.

Two models, built the same way in both packages from the same parameters
(the JAX model's initial tree through ``convert.flax_to_state_dict``),
trained on the same numpy data in the same batch order (the estimators
shuffle alike), at a small size (users 50, items 40, widths 8, hidden
(16, 8), batch 64, 4 steps an epoch, 3 epochs):

- ``NeuralCF`` (the fused lookup's ``concat`` and ``mul``, forward and
  backward);
- the item-history graph: NCF's inputs plus a pooled history column,
  ``Embedding(41, 8, pooling="mean")`` over 8 ids (lengths 1-8, pad id 0
  after the length), concatenated with the MLP tower's embeddings (the
  bag, forward and backward).

Held, with Adam and with SGD: the loss of each epoch within rtol 1e-5
(JAX runs the step on 8 virtual devices and sums in another order); the
parameters after SGD within atol 1e-6 (measured: 3e-8); after Adam within
atol 1e-5 in all but 1% of each leaf's elements and within 2 lr per step
everywhere (Adam divides by the root of the squared gradient, so an
element whose gradient is near zero can move by up to lr on rounding
noise; measured: 3e-7 for NCF, 3.6e-5 at 3 of the 896 elements of the
history graph's first Dense); ``evaluate`` (loss rtol 1e-5, accuracy
equal) and ``predict`` (atol 1e-6).

Also: compiling after ``load_weights`` keeps the weights; ``fit`` and
``evaluate`` before ``compile`` raise, ``predict`` works;
``Embedding(pooling=None)`` against flax ``nn.Embed``;
``zero_based_id=False``; ``SparseEmbedding``; the names ``convert.py``
maps; XShards, DataFrames and ``recommend_for_user``/``_item`` against
JAX's. The regularizers, ``summary`` and ``set_tensorboard`` are held in
tests/test_torch_keras_surface.py, ``Seq2Seq.fit`` in
tests/test_torch_recurrent_train.py. JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.data import HostXShards, XShards
from analytics_zoo_tpu_torch.keras import Input, Model, Sequential
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.learn.optimizers import SGD, Adam
from analytics_zoo_tpu_torch.models import NeuralCF
from analytics_zoo_tpu_torch.models.recommendation import UserItemFeature

USERS, ITEMS, WIDTH, HIST = 50, 40, 8, 8
NCF_ARGS = dict(user_count=USERS, item_count=ITEMS, class_num=5,
                user_embed=WIDTH, item_embed=WIDTH, hidden_layers=(16, 8),
                include_mf=True, mf_embed=WIDTH)
LOSS = "sparse_categorical_crossentropy"
BATCH, ROWS, EPOCHS = 64, 256, 3
LR = {"adam": 1e-2, "sgd": 0.5}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch, tmp_path):
    monkeypatch.setenv("ZOO_AUTOTUNE", "off")
    monkeypatch.setenv("ZOO_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


@pytest.fixture(scope="module")
def jax_api():
    """The JAX package's keras modules, NeuralCF and optimizers."""
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import Model as JModel
    from analytics_zoo_tpu.keras import Sequential as JSequential
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF
    return dict(jax=jax, Input=JInput, Model=JModel, Sequential=JSequential,
                layers=jl, NeuralCF=JNCF,
                opt={"adam": JAdam, "sgd": JSGD})


def _pairs(n, seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(1, USERS + 1, n),
                  rng.randint(1, ITEMS + 1, n)], 1).astype(np.float32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def _history(n, seed):
    """Item histories: a length in [1, 8], ids in [1, ITEMS], 0 after."""
    rng = np.random.RandomState(seed + 100)
    lengths = rng.randint(1, HIST + 1, n)
    ids = rng.randint(1, ITEMS + 1, (n, HIST))
    return np.where(np.arange(HIST)[None] < lengths[:, None], ids,
                    0).astype(np.int32)


def hist_graph(Input, Model, layers):
    """NCF with a pooled item-history column, from either package's
    layers."""
    ui = Input(shape=(2,))
    hist = Input(shape=(HIST,))
    mlp = layers.FusedEmbeddings(
        [("mlp_user_embed", USERS + 1, WIDTH),
         ("mlp_item_embed", ITEMS + 1, WIDTH)], combine="concat",
        init="uniform", name="mlp_embed_bag")(ui)
    pooled = layers.Embedding(ITEMS + 1, WIDTH, init="uniform",
                              pooling="mean", name="hist_embed")(hist)
    linear = layers.Dense(16, activation="relu")(
        layers.merge([mlp, pooled], mode="concat"))
    linear = layers.Dense(8, activation="relu")(linear)
    mf = layers.FusedEmbeddings(
        [("mf_user_embed", USERS + 1, WIDTH),
         ("mf_item_embed", ITEMS + 1, WIDTH)], combine="mul",
        init="uniform", name="mf_embed_bag")(ui)
    out = layers.Dense(5, activation="softmax")(
        layers.merge([linear, mf], mode="concat"))
    return Model(input=[ui, hist], output=out)


def _pair(jax_api, kind, opt):
    """(JAX KerasNet, port KerasNet) compiled alike, same parameters."""
    jx = jax_api
    if kind == "ncf":
        jnet = jx["NeuralCF"](**NCF_ARGS).model
        tnet = NeuralCF(**NCF_ARGS).model
    else:
        jnet = hist_graph(jx["Input"], jx["Model"], jx["layers"])
        tnet = hist_graph(Input, Model, tl)
    jnet.compile(optimizer=jx["opt"][opt](LR[opt]), loss=LOSS,
                 metrics=["accuracy"])
    tnet.module.load_state_dict(flax_to_state_dict(
        jx["jax"].device_get(jnet.get_weights())))
    port_opt = Adam(LR[opt]) if opt == "adam" else SGD(LR[opt])
    tnet.compile(optimizer=port_opt, loss=LOSS, metrics=["accuracy"],
                 device="cpu")
    return jnet, tnet


def _inputs(kind, n, seed):
    x, y = _pairs(n, seed)
    return ([x, _history(n, seed)] if kind == "hist" else x), y


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _assert_params(tnet, jparams, opt, steps):
    got = dict(_leaves(state_dict_to_flax(tnet.module.state_dict(),
                                          jparams)))
    for path, want in _leaves(jparams):
        diff = np.abs(got[path] - want)
        if opt == "sgd":
            assert diff.max() <= 1e-6, (path, diff.max())
        else:
            assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
            assert diff.max() <= 2 * LR[opt] * steps, (path, diff.max())


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("kind", ["ncf", "hist"])
def test_fit_evaluate_predict_match_jax(jax_api, kind, opt):
    jnet, tnet = _pair(jax_api, kind, opt)
    x, y = _inputs(kind, ROWS, 0)
    want = jnet.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    got = tnet.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    assert len(got["loss"]) == EPOCHS
    assert len(tnet.estimator.step_losses) == EPOCHS * ROWS // BATCH
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _assert_params(tnet, jax_api["jax"].device_get(jnet.get_weights()),
                   opt, EPOCHS * ROWS // BATCH)
    xe, ye = _inputs(kind, 100, 1)   # 100 rows: a padded final batch
    ev_want = jnet.evaluate(xe, ye, batch_size=BATCH)
    ev_got = tnet.evaluate(xe, ye, batch_size=BATCH)
    assert set(ev_got) == {"loss", "accuracy"}
    np.testing.assert_allclose(ev_got["loss"], ev_want["loss"], rtol=1e-5)
    assert ev_got["accuracy"] == pytest.approx(ev_want["accuracy"])
    pred = tnet.predict(xe, batch_size=BATCH)
    assert pred.shape == (100, 5)
    np.testing.assert_allclose(pred, np.asarray(jnet.predict(
        xe, batch_size=BATCH)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tnet.predict_classes(xe, zero_based_label=False),
        pred.argmax(-1) + 1)


def test_validation_data_in_keras_form(jax_api):
    jnet, tnet = _pair(jax_api, "hist", "sgd")
    x, y = _inputs("hist", 128, 2)
    xv, yv = _inputs("hist", 40, 3)
    want = jnet.fit(x, y, batch_size=BATCH, nb_epoch=2,
                    validation_data=(xv, yv))
    got = tnet.fit(x, y, batch_size=BATCH, nb_epoch=2,
                   validation_data=(xv, yv))
    assert sorted(got) == sorted(want) == ["loss", "val_accuracy",
                                           "val_loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_zoo_model_delegates_training(jax_api):
    jncf = jax_api["NeuralCF"](**NCF_ARGS)
    ncf = NeuralCF(**NCF_ARGS)
    jncf.compile(optimizer=jax_api["opt"]["sgd"](0.5), loss=LOSS)
    ncf.model.module.load_state_dict(flax_to_state_dict(
        jax_api["jax"].device_get(jncf.model.get_weights())))
    assert ncf.compile(optimizer=SGD(0.5), loss=LOSS, device="cpu") \
        is ncf.model
    assert ncf.set_strategy("dp") is ncf.model
    # a layout is kept with JAX's rules; training under it needs its ranks
    rules = NeuralCF.tp_param_rules()
    assert ncf.set_strategy("dp2,tp4", param_rules=rules) is ncf.model
    x, y = _pairs(128, 4)
    with pytest.raises(ValueError, match="ranks"):
        ncf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    assert ncf.set_strategy("dp") is ncf.model
    assert ncf.model._param_rules == rules      # None keeps the rules
    want = jncf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    got = ncf.fit(x, y, batch_size=BATCH, nb_epoch=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(ncf.evaluate(x, y, batch_size=BATCH)["loss"],
                               jncf.evaluate(x, y, batch_size=BATCH)["loss"],
                               rtol=1e-5)


# ------------------------------------------------------- the keras surface

def test_compile_after_load_weights_keeps_them(tmp_path):
    a = NeuralCF(**NCF_ARGS)
    a.model.save_weights(str(tmp_path / "w.pt"))
    b = NeuralCF(**NCF_ARGS)
    with torch.no_grad():
        for p in b.model.module.parameters():
            p.add_(1.0)
    b.model.load_weights(str(tmp_path / "w.pt"))
    b.compile(optimizer=SGD(0.1), loss=LOSS, device="cpu")
    x, _ = _pairs(16, 5)
    np.testing.assert_array_equal(b.predict(x), a.predict(x, device="cpu"))
    # a second compile keeps what training did
    b.fit(*_pairs(64, 6), batch_size=BATCH)
    trained = b.predict(x)
    b.compile(optimizer=Adam(1e-3), loss=LOSS, device="cpu")
    np.testing.assert_array_equal(b.predict(x), trained)
    weights = b.model.get_weights()
    assert set(weights) == set(b.model.module.state_dict())
    assert all(isinstance(v, np.ndarray) for v in weights.values())


def test_fit_and_evaluate_before_compile_raise_predict_works():
    ncf = NeuralCF(**NCF_ARGS)
    x, y = _pairs(8, 7)
    with pytest.raises(RuntimeError, match="compile"):
        ncf.fit(x, y)
    with pytest.raises(RuntimeError, match="compile"):
        ncf.model.evaluate(x, y)
    assert ncf.predict(x, device="cpu").shape == (8, 5)


def test_compiled_device_defaults_to_cuda_and_is_kept():
    ncf = NeuralCF(**NCF_ARGS)
    ncf.compile(optimizer="adam", loss=LOSS, device="cpu")
    with pytest.raises(ValueError, match="compiled for cpu"):
        ncf.predict(_pairs(4, 8)[0], device="meta")
    if torch.cuda.is_available():
        return
    other = NeuralCF(**NCF_ARGS)
    other.compile(optimizer="adam", loss=LOSS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        other.fit(*_pairs(64, 8), batch_size=BATCH)


def test_clipping_reaches_the_estimator():
    ncf = NeuralCF(**NCF_ARGS)
    ncf.compile(optimizer="sgd", loss=LOSS, device="cpu")
    ncf.model.set_gradient_clipping_by_l2_norm(0.5)
    assert ncf.model.estimator._grad_clip == ("norm", 0.5)
    ncf.model.set_constant_gradient_clipping(-0.1, 0.2)
    assert ncf.model.estimator._grad_clip == ("const", -0.1, 0.2)


# ------------------------------------------------------------- embeddings

def _seq_pair(jax_api, make, shape, x):
    """(JAX output, port output) of a one-layer Sequential built by
    ``make(layers)``, same parameters."""
    jx = jax_api
    jnet = jx["Sequential"]().add(make(jx["layers"], shape))
    tnet = Sequential().add(make(tl, shape))
    mod = jnet.to_flax()
    variables = mod.init(jx["jax"].random.PRNGKey(0), x)
    tnet.module.load_state_dict(flax_to_state_dict(
        jx["jax"].device_get(variables["params"])))
    return (np.asarray(mod.apply(variables, x)),
            tnet.predict(x, device="cpu"))


@pytest.mark.parametrize("vocab", [11, 1])
@pytest.mark.parametrize("zero_based", [True, False])
def test_unpooled_embedding_matches_flax_embed(jax_api, zero_based, vocab):
    # ids over [-V, V + 2): some wrap, some are out of range (NaN rows);
    # flax broadcasts a one-row table whatever the id
    x = np.random.RandomState(9).randint(-vocab, vocab + 2,
                                         (6, 5)).astype(np.int32)
    want, got = _seq_pair(jax_api, lambda L, s: L.Embedding(
        vocab, 4, input_shape=s, zero_based_id=zero_based, name="emb"),
        (5,), x)
    assert got.shape == (6, 5, 4)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)],
                                  want[~np.isnan(want)])


@pytest.mark.parametrize("cls", ["Embedding", "SparseEmbedding"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("zero_based", [True, False])
def test_pooled_embedding_matches_jax(jax_api, cls, pooling, zero_based):
    x = np.random.RandomState(10).randint(0, 14, (7, 6)).astype(np.float32)
    want, got = _seq_pair(jax_api, lambda L, s: getattr(L, cls)(
        12, 5, input_shape=s, zero_based_id=zero_based, pooling=pooling,
        name="bag"), (6,), x)
    assert got.shape == (7, 5)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_embedding_rejects_unknown_pooling():
    with pytest.raises(ValueError, match="pooling"):
        tl.Embedding(4, 2, pooling="max")


def test_convert_maps_the_history_graph_both_ways(jax_api):
    jx = jax_api
    jnet = hist_graph(jx["Input"], jx["Model"], jx["layers"])
    x = [np.zeros((2, 2), np.float32), np.zeros((2, HIST), np.int32)]
    params = jx["jax"].device_get(jnet.to_flax().init(
        jx["jax"].random.PRNGKey(1), *x)["params"])
    state = flax_to_state_dict(params)
    tnet = hist_graph(Input, Model, tl)
    assert set(state) == set(tnet.module.state_dict())
    assert "hist_embed.embedding" in state
    tnet.module.load_state_dict(state)
    back = state_dict_to_flax(tnet.module.state_dict(), params)
    for (pa, a), (pb, b) in zip(_leaves(back), _leaves(params)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- XShards, DataFrames

def test_xshards_match_jax():
    from analytics_zoo_tpu.data.shard import XShards as JXShards
    data = {"x": (np.arange(10.0), np.arange(20).reshape(10, 2)),
            "y": np.arange(10)}
    got, want = XShards.partition(data, 3), JXShards.partition(data, 3)
    assert got.num_partitions() == want.num_partitions() == 3
    for g, w in zip(got.collect(), want.collect()):
        np.testing.assert_array_equal(g["x"][1], w["x"][1])
        np.testing.assert_array_equal(g["y"], w["y"])
    doubled = got.transform_shard(lambda s, k: {"x": s["x"], "y": s["y"] * k},
                                  2)
    assert [list(s["y"]) for s in doubled.collect()] == \
        [list(s["y"] * 2) for s in want.collect()]
    recs = list(range(7))
    assert XShards.from_records(recs, 3).collect() == \
        JXShards.from_records(recs, 3).collect()
    with pytest.raises(ValueError):
        XShards.partition({"a": np.zeros(3), "b": np.zeros(4)})


def test_fit_from_xshards_and_dataframes_matches_jax(jax_api):
    import pandas as pd
    from analytics_zoo_tpu.data.shard import HostXShards as JHostXShards
    x, y = _pairs(128, 11)
    df = pd.DataFrame({"user": x[:, 0], "item": x[:, 1], "label": y})
    for feed in ("xshards", "dataframe"):
        jnet, tnet = _pair(jax_api, "ncf", "sgd")
        if feed == "xshards":
            shards = [{"x": x[:64], "y": y[:64]}, {"x": x[64:], "y": y[64:]}]
            jdata, tdata, kw = JHostXShards(shards), HostXShards(shards), {}
        else:
            jdata, tdata = df, df
            kw = dict(feature_cols=["user", "item"], label_cols=["label"])
        want = jnet.fit(jdata, batch_size=BATCH, nb_epoch=2, **kw)
        got = tnet.fit(tdata, batch_size=BATCH, nb_epoch=2, **kw)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    out = tnet.estimator.predict(HostXShards([{"x": x}]))
    assert isinstance(out, HostXShards)
    assert out.collect()[0]["prediction"].shape == (128, 5)


def test_recommend_for_user_and_item_match_jax(jax_api):
    from analytics_zoo_tpu.data.shard import HostXShards as JHostXShards
    jncf = jax_api["NeuralCF"](**NCF_ARGS)
    ncf = NeuralCF(**NCF_ARGS)
    jncf.compile(optimizer="adam", loss=LOSS)
    ncf.model.module.load_state_dict(flax_to_state_dict(
        jax_api["jax"].device_get(jncf.model.get_weights())))
    ncf.compile(optimizer="adam", loss=LOSS, device="cpu")
    pairs = [(u, i) for u in (1, 2, 3) for i in range(1, 9)]
    feats = [UserItemFeature(u, i, np.array([u, i])) for u, i in pairs]
    shards = [feats[:10], feats[10:]]
    for name, limit in (("recommend_for_user", 3), ("recommend_for_item", 2)):
        want = getattr(jncf, name)(JHostXShards(shards), limit).collect()
        got = getattr(ncf, name)(HostXShards(shards), limit).collect()
        assert [[(p.user_id, p.item_id, p.prediction) for p in s]
                for s in got] == [[(p.user_id, p.item_id, p.prediction)
                                   for p in s] for s in want]
        for gs, ws in zip(got, want):
            np.testing.assert_allclose([p.probability for p in gs],
                                       [p.probability for p in ws],
                                       rtol=1e-5, atol=1e-6)
    per_pair = ncf.predict_user_item_pair(HostXShards(shards))
    assert isinstance(per_pair, HostXShards)
    assert sum(len(s) for s in per_pair.collect()) == len(feats)
