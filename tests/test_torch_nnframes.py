"""The port's NNFrames stages (``nnframes/``) against the JAX package's,
on the CPU.

- ``NNEstimator`` / ``NNClassifier`` over a pandas DataFrame (an array
  column, or scalar columns stacked), a keras MLP started from JAX's
  parameters: ``fit`` (2 epochs, the estimators' shuffle) then
  ``transform``; the prediction columns within 1e-5 of JAX's, the
  classifier's argmax column equal, the Spark-ML setters and camelCase
  aliases alike.
- ``save`` in one package, ``load`` in the other (the estimator's
  checkpoint): the loaded model's predictions within 1e-5 of the saver's.
- An ``nn.Module`` (JAX's flax-module case) trains through
  ``Estimator.from_torch``.
- ``NNImageReader.read_images`` gives JAX's frame.
- Without CUDA and without ``device="cpu"`` the estimators raise.
JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from analytics_zoo_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from analytics_zoo_tpu_torch.nnframes import (  # noqa: E402
    NNClassifier, NNClassifierModel, NNEstimator, NNImageReader, NNModel,
)

LOSS = "sparse_categorical_crossentropy"


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jn():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu import nnframes
    from analytics_zoo_tpu.keras import layers
    from analytics_zoo_tpu.keras.models import Sequential
    return dict(jax=jax, nn=nnframes, layers=layers, Sequential=Sequential)


def _df(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)
    return pd.DataFrame({"features": [row for row in x], "label": y,
                         "f0": x[:, 0], "f1": x[:, 1], "f2": x[:, 2],
                         "f3": x[:, 3]})


def _mlp(Sequential, layers):
    m = Sequential()
    m.add(layers.Dense(8, input_shape=(4,), activation="relu",
                       name="nn_hidden"))
    m.add(layers.Dense(2, activation="softmax", name="nn_out"))
    return m


def _pair(jn):
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu_torch.keras.models import Sequential
    jm = _mlp(jn["Sequential"], jn["layers"])
    tm = _mlp(Sequential, tl)
    tm.module.load_state_dict(flax_to_state_dict(
        jn["jax"].device_get(jm.get_weights())))
    return jm, tm


def _probs(df, col="prediction"):
    return np.stack(df[col].tolist())


@pytest.mark.parametrize("cols", ["array", "scalars"])
def test_estimator_fit_transform_matches_jax(jn, cols):
    df = _df()
    feats = "features" if cols == "array" else ["f0", "f1", "f2", "f3"]
    jm, tm = _pair(jn)
    stages = []
    for cls, m, kw in ((jn["nn"].NNEstimator, jm, {}),
                       (NNEstimator, tm, {"device": "cpu"})):
        est = (cls(m, LOSS, **kw).setBatchSize(16).setMaxEpoch(2)
               .set_features_col(feats).setLabelCol("label")
               .setPredictionCol("p"))
        stages.append(est.fit(df))
    assert isinstance(stages[1], NNModel)
    want, got = (s.transform(df) for s in stages)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(_probs(got, "p"), _probs(want, "p"),
                               rtol=0, atol=1e-5)


def test_classifier_argmax_matches_jax(jn):
    df = _df()
    jm, tm = _pair(jn)
    models = [(jn["nn"].NNClassifier(jm, LOSS)), NNClassifier(tm, LOSS,
                                                              device="cpu")]
    out = []
    for clf in models:
        clf.set_batch_size(16).set_max_epoch(2)
        out.append(clf.fit(df).transform(df))
    assert isinstance(models[1].fit(df.head(16)), NNClassifierModel)
    np.testing.assert_array_equal(out[1]["prediction"].to_numpy(),
                                  out[0]["prediction"].to_numpy())
    assert out[1]["prediction"].dtype == np.float64


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_save_in_one_load_in_the_other(jn, tmp_path, saver):
    df = _df()
    jm, tm = _pair(jn)
    jest = jn["nn"].NNEstimator(jm, LOSS, optimizer="adam")
    test = NNEstimator(tm, LOSS, optimizer="adam", device="cpu")
    for e in (jest, test):
        e.setBatchSize(16).setMaxEpoch(1)
    first, second = (test, jest) if saver == "port" else (jest, test)
    model = first.fit(df)
    want = _probs(model.transform(df))
    path = str(tmp_path / "nnmodel")
    model.save(path)
    other = second.fit(df.head(16))
    other.load(path)
    np.testing.assert_allclose(_probs(other.transform(df)), want,
                               rtol=0, atol=1e-5)


def test_torch_module_trains_through_from_torch():
    df = _df()
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(),
                              torch.nn.Linear(8, 2), torch.nn.Softmax(-1))
    est = (NNClassifier(net, LOSS, optimizer="adam", device="cpu")
           .setBatchSize(16).setMaxEpoch(3))
    model = est.fit(df)
    assert model.estimator.model is net
    out = model.transform(df)
    with torch.no_grad():
        want = net(torch.from_numpy(np.stack(df["features"]))).argmax(-1)
    np.testing.assert_array_equal(out["prediction"].to_numpy(),
                                  want.numpy().astype(np.float64))


def test_image_reader_matches_jax(jn, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (10, 12, 3), dtype=np.uint8)
                        ).save(d / f"im{i}.png")
    for kw in ({}, {"resize_h": 8, "resize_w": 6}):
        got = NNImageReader.read_images(str(d), **kw)
        want = jn["nn"].NNImageReader.read_images(str(d), **kw)
        assert list(got.columns) == list(want.columns) == ["image", "origin"]
        assert got["origin"].tolist() == want["origin"].tolist()
        for g, w in zip(got["image"], want["image"]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_estimators_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu_torch.keras.models import Sequential
    for cls in (NNEstimator, NNClassifier):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(_mlp(Sequential, tl), LOSS)
