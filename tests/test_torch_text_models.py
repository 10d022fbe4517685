"""The port's TextClassifier (cnn, lstm, gru) and KNRM against the JAX
package's, on the CPU, at small widths.

Each model is built in both packages from the same parameters (JAX's
initial tree through ``convert.flax_to_state_dict``) and run on the same
numpy ids:

- predict within atol 1e-6 (softmax and sigmoid outputs; measured
  3.0e-8 for the classifiers, 2.1e-7 for KNRM), and the flax trees match
  leaf for leaf;
- a fit of 2 epochs of 2 steps (Adam, dropout set to 0 in both: its bits
  differ between packages) with each epoch's loss within rtol 1e-5 and
  every parameter within 1e-5 of JAX's (measured: 6.8e-6 at worst, the
  cnn's convolution, 3.2e-6 lstm, 4.7e-6 gru, 6.0e-8 KNRM);
- KNRM's exact-match kernel (sigma 1e-3) turns a cosine's rounding into
  up to ~1/sigma^2 = 1e6 times its distance from 1 in its feature, so its
  scores are held against float64 in both packages: the port's distance
  at most 1.5x JAX's plus 1e-6 (measured: 1.24e-7 and 1.84e-7 at these
  widths; ``dev/estimate_text_limits.py`` reads them at full width);
- ``evaluate_ndcg`` / ``evaluate_map`` equal JAX's on the same scores;
- the cnn twin's import (``models/migration.py``) within rtol 1e-4 /
  atol 1e-5 of the twin (JAX's limits), lstm/gru refused with JAX's
  words; ``save_model`` / ``ZooModel.load_model`` across packages and
  ``InferenceModel.load_zoo`` within 1e-6.
JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.learn.optimizers import Adam
from analytics_zoo_tpu_torch.models import KNRM, TextClassifier, registry
from analytics_zoo_tpu_torch.models import migration
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.textmatching import (evaluate_map,
                                                         evaluate_ndcg)

TC = dict(class_num=3, vocab_size=40, token_length=8, sequence_length=14,
          encoder_output_dim=12)
KN = dict(text1_length=4, text2_length=9, vocab_size=30, embed_dim=8,
          kernel_num=6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))


@pytest.fixture(scope="module")
def jz():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models import migration as jmig
    from analytics_zoo_tpu.models.common import ZooModel as JZooModel
    from analytics_zoo_tpu.models.textclassification import (
        TextClassifier as JTC,
    )
    from analytics_zoo_tpu.models.textmatching import KNRM as JKNRM
    from analytics_zoo_tpu.models.textmatching import knrm as jknrm
    return dict(jax=jax, Adam=JAdam, TextClassifier=JTC, KNRM=JKNRM,
                knrm=jknrm, ZooModel=JZooModel, migration=jmig)


def _ids(n, width, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab + 1, (n, width)).astype(np.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _no_dropout(zoo):
    seen, stack = set(), list(zoo.model._graph()[1])
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if type(node.layer).__name__ == "Dropout":
            node.layer.p = 0.0
        stack.extend(node.inputs)


def _pair(jz, kind, **kw):
    """(JAX model, port model) from the same parameters."""
    if kind == "knrm":
        jm, tm = jz["KNRM"](**KN, **kw), KNRM(**KN, **kw)
        x = _ids(4, KN["text1_length"] + KN["text2_length"],
                 KN["vocab_size"])
    else:
        jm = jz["TextClassifier"](encoder=kind, **TC)
        tm = TextClassifier(encoder=kind, **TC)
        x = _ids(4, TC["sequence_length"], TC["vocab_size"])
    jm.predict(x, distributed=False)
    params = jz["jax"].device_get(jm.model.get_weights())
    tm.model.module.load_state_dict(convert.flax_to_state_dict(params))
    return jm, tm, params


@pytest.mark.parametrize("kind", ["cnn", "lstm", "gru", "knrm"])
def test_predict_and_layout_match_jax(jz, kind):
    jm, tm, params = _pair(jz, kind)
    assert _shapes(convert.flax_layout(tm.model.module)) == _shapes(params)
    width = (KN["text1_length"] + KN["text2_length"] if kind == "knrm"
             else TC["sequence_length"])
    x = _ids(16, width, TC["vocab_size"] if kind != "knrm"
             else KN["vocab_size"], seed=1)
    got = tm.predict(x, device="cpu")
    want = np.asarray(jm.predict(x, distributed=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,loss", [
    ("cnn", "sparse_categorical_crossentropy"),
    ("lstm", "sparse_categorical_crossentropy"),
    ("gru", "sparse_categorical_crossentropy"),
    ("knrm", "binary_crossentropy")])
def test_fit_matches_jax(jz, kind, loss):
    jm, tm, _ = _pair(jz, kind)
    for m in (jm, tm):
        _no_dropout(m)
    jm.compile(optimizer=jz["Adam"](1e-2), loss=loss)
    tm.compile(optimizer=Adam(1e-2), loss=loss, device="cpu")
    rng = np.random.default_rng(3)
    if kind == "knrm":
        x = _ids(32, KN["text1_length"] + KN["text2_length"],
                 KN["vocab_size"], seed=2)
        y = rng.integers(0, 2, (32, 1)).astype(np.float32)
    else:
        x = _ids(32, TC["sequence_length"], TC["vocab_size"], seed=2)
        y = rng.integers(0, TC["class_num"], 32).astype(np.int32)
    want = jm.fit(x, y, batch_size=16, nb_epoch=2)
    got = tm.fit(x, y, batch_size=16, nb_epoch=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    jparams = jz["jax"].device_get(jm.model.get_weights())
    mine = dict(_leaves(convert.state_dict_to_flax(
        tm.model.module.state_dict(), jparams)))
    for path, leaf in _leaves(jparams):
        np.testing.assert_allclose(mine[path], leaf, rtol=0, atol=1e-5,
                                   err_msg=path)


def _knrm_scores_f64(tm, x):
    """The port's KNRM of the same parameters in float64."""
    net = KNRM(**KN)
    net.model.module.load_state_dict(tm.model.module.state_dict())
    module = net.model.module.double().eval()
    with torch.no_grad():
        return module(torch.from_numpy(x.astype(np.float64))).numpy()


def test_knrm_exact_kernel_against_float64(jz):
    """Queries that share ids with their documents put cosines at 1 in
    the exact-match kernel; both packages sit as far from float64."""
    jm, tm, _ = _pair(jz, "knrm")
    x = _ids(32, KN["text1_length"] + KN["text2_length"], 6, seed=4)
    got = tm.predict(x, device="cpu")
    want = np.asarray(jm.predict(x, distributed=False))
    ref = _knrm_scores_f64(tm, x)
    d_port = float(np.abs(got - ref).max())
    d_jax = float(np.abs(want - ref).max())
    assert d_port <= 1.5 * d_jax + 1e-6, (d_port, d_jax)


def test_ranking_metrics_equal_jax(jz):
    rng = np.random.default_rng(5)
    for _ in range(16):
        n = int(rng.integers(2, 9))
        y = rng.integers(0, 2, n).astype(np.float32)
        s = rng.random(n).astype(np.float32)
        for k in (1, 3, 10):
            assert evaluate_ndcg(y, s, k) == jz["knrm"].evaluate_ndcg(y, s, k)
        assert evaluate_map(y, s) == jz["knrm"].evaluate_map(y, s)
    assert evaluate_map([1, 0, 0, 1], [0.9, 0.1, 0.2, 0.8]) == 1.0
    assert evaluate_ndcg([0, 0], [0.5, 0.1]) == 0.0


def test_constructor_checks_and_registry():
    with pytest.raises(ValueError, match="encoder"):
        TextClassifier(2, 10, encoder="transformer")
    with pytest.raises(ValueError, match="kernel_num"):
        KNRM(4, 4, 10, kernel_num=1)
    with pytest.raises(ValueError, match="target_mode"):
        KNRM(4, 4, 10, target_mode="listwise")
    assert registry.get("TextClassifier") is TextClassifier
    assert registry.get("KNRM") is KNRM
    m = KNRM(**KN, target_mode="classification")
    out = m.predict(_ids(3, 13, 30), device="cpu")
    assert out.shape == (3, 2)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["cnn", "knrm"])
def test_save_model_crosses_packages(jz, kind, tmp_path):
    jm, tm, _ = _pair(jz, kind)
    for m in (jm, tm):
        m.compile(optimizer="adam", loss="binary_crossentropy"
                  if kind == "knrm" else "sparse_categorical_crossentropy",
                  **({} if m is jm else {"device": "cpu"}))
    width = (KN["text1_length"] + KN["text2_length"] if kind == "knrm"
             else TC["sequence_length"])
    x = _ids(8, width, 30, seed=6)
    want = np.asarray(jm.predict(x, distributed=False))
    jm.save_model(str(tmp_path / "jax"))
    back = ZooModel.load_model(str(tmp_path / "jax"))
    assert type(back) is type(tm)
    np.testing.assert_allclose(back.predict(x, device="cpu"), want,
                               rtol=0, atol=1e-6)
    tm.save_model(str(tmp_path / "port"))
    there = jz["ZooModel"].load_model(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(there.predict(
        x, distributed=False)), want, rtol=0, atol=1e-6)
    im = InferenceModel(device="cpu").load(str(tmp_path / "jax"))
    np.testing.assert_allclose(im.predict(x), want, rtol=0, atol=1e-6)


def test_text_classifier_import_from_torch_matches_twin(jz):
    torch.manual_seed(4)
    kw = dict(class_num=3, vocab_size=60, token_length=8,
              encoder_output_dim=16)
    twin = migration.make_torch_text_classifier(**kw)
    zoo = TextClassifier(sequence_length=20, encoder="cnn", **kw)
    migration.import_text_classifier_from_torch(zoo, twin)
    jzoo = jz["TextClassifier"](sequence_length=20, encoder="cnn", **kw)
    jz["migration"].import_text_classifier_from_torch(jzoo, twin)
    ids = np.random.RandomState(5).randint(1, 61, (10, 20)).astype(
        np.float32)
    with torch.no_grad():
        want = twin(torch.from_numpy(ids)).numpy()
    got = zoo.predict(ids, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jzoo.predict(ids, distributed=False)), rtol=0,
        atol=1e-6)
    # the state dict form, as JAX takes it
    zoo2 = TextClassifier(sequence_length=20, encoder="cnn", **kw)
    migration.import_text_classifier_from_torch(zoo2, twin.state_dict())
    np.testing.assert_array_equal(zoo2.predict(ids, device="cpu"), got)
    lstm = TextClassifier(class_num=2, vocab_size=10, token_length=4,
                          sequence_length=6, encoder="lstm",
                          encoder_output_dim=4)
    with pytest.raises(ValueError, match="cnn encoder"):
        migration.import_text_classifier_from_torch(lstm, {})
