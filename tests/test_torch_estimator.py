"""The port's training engine against the JAX package's, on the CPU.

- ``iter_batches`` yields the JAX ``ShardedDataset``'s exact batches
  (order, padding, mask) for the same seed and epoch.
- ``Estimator.from_torch(...).fit`` against ``Estimator.from_flax(...)
  .fit`` from identical parameters (``convert.flax_to_state_dict``), for a
  small MLP (with and without global-norm clipping) and a tiny BERT
  classifier called on ids alone with ``use_flash=True`` (hidden 64, 2
  blocks, 4 heads, 16 tokens, dropout 0; both packages take their
  blockwise path off the accelerator): the loss of each epoch within rtol
  1e-5 and every parameter after training within atol 1e-5
  (``convert.state_dict_to_flax``) in all but 0.1% of its elements and
  within 1e-4 in all (Adam divides by the root of the squared gradient,
  so an element whose gradient is near zero magnifies the fp32 rounding
  of its sums: measured 2e-5 at worst), but for attention's key bias: its
  gradient is zero in exact arithmetic, so Adam's steps on it follow
  rounding noise, and it is held to Adam's step bound in both packages.
  The JAX step runs on 8 virtual devices and sums in another order.
- ``evaluate`` over a padded final batch and ``predict`` equal JAX's
  within the same tolerance; ``BERTClassifier`` (which passes the input
  mask, so its attention is the masked einsum chain in both packages)
  fits, evaluates and predicts like JAX's ``BERTClassifier``.
- ``device=None`` raises without CUDA; strategies other than "dp"
  raise, ``model_dir`` snapshots; dropout draws the same bits for the
  same seed and leaves the caller's random state alone; ``save``/``load``
  write the JAX package's layout and restore training exactly (more in
  tests/test_torch_checkpoint.py).

JAX is imported by fixtures only.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import Dense
from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.data import ShardedDataset, to_sharded_dataset
from analytics_zoo_tpu_torch.learn import Estimator, TorchEstimator
from analytics_zoo_tpu_torch.text import BERTClassifier, BertConfig
from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule

LOSS = "sparse_categorical_crossentropy_logits"
SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
             intermediate_size=128, max_position_len=32, hidden_drop=0.0,
             attn_drop=0.0)
LENGTH = 16


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
    """(flax.linen, the JAX Estimator, its Adam) — imported here only."""
    pytest.importorskip("jax")
    import flax.linen as fnn
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    return fnn, JEstimator, JAdam


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = Dense(8, 16)
        self.out = Dense(16, 3)

    def forward(self, x, train: bool = False):
        return self.out(torch.relu(self.hidden(x)))


def _jax_mlp(fnn):
    class JMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            x = fnn.relu(fnn.Dense(16, name="hidden")(x))
            return fnn.Dense(3, name="out")(x)
    return JMLP()


def _mlp_data(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 3, n).astype(np.int32))


def _params_close(module, jparams, atol=1e-5, noise_only=(), bound=0.0):
    """Every leaf within ``atol`` of JAX's in all but 0.1% of its elements
    and within ``10 * atol`` in all, except the leaves whose path ends with
    one of ``noise_only``: those only within ``bound`` of zero in both
    packages."""
    got = state_dict_to_flax(module.state_dict(), jparams)
    flat = []

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            flat.append((path, a, np.asarray(b)))

    walk(got, jparams, "")
    for path, a, b in flat:
        if path.endswith(noise_only):
            assert np.abs(a).max() <= bound and np.abs(b).max() <= bound
            continue
        diff = np.abs(a - b)
        assert float(np.mean(diff > atol)) <= 1e-3, (path, diff.max())
        assert float(diff.max()) <= 10 * atol, (path, diff.max())


def _pair_mlp(jax_api, lr=1e-2):
    fnn, JEstimator, JAdam = jax_api
    x, _ = _mlp_data(4, 0)
    jest = JEstimator.from_flax(model=_jax_mlp(fnn), loss=LOSS,
                                optimizer=JAdam(lr), sample_input=x[:2],
                                metrics=["accuracy"])
    module = MLP()
    module.load_state_dict(flax_to_state_dict(jest.adapter.params))
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    test = Estimator.from_torch(model=module, loss=LOSS, optimizer=Adam(lr),
                                metrics=["accuracy"], device="cpu")
    return jest, test


# ------------------------------------------------------------- batching

@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False),
                                          (False, False)])
def test_iter_batches_matches_jax_order(jax_api, shuffle, drop):
    from analytics_zoo_tpu.data.dataset import ShardedDataset as JDataset
    ids = np.arange(37)
    x = (ids.astype(np.float32), {"a": ids * 2})
    want = list(JDataset(x, ids).iter_batches(8, shuffle, seed=5, epoch=3,
                                              drop_remainder=drop))
    got = list(ShardedDataset(x, ids).iter_batches(8, shuffle, seed=5,
                                                   epoch=3,
                                                   drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for (gx, gy, gm), (wx, wy, wm) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx[0], wx[0])
        np.testing.assert_array_equal(gx[1]["a"], wx[1]["a"])
        assert (gm is None) == (wm is None)
        if gm is not None:
            np.testing.assert_array_equal(gm, wm)


def test_to_sharded_dataset_forms():
    x, y = _mlp_data(10, 1)
    assert to_sharded_dataset((x, y)).y is not None
    d = to_sharded_dataset({"x": x, "y": y})
    assert d.n == 10 and d.y.shape == (10,)
    assert to_sharded_dataset(x).y is None
    with pytest.raises(ValueError, match="length"):
        ShardedDataset(x, y[:4])
    with pytest.raises(TypeError):
        to_sharded_dataset("nope")
    with pytest.raises(ValueError, match="batch_size"):
        next(ShardedDataset(x, y).iter_batches(11))


# ------------------------------------------------------------- fit parity

@pytest.mark.parametrize("clip", [None, 0.05])
def test_mlp_fit_matches_jax(jax_api, clip):
    jest, test = _pair_mlp(jax_api)
    if clip is not None:
        jest.set_l2_norm_gradient_clipping(clip)
        test.set_l2_norm_gradient_clipping(clip)
    x, y = _mlp_data(100, 2)
    want = jest.fit((x, y), epochs=3, batch_size=16)
    got = test.fit((x, y), epochs=3, batch_size=16)
    assert len(got["loss"]) == 3
    assert len(test.step_losses) == 3 * (100 // 16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _params_close(test.model, jest.get_model())


def test_mlp_evaluate_and_predict_match_jax(jax_api):
    jest, test = _pair_mlp(jax_api)
    x, y = _mlp_data(64, 3)
    jest.fit((x, y), epochs=1, batch_size=16)
    test.fit((x, y), epochs=1, batch_size=16)
    xe, ye = _mlp_data(21, 4)   # 21 rows: the last batch of 8 is padded
    want = jest.evaluate((xe, ye), batch_size=8)
    got = test.evaluate((xe, ye), batch_size=8)
    assert set(got) == {"loss", "accuracy"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"])
    pred = test.predict(xe, batch_size=8)
    assert pred.shape == (21, 3)
    np.testing.assert_allclose(pred, np.asarray(jest.predict(xe,
                                                             batch_size=8)),
                               rtol=0, atol=1e-5)


def test_fit_with_validation_data_reports_it(jax_api):
    jest, test = _pair_mlp(jax_api)
    x, y = _mlp_data(48, 5)
    xv, yv = _mlp_data(13, 6)
    want = jest.fit((x, y), epochs=2, batch_size=16,
                    validation_data=(xv, yv))
    got = test.fit((x, y), epochs=2, batch_size=16,
                   validation_data=(xv, yv))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def _jax_flash_classifier(fnn, config):
    """bench.py's BERT classifier, called on ids alone."""
    from analytics_zoo_tpu.text.bert import BertModule as JBertModule

    class JClassifier(fnn.Module):
        @fnn.compact
        def __call__(self, ids, train: bool = False):
            _, pooled = JBertModule(config, name="bert")(ids, train=train)
            return fnn.Dense(2, name="classifier")(pooled)
    return JClassifier()


def _bert_data(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, SMALL["vocab"], (n, LENGTH)).astype(np.int32),
            rng.randint(0, 2, n).astype(np.int32))


def test_flash_bert_classifier_fit_matches_jax(jax_api):
    fnn, JEstimator, JAdam = jax_api
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig
    ids, labels = _bert_data(24, 7)
    jest = JEstimator.from_flax(
        model=_jax_flash_classifier(fnn, JConfig(use_flash=True, **SMALL)),
        loss=LOSS, optimizer=JAdam(1e-3), sample_input=ids[:2])
    module = _ClassifierModule(BertConfig(use_flash=True, **SMALL), 2)
    module.load_state_dict(flax_to_state_dict(jest.adapter.params))
    test = Estimator.from_torch(model=module, loss=LOSS, optimizer="adam",
                                device="cpu")
    want = jest.fit((ids, labels), epochs=2, batch_size=8)
    got = test.fit((ids, labels), epochs=2, batch_size=8)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the key projection's bias shifts every score of a query alike, which
    # softmax ignores: its gradient is zero but for rounding, and Adam
    # turns that noise into steps of about lr each way, so it is held to
    # the distance 6 steps can go from its initial zero (3 lr a step, a
    # bound on |mu_hat| / sqrt(nu_hat) here)
    _params_close(module, jest.get_model(), noise_only=("key/bias",),
                  bound=6 * 3 * 1e-3)


def test_bert_classifier_matches_jax(jax_api):
    from analytics_zoo_tpu.text import estimators as jtext
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig
    jclf = jtext.BERTClassifier(2, config=JConfig(**SMALL), seq_len=LENGTH,
                                metrics=["accuracy"])
    clf = BERTClassifier(2, config=BertConfig(**SMALL), seq_len=LENGTH,
                         metrics=["accuracy"], device="cpu")
    clf.estimator.model.load_state_dict(
        flax_to_state_dict(jclf.estimator.adapter.params))
    ids, labels = _bert_data(24, 8)
    rng = np.random.RandomState(9)
    seg = (np.arange(LENGTH)[None] >= rng.randint(2, LENGTH, (24, 1))
           ).astype(np.int32)
    mask = (np.arange(LENGTH)[None] < rng.randint(6, LENGTH + 1, (24, 1))
            ).astype(np.int32)
    want = jclf.fit(ids, labels, token_type_ids=seg, input_mask=mask,
                    epochs=1, batch_size=8)
    got = clf.fit(ids, labels, token_type_ids=seg, input_mask=mask,
                  epochs=1, batch_size=8)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    ids_e, labels_e = _bert_data(11, 10)
    jev = jclf.evaluate(ids_e, labels_e, batch_size=8)
    ev = clf.evaluate(ids_e, labels_e, batch_size=8)
    np.testing.assert_allclose(ev["loss"], jev["loss"], rtol=1e-5)
    assert ev["accuracy"] == pytest.approx(jev["accuracy"])
    np.testing.assert_allclose(
        clf.predict(ids_e, batch_size=8),
        np.asarray(jclf.predict(ids_e, batch_size=8)), rtol=0, atol=1e-5)


# ------------------------------------------------------------- engine rules

def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Estimator.from_torch(model=MLP(), loss=LOSS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BERTClassifier(2, config=BertConfig(**SMALL))


def test_unported_options_raise(tmp_path):
    # pipeline parallelism is not ported; fsdp on one rank shards nothing
    with pytest.raises(NotImplementedError, match="ROADMAP A9's third"):
        Estimator.from_torch(model=MLP(), loss=LOSS, strategy="pp",
                             device="cpu")
    assert Estimator.from_torch(model=MLP(), loss=LOSS, strategy="fsdp",
                                device="cpu")._shards == {}
    # model_dir is ported: fit snapshots there (EveryEpoch by default)
    est = Estimator.from_torch(model=MLP(), loss=LOSS, device="cpu",
                               model_dir=str(tmp_path / "m"))
    x, y = _mlp_data(32, 3)
    est.fit((x, y), epochs=2, batch_size=16)
    assert Estimator.latest_checkpoint(str(tmp_path / "m")).endswith(
        "ckpt-4")


def _dropout_classifier(seed=0):
    from analytics_zoo_tpu_torch.text import init_bert_weights
    cfg = dict(SMALL, hidden_drop=0.1, attn_drop=0.1)
    return init_bert_weights(_ClassifierModule(BertConfig(**cfg), 2), seed)


def test_dropout_is_seeded_by_step_and_leaves_the_callers_rng_alone():
    ids, labels = _bert_data(16, 11)
    runs = []
    for _ in range(2):
        est = Estimator.from_torch(model=_dropout_classifier(), loss=LOSS,
                                   device="cpu", seed=4)
        torch.manual_seed(123)
        before = torch.get_rng_state()
        est.fit((ids, labels), epochs=1, batch_size=8)
        assert torch.equal(torch.get_rng_state(), before)
        runs.append(list(est.step_losses))
    assert runs[0] == runs[1]
    # dropout is on: the step's loss differs from the loss in eval mode
    est = Estimator.from_torch(model=_dropout_classifier(), loss=LOSS,
                               device="cpu", seed=4)
    eval_loss = est.evaluate((ids[:8], labels[:8]), batch_size=8)["loss"]
    assert abs(runs[0][0] - eval_loss) > 1e-6


def test_save_and_load_restore_training(tmp_path):
    x, y = _mlp_data(48, 12)
    torch.manual_seed(0)
    a = Estimator.from_torch(model=MLP(), loss=LOSS, optimizer="adam",
                             device="cpu")
    a.fit((x, y), epochs=1, batch_size=16)
    a.save(str(tmp_path / "ckpt"))
    # the JAX package's layout: ckpt-<step>/state.msgpack + meta.json
    assert sorted(os.listdir(tmp_path / "ckpt" / "ckpt-3")) == [
        "meta.json", "state.msgpack"]
    b = Estimator.from_torch(model=MLP(), loss=LOSS, optimizer="adam",
                             device="cpu").load(str(tmp_path / "ckpt"))
    assert b._py_step == a._py_step == 3 and b._epoch == 1
    np.testing.assert_array_equal(b.predict(x), a.predict(x))
    # the optimizer state and the epoch (which picks the shuffle) came back
    np.testing.assert_array_equal(
        b.fit((x, y), epochs=1, batch_size=16)["loss"],
        a.fit((x, y), epochs=1, batch_size=16)["loss"])


def test_predict_returns_every_output_of_a_multi_output_model():
    class Two(nn.Module):
        def forward(self, a, b):
            return a + b, a * b
    est = Estimator.from_torch(model=Two(), loss="mse", device="cpu")
    a = np.arange(10, dtype=np.float32)[:, None]
    s, p = est.predict((a, a), batch_size=4)
    np.testing.assert_array_equal(s, 2 * a)
    np.testing.assert_array_equal(p, a * a)


def test_unused_parameters_get_zero_gradients():
    class Partly(nn.Module):
        def __init__(self):
            super().__init__()
            self.used = nn.Linear(2, 1)
            self.unused = nn.Linear(2, 1)

        def forward(self, x):
            return self.used(x)
    torch.manual_seed(1)
    module = Partly()
    before = module.unused.weight.detach().clone()
    est = TorchEstimator(module, loss="mse", optimizer="sgd", device="cpu")
    x = np.ones((4, 2), np.float32)
    est.fit((x, np.zeros((4, 1), np.float32)), batch_size=4)
    assert torch.equal(module.unused.weight, before)


def test_a_step_applies_the_loss_and_gradients_it_reports():
    # _loss_and_grads is the step's own loss and gradients: SGD moves each
    # parameter by lr times them, and the batch given as tensors gives
    # what the numpy batch gives
    from analytics_zoo_tpu_torch.learn.optimizers import SGD
    x, y = _mlp_data(16, 5)
    torch.manual_seed(0)
    est = TorchEstimator(MLP(), loss=LOSS, optimizer=SGD(0.5), device="cpu")
    before = [p.detach().clone() for p in est._params]
    loss, grads = est._loss_and_grads(torch.from_numpy(x),
                                      torch.from_numpy(y))
    assert float(est._train_step(x, y)) == float(loss)
    for b, g, p in zip(before, grads, est._params):
        torch.testing.assert_close(p.detach(), b - 0.5 * g, rtol=0,
                                   atol=1e-7)
        assert float(g.abs().max()) > 0


def test_bert_classifier_load_hf_replaces_the_encoder(tmp_path):
    transformers = pytest.importorskip("transformers")
    from analytics_zoo_tpu_torch.text import hf_bert_params
    cfg = dict(SMALL, intermediate_size=128)
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=cfg["vocab"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["n_block"], num_attention_heads=cfg["n_head"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_len"]))
    clf = BERTClassifier(2, config=BertConfig(**cfg), seq_len=LENGTH,
                         device="cpu")
    ids, labels = _bert_data(8, 13)
    clf.fit(ids, labels, batch_size=8)
    head = clf.estimator.model.classifier.weight.detach().clone()
    path = str(tmp_path / "hf.pt")
    torch.save({f"bert.{k}": v for k, v in hf.state_dict().items()}, path)
    assert clf.load_hf(path) is clf
    want = hf_bert_params(hf, BertConfig(**cfg))
    got = clf.estimator.model.bert.state_dict()
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert torch.equal(got[key], val), key
    assert torch.equal(clf.estimator.model.classifier.weight, head)
    # the optimizer state starts afresh, as in the JAX estimator
    assert clf.estimator._opt_state is None
    assert np.isfinite(clf.fit(ids, labels, batch_size=8)["loss"]).all()
