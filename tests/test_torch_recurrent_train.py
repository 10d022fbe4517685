"""Training through the port's recurrent layers against the JAX package's,
on the CPU.

Each model is built the same way in both packages from the same
parameters (the JAX model's initial tree through
``convert.flax_to_state_dict``) and trained on the same numpy data in the
same batch order (the estimators shuffle alike), with Adam and with SGD:

- a keras ``Sequential`` with one ``GRU``, ``LSTM`` or ``SimpleRNN`` of 8
  units over 6 steps of 3 features, its last output (``last``), all its
  outputs (``sequences``, flattened) or its last output read backwards
  (``backwards``, ``go_backwards=True``), into ``Dense(2)``; mse, batch
  16, 4 steps an epoch, 2 epochs;
- ``Seq2Seq.fit`` (LSTM and GRU, hidden 16, encoder 6, decoder 4, as the
  JAX test ``tests/test_model_zoo.py`` fits it), mse, batch 16, 2 steps
  an epoch, 3 epochs.

Held: the loss of each epoch within rtol 1e-5 (measured: 1.2e-7); after
SGD every parameter within atol 1e-6 (measured: 1.8e-7); after Adam within
atol 1e-5 in all but 1% of each leaf's elements and within 2 lr per step
everywhere (measured: 4.0e-7 at most, no element past 1e-5): the scheme of
tests/test_torch_keras_train.py.
Back-propagation through time adds rounding at every step, and the port's
GRU computes the gates of a side as one product where flax's GRUCell
computes one product a gate; at these sizes the measured distances stay
inside the NCF limits. Then ``evaluate`` (loss rtol 1e-5) and
``predict`` (atol 1e-6). JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.keras import Sequential
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.learn.optimizers import SGD, Adam
from analytics_zoo_tpu_torch.models import Seq2Seq

STEPS, FEATURES, UNITS = 6, 3, 8
BATCH, ROWS, EPOCHS = 16, 64, 2
LR = {"adam": 1e-2, "sgd": 0.1}
S2S = dict(input_dim=3, output_dim=2, hidden_size=16, num_layers=1,
           encoder_seq_len=6, decoder_seq_len=4)
S2S_ROWS, S2S_EPOCHS = 32, 3


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
    from analytics_zoo_tpu.keras import Sequential as JSequential
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models import Seq2Seq as JSeq2Seq
    return dict(jax=jax, Sequential=JSequential, layers=jl,
                Seq2Seq=JSeq2Seq, opt={"adam": JAdam, "sgd": JSGD})


def rnn_model(Sequential, layers, cell, variant):
    """``Sequential`` of one recurrent layer into ``Dense(2)``, from either
    package's layers."""
    net = Sequential()
    net.add(getattr(layers, cell)(
        UNITS, return_sequences=variant == "sequences",
        go_backwards=variant == "backwards",
        input_shape=(STEPS, FEATURES)))
    if variant == "sequences":
        net.add(layers.Flatten())
    net.add(layers.Dense(2))
    return net


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_params(tnet, jparams, opt, lr, steps):
    """The NCF scheme: SGD within 1e-6; Adam within 1e-5 in all but 1% of
    each leaf and within 2 lr per step everywhere."""
    got = dict(_leaves(state_dict_to_flax(tnet.module.state_dict(),
                                          jparams)))
    for path, want in _leaves(jparams):
        diff = np.abs(got[path] - want)
        if opt == "sgd":
            assert diff.max() <= 1e-6, (path, diff.max())
        else:
            assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
            assert diff.max() <= 2 * lr * steps, (path, diff.max())


def compile_pair(jax_api, jnet, tnet, opt, lr, loss="mse"):
    jnet.compile(optimizer=jax_api["opt"][opt](lr), loss=loss)
    tnet.module.load_state_dict(flax_to_state_dict(
        jax_api["jax"].device_get(jnet.get_weights())))
    tnet.compile(optimizer=Adam(lr) if opt == "adam" else SGD(lr),
                 loss=loss, device="cpu")


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("variant", ["last", "sequences", "backwards"])
@pytest.mark.parametrize("cell", ["GRU", "LSTM", "SimpleRNN"])
def test_recurrent_fit_matches_jax(jax_api, cell, variant, opt):
    jnet = rnn_model(jax_api["Sequential"], jax_api["layers"], cell, variant)
    tnet = rnn_model(Sequential, tl, cell, variant)
    compile_pair(jax_api, jnet, tnet, opt, LR[opt])
    rng = np.random.RandomState(0)
    x = rng.randn(ROWS, STEPS, FEATURES).astype(np.float32)
    y = rng.randn(ROWS, 2).astype(np.float32)
    want = jnet.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    got = tnet.fit(x, y, batch_size=BATCH, nb_epoch=EPOCHS)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_params(tnet, jax_api["jax"].device_get(jnet.get_weights()), opt,
                  LR[opt], EPOCHS * ROWS // BATCH)
    xe = rng.randn(20, STEPS, FEATURES).astype(np.float32)
    ye = rng.randn(20, 2).astype(np.float32)
    np.testing.assert_allclose(
        tnet.evaluate(xe, ye, batch_size=BATCH)["loss"],
        jnet.evaluate(xe, ye, batch_size=BATCH)["loss"], rtol=1e-5)
    np.testing.assert_allclose(tnet.predict(xe), np.asarray(
        jnet.predict(xe)), rtol=0, atol=1e-6)


def _s2s_data(seed):
    rng = np.random.RandomState(seed)
    enc = rng.randn(S2S_ROWS, 6, 3).astype(np.float32)
    dec = rng.randn(S2S_ROWS, 4, 2).astype(np.float32)
    tgt = rng.randn(S2S_ROWS, 4, 2).astype(np.float32)
    return enc, dec, tgt


@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
def test_seq2seq_fit_matches_jax(jax_api, rnn_type, opt):
    jm = jax_api["Seq2Seq"](rnn_type=rnn_type, **S2S)
    tm = Seq2Seq(rnn_type=rnn_type, **S2S)
    compile_pair(jax_api, jm.model, tm.model, opt, LR[opt])
    enc, dec, tgt = _s2s_data(0)
    want = jm.fit([enc, dec], tgt, batch_size=16, nb_epoch=S2S_EPOCHS)
    got = tm.fit([enc, dec], tgt, batch_size=16, nb_epoch=S2S_EPOCHS)
    assert len(got["loss"]) == S2S_EPOCHS
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_params(tm.model, jax_api["jax"].device_get(jm.model.get_weights()),
                  opt, LR[opt], S2S_EPOCHS * S2S_ROWS // 16)
    out = tm.predict([enc, dec])
    assert out.shape == (S2S_ROWS, 4, 2)
    np.testing.assert_allclose(out, np.asarray(jm.predict([enc, dec])),
                               rtol=0, atol=1e-6)


def test_seq2seq_fit_then_infer(jax_api):
    """After a fit, ``infer`` runs on what the fit left: the raw feedback
    of both packages agrees."""
    jm = jax_api["Seq2Seq"](rnn_type="gru", **S2S)
    tm = Seq2Seq(rnn_type="gru", **S2S)
    compile_pair(jax_api, jm.model, tm.model, "sgd", LR["sgd"])
    enc, dec, tgt = _s2s_data(1)
    jm.fit([enc, dec], tgt, batch_size=16, nb_epoch=1)
    tm.fit([enc, dec], tgt, batch_size=16, nb_epoch=1)
    start = np.zeros((2, 2), np.float32)
    got = tm.infer(enc[:2], start_sign=start, max_seq_len=4)
    assert got.shape == (2, 3, 2)
    np.testing.assert_allclose(got, np.asarray(jm.infer(
        enc[:2], start_sign=start, max_seq_len=4)), rtol=0, atol=1e-5)
