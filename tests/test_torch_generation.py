"""The port's decode building blocks against the JAX package's: the
seq-length ladder and bucketed cache, the feedback modes and the sampling
rng contract, ``decode_loop``, the recurrent layers and the ``Seq2Seq``
forward (from the same parameters, via ``convert``), and greedy
``generate`` through ``InferenceModel``.

Tolerances: the recurrent layers and Seq2Seq agree with flax within fp32
rounding (atol 1e-5 on outputs of order 1: the port runs each side's
gates as one product, flax's GRUCell as three). Greedy generation compares
one-hot sequences, which is exact only where no step has a near tie, so
the test first checks that JAX's top-2 margin exceeds 1e-4 at every step.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.common import compile_ahead
from analytics_zoo_tpu_torch.inference import InferenceModel, generation
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.models import Seq2Seq

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_gen():
    return pytest.importorskip("analytics_zoo_tpu.inference.generation")


def _jax_params(jax_model, sample):
    """A JAX keras model's flax params as numpy, built on ``sample``."""
    import jax
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    jim = JIM().load_zoo(jax_model)
    jim.predict(sample)
    return jim, jax.device_get(jim._params["params"])


# ----------------------------------------------------------- ladder, cache

def test_seq_ladder_and_cache_rungs():
    lad = generation.seq_ladder(33, min_rung=2)
    assert lad.rungs[0] == 2 and lad.rungs[-1] >= 33
    assert generation.seq_ladder(4).rungs[0] <= 4
    c = generation.BucketedKVCache(3, 5, compile_ahead.BucketLadder(2, 16))
    rungs = []
    for i in range(9):
        c.append(np.full((3, 5), float(i + 1), np.float32))
        rungs.append(c.rung)
    assert rungs == [2, 2, 4, 4, 8, 8, 8, 8, 16]
    assert not c.view()[:, 9:].any() and np.all(c.view()[:, 8] == 9.0)
    exact = generation.BucketedKVCache(2, 3)
    for i in range(4):
        exact.append(np.zeros((2, 3), np.float32))
        assert exact.rung == i + 1


# ------------------------------------------------------- feedback, sampling

@pytest.mark.parametrize("mode", generation.MODES)
def test_feedback_rows_match_jax(jax_gen, mode):
    vec = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    got = generation.feedback_rows(vec, mode, 0.7,
                                   np.random.default_rng(9))
    want = jax_gen.feedback_rows(vec, mode, 0.7, np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)


def test_sample_token_ids_one_draw_per_call():
    vec = np.random.default_rng(0).normal(size=(4, 6))
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    ids = generation.sample_token_ids(vec, 0.7, a)
    assert ids.shape == (4,)
    b.random(vec.shape)
    assert a.bit_generator.state == b.bit_generator.state


def _numpy_step(dim=6):
    """Causal, row-independent numpy decoder (JAX's scheduler tests')."""
    w = np.random.default_rng(0).normal(size=(dim, dim)).astype(np.float32)

    def fn(enc, dec):
        csum = np.cumsum(np.asarray(dec, np.float32), axis=1)
        return np.tanh(csum @ w + np.asarray(enc, np.float32)[:, None, :])
    return fn


@pytest.mark.parametrize("mode", generation.MODES)
@pytest.mark.parametrize("steps", [1, 4, 9])
def test_decode_loop_matches_jax_and_padding_is_bitwise(jax_gen, mode,
                                                        steps):
    """Bitwise against JAX's decode_loop on the same step function, and
    rung-padded equal to exact-length (causality)."""
    fn = _numpy_step()
    enc = np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32)
    start = np.eye(6, dtype=np.float32)[:3]
    kw = dict(mode=mode, temperature=0.7, seed=5)
    lad = generation.seq_ladder(steps + 1, min_rung=2)
    before = generation.decode_steps()
    padded = generation.decode_loop(fn, enc, start, steps, ladder=lad, **kw)
    assert generation.decode_steps() == before + 3 * steps
    exact = generation.decode_loop(fn, enc, start, steps, ladder=None, **kw)
    want = jax_gen.decode_loop(fn, enc, start, steps,
                               ladder=jax_gen.seq_ladder(steps + 1,
                                                         min_rung=2), **kw)
    np.testing.assert_array_equal(padded, exact)
    np.testing.assert_array_equal(padded, want)


# ------------------------------------------------------ recurrent layers

@pytest.mark.parametrize("layer,return_sequences,go_backwards", [
    ("GRU", True, False), ("GRU", False, True), ("LSTM", True, True),
    ("LSTM", False, False), ("SimpleRNN", True, False),
    ("SimpleRNN", False, True)])
def test_recurrent_layers_match_jax(layer, return_sequences, go_backwards):
    from analytics_zoo_tpu.keras import Input as JInput, Model as JModel
    from analytics_zoo_tpu.keras import layers as jl

    def build(lib, inp, mdl):
        x = inp(shape=(5, 3))
        h = getattr(lib, layer)(4, return_sequences=True)(x)
        y = getattr(lib, layer)(6, return_sequences=return_sequences,
                                go_backwards=go_backwards)(h)
        return mdl(input=x, output=y)

    x = np.random.default_rng(2).normal(size=(2, 5, 3)).astype(np.float32)
    jim, params = _jax_params(build(jl, JInput, JModel), x)
    port = build(tl, Input, Model)
    port.module.load_state_dict(convert.flax_to_state_dict(params))
    got = port.predict(x, device="cpu")
    want = np.asarray(jim.predict(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # and back: the port's state dict rebuilds JAX's tree
    back = convert.state_dict_to_flax(port.module.state_dict(), params)
    for cell in params:
        for gate in params[cell]:
            for leaf in params[cell][gate]:
                np.testing.assert_array_equal(back[cell][gate][leaf],
                                              params[cell][gate][leaf])


# ----------------------------------------------------------------- Seq2Seq

def _seq2seq_pair(rnn_type, num_layers=1, hidden=8, dim=4, enc_len=5):
    from analytics_zoo_tpu.models import Seq2Seq as JSeq2Seq
    kw = dict(input_dim=dim, output_dim=dim, hidden_size=hidden,
              rnn_type=rnn_type, num_layers=num_layers,
              encoder_seq_len=enc_len, decoder_seq_len=4)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, enc_len, dim)).astype(np.float32)
    jim, params = _jax_params(JSeq2Seq(**kw),
                              (enc, np.zeros((2, 1, dim), np.float32)))
    port = Seq2Seq(**kw)
    port.model.module.load_state_dict(convert.flax_to_state_dict(params))
    return jim, port, enc


@pytest.mark.parametrize("rnn_type,num_layers", [("gru", 1), ("lstm", 2)])
def test_seq2seq_forward_matches_jax(rnn_type, num_layers):
    jim, port, enc = _seq2seq_pair(rnn_type, num_layers)
    dec = np.random.default_rng(4).normal(size=(2, 7, 4)).astype(np.float32)
    got = port.predict((enc, dec), device="cpu")
    want = np.asarray(jim.predict((enc, dec)))
    assert got.shape == (2, 7, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_seq2seq_save_load_and_fit(tmp_path):
    m = Seq2Seq(input_dim=3, output_dim=3, hidden_size=4, rnn_type="gru",
                encoder_seq_len=2)
    m.save_model(str(tmp_path / "s2s"))
    # the JAX package's layout: config.json + weights/ckpt-<step>/
    assert sorted(os.listdir(tmp_path / "s2s")) == ["config.json",
                                                    "weights"]
    assert os.listdir(tmp_path / "s2s" / "weights") == ["ckpt-0"]
    back = Seq2Seq.load_model(str(tmp_path / "s2s"))
    for k, v in m.model.module.state_dict().items():
        assert torch.equal(v, back.model.module.state_dict()[k])
    assert back._config() == m._config()
    # fit as the keras models fit: compile first (training parity with
    # JAX is held in tests/test_torch_recurrent_train.py)
    rng = np.random.RandomState(0)
    enc = rng.randn(8, 2, 3).astype(np.float32)
    dec = rng.randn(8, 2, 3).astype(np.float32)
    with pytest.raises(RuntimeError, match="compile"):
        back.fit([enc, dec], dec, batch_size=4)
    back.compile(optimizer="sgd", loss="mse", device="cpu")
    hist = back.fit([enc, dec], dec, batch_size=4, nb_epoch=2)
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    with pytest.raises(ValueError, match="lstm|gru"):
        Seq2Seq(input_dim=3, output_dim=3, rnn_type="rnn")


def test_greedy_generate_matches_jax_with_margin():
    """Greedy ``generate`` and ``Seq2Seq.infer`` equal JAX's, token for
    token; raw generation within 1e-4 over 10 fed-back steps."""
    jim, port, enc = _seq2seq_pair("gru", hidden=16)
    start = np.zeros((2, 4), np.float32)
    start[:, 0] = 1.0
    steps = 10
    margins = []
    jstep = jim.decode_step_fn()

    def watched(e, d):
        out = np.asarray(jstep(e, d))
        top = np.sort(out[:, len(margins), :], axis=-1)
        margins.append(float((top[:, -1] - top[:, -2]).min()))
        return out

    from analytics_zoo_tpu.inference import generation as jgen
    want = jgen.decode_loop(watched, enc, start, steps, ladder=None,
                            mode="greedy")
    assert min(margins) > 1e-4, margins
    im = InferenceModel(device="cpu").load_zoo(port)
    np.testing.assert_array_equal(im.generate(enc, start, steps), want)
    np.testing.assert_array_equal(
        port.infer(enc, start, steps + 1, mode="greedy", device="cpu"),
        np.asarray(jim.generate(enc, start, steps)))
    raw = im.generate(enc, start, steps, mode="raw")
    np.testing.assert_allclose(
        raw, np.asarray(jim.generate(enc, start, steps, mode="raw")),
        atol=1e-4, rtol=0)
