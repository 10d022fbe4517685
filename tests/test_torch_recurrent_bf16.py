"""The recurrent layers and forecasters under ``mixed_bfloat16`` against
the JAX package's, on the CPU.

flax's cells with ``dtype=bfloat16`` cast each Dense's input, kernel and
bias to bf16, keep the carry in the parameters' dtype (fp32) and so give
fp32 outputs; the port's cells do the same, dtype for dtype. Each case is
built in both packages under the policy from the same parameters
(``convert.flax_to_state_dict``) and run on the same numpy inputs; the
reference is the port's fp32 model of those parameters run in float64.

Held:
- the outputs are fp32 in both packages;
- the port's distance from float64 is at most 1.5x JAX's own (plus 1e-6,
  for cases where both are tiny; measured 0.69x-1.14x over 48 steps of
  16 units: LSTM 6.2e-3 against JAX's 6.5e-3, GRU 8.5e-3 against 8.9e-3);
- port against JAX within 3x JAX's distance from float64 (both round
  every gate to bf16, so they sit about as far from each other as from
  float64; measured at most 1.22x).
``SimpleRNN``'s new carry is its bf16 activation, which flax's scan
refuses (``TypeError``): the port refuses it alike, and one bf16
``SimpleCell`` step, outside the scan, agrees with flax's within one bf16
ulp of its output (2^-8 relative at [0.5, 1), atol 4e-3 on tanh outputs).
The forecasters under ``mixed_bfloat16``: predict as above, and two fit
steps' losses within 1e-2 relative of JAX's (bf16 gates; measured
3.9e-5). JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input, Model, policy
from analytics_zoo_tpu_torch.keras import layers as tl

STEPS, FEATURES, UNITS, BATCH = 48, 6, 16, 8


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
def jx():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.inference import InferenceModel
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import Model as JModel
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.keras import policy as jpolicy
    return dict(jax=jax, IM=InferenceModel, Input=JInput, Model=JModel,
                layers=jl, policy=jpolicy)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(BATCH, STEPS, FEATURES)).astype(np.float32)


def _graph(lib, inp, mdl, layer, **kw):
    x = inp(shape=(STEPS, FEATURES))
    if layer == "Bidirectional":
        y = lib.Bidirectional(lib.LSTM(UNITS, return_sequences=True))(x)
    else:
        y = getattr(lib, layer)(UNITS, return_sequences=True, **kw)(x)
    return mdl(input=x, output=y)


def _jax_bf16(jx, layer, x, **kw):
    with jx["policy"].policy_scope("mixed_bfloat16"):
        m = _graph(jx["layers"], jx["Input"], jx["Model"], layer, **kw)
    im = jx["IM"]().load_zoo(m)
    out = np.asarray(im.predict(x))
    return out, jx["jax"].device_get(im._params["params"])


def _port(layer, params, name="float32", **kw):
    with policy.policy_scope(name):
        m = _graph(tl, Input, Model, layer, **kw)
    m.module.load_state_dict(convert.flax_to_state_dict(params))
    return m


def _float64(layer, params, x, **kw):
    m = _port(layer, params, **kw).module.double().eval()
    with torch.no_grad():
        return m(torch.from_numpy(x.astype(np.float64))).numpy()


def _dist(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max())


@pytest.mark.parametrize("layer,kw", [
    ("LSTM", {}), ("GRU", {}), ("LSTM", {"go_backwards": True}),
    ("Bidirectional", {})])
def test_bf16_recurrent_layer_matches_jax(jx, layer, kw):
    x = _inputs()
    want, params = _jax_bf16(jx, layer, x, **kw)
    port = _port(layer, params, "mixed_bfloat16", **kw)
    with torch.no_grad():
        out = port.module(torch.from_numpy(x))
    assert out.dtype == torch.float32 and want.dtype == np.float32
    got = out.numpy()
    ref = _float64(layer, params, x, **kw)
    d_port, d_jax = _dist(got, ref), _dist(want, ref)
    assert d_port <= 1.5 * d_jax + 1e-6, (d_port, d_jax)
    assert _dist(got, want) <= 3 * d_jax, (_dist(got, want), d_jax)
    # bf16 rounding shows at all: the policy was applied
    assert d_jax > 1e-4


def test_bf16_carry_stays_fp32():
    """The carry starts in the parameters' dtype whatever the input's,
    and an fp32 carry stays fp32 through bf16 gates."""
    g = torch.Generator().manual_seed(0)
    for cls in (tl.OptimizedLSTMCellModule, tl.GRUCellModule):
        cell = cls(3, 4, torch.tanh, g, dtype=torch.bfloat16)
        x = torch.randn(2, 5, 3, generator=g).to(torch.bfloat16)
        assert tl.run_cell(cell, x).dtype == torch.float32
        carry = cell.init_carry(x[:, 0])
        leaves = carry if isinstance(carry, tuple) else (carry,)
        assert all(t.dtype == torch.float32 for t in leaves)


def test_bf16_simple_rnn_is_refused_as_in_jax(jx):
    x = _inputs()
    with pytest.raises(TypeError, match="carry"):
        _jax_bf16(jx, "SimpleRNN", x)
    with policy.policy_scope("mixed_bfloat16"):
        m = _graph(tl, Input, Model, "SimpleRNN")
    with pytest.raises(TypeError, match="carry"):
        m.predict(x, device="cpu")


def test_bf16_simple_cell_step_matches_flax(jx):
    import flax.linen as fnn
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    x = rng.normal(size=(BATCH, FEATURES)).astype(np.float32)
    h = rng.normal(size=(BATCH, UNITS)).astype(np.float32) * 0.5
    cell = fnn.SimpleCell(features=UNITS, dtype=jnp.bfloat16)
    params = cell.init(jx["jax"].random.PRNGKey(0), h, x)["params"]
    _, want = cell.apply({"params": params}, h, x)
    port = tl.SimpleCellModule(FEATURES, UNITS, torch.tanh,
                               torch.Generator(), dtype=torch.bfloat16)
    port.load_state_dict(convert.flax_to_state_dict(
        jx["jax"].device_get(params)))
    with torch.no_grad():
        got = port.step(torch.from_numpy(x), torch.from_numpy(h),
                        port.weights())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=4e-3)


# ------------------------------------------------------------ forecasters

def _series(n=96, lookback=24, horizon=2):
    t = np.arange(n + lookback + horizon, dtype=np.float32)
    s = np.stack([np.sin(t / 7), np.cos(t / 5)], 1).astype(np.float32)
    idx = np.arange(lookback)[None, :] + np.arange(n)[:, None]
    x = s[idx]
    y = np.stack([s[i + lookback:i + lookback + horizon, 0]
                  for i in range(n)]).astype(np.float32)
    return x, y


def _forecasters(kind):
    from analytics_zoo_tpu.zouwu.model import forecast as jf
    from analytics_zoo_tpu_torch.zouwu.model import forecast as tf
    if kind == "lstm":
        kw = dict(target_dim=2, lstm_units=(16, 8), dropouts=(0.0,))
        return (jf.LSTMForecaster(dtype="mixed_bfloat16", **kw),
                tf.LSTMForecaster(dtype="mixed_bfloat16", device="cpu",
                                  **kw),
                tf.LSTMForecaster(device="cpu", **kw))
    kw = dict(future_seq_len=2, latent_dim=16, dropout=0.0)
    return (jf.Seq2SeqForecaster(dtype="mixed_bfloat16", **kw),
            tf.Seq2SeqForecaster(dtype="mixed_bfloat16", device="cpu", **kw),
            tf.Seq2SeqForecaster(device="cpu", **kw))


@pytest.mark.parametrize("kind", ["lstm", "seq2seq"])
def test_bf16_forecasters_match_jax(jx, kind):
    jf, tf, t32 = _forecasters(kind)
    x, y = _series()
    params = jx["jax"].device_get(jf._ensure_est(x).adapter.params)
    for f in (tf, t32):
        f._ensure_est(x).model.load_state_dict(
            convert.flax_to_state_dict(params))
    want = np.asarray(jf.predict(x))
    got = tf.predict(x)
    assert got.dtype == np.float32
    net = t32._est.model.double().eval()
    with torch.no_grad():
        ref = net(torch.from_numpy(x.astype(np.float64))).numpy()
    d_port, d_jax = _dist(got, ref), _dist(want, ref)
    assert d_port <= 1.5 * d_jax + 1e-6, (d_port, d_jax)
    assert _dist(got, want) <= 3 * d_jax, (_dist(got, want), d_jax)
    # two fit steps from the same start
    jl = jf.fit(x[:64], y[:64], epochs=1, batch_size=32)
    tl_ = tf.fit(x[:64], y[:64], epochs=1, batch_size=32)
    np.testing.assert_allclose(np.ravel(tl_["loss"]), np.ravel(jl["loss"]),
                               rtol=1e-2)
