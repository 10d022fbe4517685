"""Zouwu's forecasting nets and forecasters in the port against the JAX
package's, on the CPU.

- ``flax_compat.Conv`` against flax ``nn.Conv`` (dilations 1, 2 and 4,
  kernels 3 and 7, widths in != out; fp32 and bf16), from the same
  kernel: fp32 within 1e-6, bf16 within 3e-2 (measured: equal, both).
- ``TemporalConvNet``'s forward at ``bench.py``'s ``measure_tcn`` width
  (channels (32, 32, 32), kernel 7, 96 steps, 8 features, batch 256)
  against JAX's with the parameters carried across: within 1e-5; the
  LSTM and Seq2Seq nets likewise (measured 9.5e-7 at worst).
- ``convert.flax_layout`` of each net equals ``jax.eval_shape`` of its
  flax ``init``.
- Fits at dropout 0: JAX's ``Estimator.from_flax`` against the port's
  ``from_torch`` from the same parameters and data (Adam 1e-2, mse, 3
  epochs of 6 steps): epoch losses within rtol 1e-5 and every parameter
  within atol 1e-5 (the NCF limits), then ``predict`` within 1e-5.
  Measured (JAX on its 8 virtual devices): losses within 8.4e-8
  relative, parameters and predictions within 3.4e-7.
- JAX's ``TestForecasters`` mirrored; a ``TCNForecaster`` saved by JAX
  (``tests/data/jax_checkpoints/tcn``, written by
  ``dev/make_jax_checkpoints.py``) restores in the port and predicts
  within 1e-5 of JAX's stored forecasts, and one saved by the port
  restores in JAX within 1e-5 (measured 4.8e-7 both ways);
  ``Evaluator`` gives JAX's values exactly.
- Dropout 0.2 cannot match JAX's bits: training differs from
  evaluation, and ``predict`` is deterministic.

JAX is imported by fixtures only.
"""

import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.automl.metrics import Evaluator
from analytics_zoo_tpu_torch.common.context import OrcaContext
from analytics_zoo_tpu_torch.common.flax_compat import Conv
from analytics_zoo_tpu_torch.convert import (flax_layout, flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.data import XShards
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.optimizers import Adam
from analytics_zoo_tpu_torch.zouwu.model import (LSTMForecaster,
                                                 Seq2SeqForecaster,
                                                 TCNForecaster)
from analytics_zoo_tpu_torch.zouwu.model.nets import (Seq2SeqNet,
                                                      TemporalConvNet,
                                                      VanillaLSTMNet)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jax_checkpoints")
LR = 1e-2
BENCH_TCN = dict(num_channels=(32, 32, 32), kernel_size=7)


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    OrcaContext.train_data_store = "DRAM"


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import flax.linen as fnn
    import jax
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.zouwu.model import forecast, nets
    return dict(jax=jax, nn=fnn, Estimator=JEstimator, Adam=JAdam,
                nets=nets, forecast=forecast)


def _xy(n=96, lookback=16, horizon=2, feats=3):
    """JAX's tests/test_zouwu.py data: a linear map of the last steps."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(n, lookback, feats)).astype(np.float32)
    y = x[:, -horizon:, 0] * 0.5 + 0.1
    return x, y.astype(np.float32)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


# ------------------------------------------------------------------ Conv

@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("kernel", [3, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_matches_flax(jx, dilation, kernel, dtype):
    jnp = jx["jax"].numpy
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    m = jx["nn"].Conv(6, (kernel,), kernel_dilation=(dilation,),
                      padding="VALID", dtype=jdt)
    x = np.random.RandomState(kernel + dilation).randn(4, 40, 5).astype(
        np.float32)
    v = m.init(jx["jax"].random.PRNGKey(dilation), x)
    want = np.asarray(m.apply(v, x).astype(jnp.float32))
    conv = Conv(5, 6, kernel, dilation, dtype=tdt)
    conv.load_state_dict(flax_to_state_dict(jx["jax"].device_get(
        v["params"])))
    got = conv(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == want.shape
    atol = 1e-6 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=atol)
    back = state_dict_to_flax(conv.state_dict(), v["params"])
    for path, want_leaf in _leaves(jx["jax"].device_get(v["params"])):
        np.testing.assert_array_equal(dict(_leaves(back))[path], want_leaf)


# ------------------------------------------------------------ the nets

def _pair(jx, kind, in_features, **kw):
    n = jx["nets"]
    if kind == "tcn":
        return n.TemporalConvNet(**kw), TemporalConvNet(in_features, **kw)
    if kind == "lstm":
        return n.VanillaLSTMNet(**kw), VanillaLSTMNet(in_features, **kw)
    return n.Seq2SeqNet(**kw), Seq2SeqNet(in_features, **kw)


NETS = {"tcn": dict(future_seq_len=2, num_channels=(8, 8), kernel_size=3,
                    dropout=0.0),
        "lstm": dict(output_dim=2, lstm_units=(8, 4), dropouts=(0.0,)),
        "s2s": dict(future_seq_len=2, latent_dim=8, dropout=0.0)}


@pytest.mark.parametrize("kind,kw", [
    ("tcn", dict(future_seq_len=1, **BENCH_TCN)),
    ("tcn", NETS["tcn"]), ("lstm", NETS["lstm"]), ("s2s", NETS["s2s"]),
    ("s2s", dict(future_seq_len=3, latent_dim=8, output_dim=2))])
def test_forward_and_layout_match_jax(jx, kind, kw):
    feats = 8 if kw.get("num_channels") == (32, 32, 32) else 3
    steps = 96 if feats == 8 else 16
    x = np.random.default_rng(2).standard_normal(
        (256 if feats == 8 else 32, steps, feats)).astype(np.float32)
    jnet, tnet = _pair(jx, kind, feats, **kw)
    jax = jx["jax"]
    v = jnet.init(jax.random.PRNGKey(0), x[:2])
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x[:2]))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  flax_layout(tnet)) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes["params"])
    tnet.load_state_dict(flax_to_state_dict(jax.device_get(v["params"])))
    want = np.asarray(jnet.apply(v, x))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["tcn", "lstm", "s2s"])
def test_fit_matches_jax_from_flax(jx, kind):
    horizon = 2
    x, y = _xy(horizon=horizon)
    jnet, tnet = _pair(jx, kind, 3, **NETS[kind])
    jest = jx["Estimator"].from_flax(model=jnet, loss="mse",
                                     optimizer=jx["Adam"](LR),
                                     sample_input=x[:1])
    tnet.load_state_dict(flax_to_state_dict(jx["jax"].device_get(
        jest.adapter.params)))
    test = Estimator.from_torch(model=tnet, loss="mse", optimizer=Adam(LR),
                                device="cpu")
    want = jest.fit((x, y), epochs=3, batch_size=16)
    got = test.fit((x, y), epochs=3, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    jparams = jx["jax"].device_get(jest.get_model())
    mine = dict(_leaves(state_dict_to_flax(tnet.state_dict(), jparams)))
    for path, leaf in _leaves(jparams):
        np.testing.assert_allclose(mine[path], leaf, rtol=0, atol=1e-5,
                                   err_msg=path)
    np.testing.assert_allclose(test.predict(x, batch_size=40),
                               np.asarray(jest.predict(x, batch_size=40)),
                               rtol=0, atol=1e-5)


def test_recurrent_nets_raise_under_bf16():
    for net in (VanillaLSTMNet, Seq2SeqNet):
        with pytest.raises(NotImplementedError, match="A8"):
            net(3, dtype=torch.bfloat16)
    f = LSTMForecaster(dtype="mixed_bfloat16", device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        f.fit(*_xy(horizon=1), epochs=1, batch_size=16)


def test_tcn_init_is_lecun_normal_with_zero_bias():
    net = TemporalConvNet(8, generator=torch.Generator().manual_seed(0),
                          **BENCH_TCN)
    w = net._TemporalBlock_1.Conv_0.weight.detach()    # fan in 7 x 32
    assert abs(float(w.std()) - (1 / (7 * 32)) ** 0.5) < 0.01
    assert float(w.abs().max()) <= 2 / 0.8796 * (1 / (7 * 32)) ** 0.5
    assert all(not b.detach().any() for n, b in net.named_parameters()
               if n.endswith("bias"))
    assert net._TemporalBlock_1.Dense_0 is None
    assert net._TemporalBlock_0.Dense_0.weight.shape == (32, 8)


# ------------------------------------------ JAX's TestForecasters, mirrored

class TestForecasters:
    def test_lstm_forecaster(self):
        x, y = _xy(horizon=1)
        f = LSTMForecaster(target_dim=1, lstm_units=(8,), dropouts=(0.0,),
                           device="cpu")
        hist = f.fit(x, y[:, :1], epochs=2, batch_size=16)
        assert len(hist["loss"]) == 2
        assert f.predict(x).shape == (len(x), 1)
        ev = f.evaluate(x, y[:, :1], metrics=["mse", "mae", "smape"])
        assert set(ev) == {"mse", "mae", "smape"}

    def test_tcn_forecaster_learns(self):
        x, y = _xy(n=128, horizon=2)
        f = TCNForecaster(future_seq_len=2, num_channels=(8, 8),
                          kernel_size=3, dropout=0.0,
                          optimizer=Adam(learningrate=0.01), device="cpu")
        f.fit(x, y, epochs=20, batch_size=16)
        assert f.evaluate(x, y)["mse"] < 0.05

    def test_tcn_forecaster_mixed_bfloat16(self):
        x, y = _xy(n=128, horizon=2)
        f = TCNForecaster(future_seq_len=2, num_channels=(8, 8),
                          kernel_size=3, dropout=0.0,
                          optimizer=Adam(learningrate=0.01),
                          dtype="mixed_bfloat16", device="cpu")
        f.fit(x, y, epochs=20, batch_size=16)
        assert f.evaluate(x, y)["mse"] < 0.08
        params = f._est.model.parameters()
        assert {p.dtype for p in params} == {torch.float32}
        assert f.predict(x).dtype == np.float32

    def test_forecaster_rejects_unknown_dtype(self):
        with pytest.raises(ValueError, match="unknown dtype"):
            LSTMForecaster(dtype="float16")

    def test_seq2seq_forecaster(self):
        x, y = _xy(horizon=3)
        f = Seq2SeqForecaster(future_seq_len=3, latent_dim=8, dropout=0.0,
                              device="cpu")
        f.fit(x, y, epochs=2, batch_size=16)
        assert f.predict(x).shape == (len(x), 3)

    def test_save_restore_roundtrip(self, tmp_path):
        x, y = _xy(horizon=1)
        f = TCNForecaster(future_seq_len=1, num_channels=(4,),
                          kernel_size=3, device="cpu")
        f.fit(x, y[:, :1], epochs=1, batch_size=16)
        p1 = f.predict(x)
        f.save(str(tmp_path / "m"))
        g = TCNForecaster(future_seq_len=1, num_channels=(4,),
                          kernel_size=3, device="cpu")
        with pytest.raises(ValueError, match="sample_x"):
            g.restore(str(tmp_path / "m"))
        with pytest.raises(RuntimeError, match="fit"):
            g.predict(x)
        g.restore(str(tmp_path / "m"), sample_x=x)
        np.testing.assert_array_equal(p1, g.predict(x))
        assert g._est._py_step == f._est._py_step == 6

    def test_forecaster_runs_on_cuda_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TCNForecaster(num_channels=(4,)).fit(*_xy(horizon=1),
                                                 batch_size=16)


def test_dropout_trains_unlike_evaluation_and_predicts_deterministically():
    x, y = _xy(horizon=1)
    net = TemporalConvNet(3, num_channels=(8, 8), kernel_size=3,
                          dropout=0.2, generator=torch.Generator(
                              ).manual_seed(1))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        ev = net(xt)
        assert torch.equal(ev, net(xt))
        assert not torch.equal(net(xt, train=True), ev)
    f = TCNForecaster(num_channels=(8, 8), kernel_size=3, device="cpu")
    f.fit(x, y[:, :1], epochs=1, batch_size=16)
    np.testing.assert_array_equal(f.predict(x), f.predict(x))


def test_fit_from_disk_shards_streams_and_matches_arrays():
    """XShards under DISK_4 (a window of 2 of 8 shards) train the same
    forecaster bitwise as the arrays do with shuffle=False."""
    x, y = _xy(n=128, horizon=2)
    ends = []
    for data in ("arrays", "disk"):
        f = TCNForecaster(future_seq_len=2, num_channels=(8, 8),
                          kernel_size=3, device="cpu")
        if data == "arrays":
            f.fit(x, y, epochs=2, batch_size=16, shuffle=False)
        else:
            OrcaContext.train_data_store = "DISK_4"
            xs = XShards.partition({"x": x, "y": y}, num_shards=8)
            f.fit(xs, epochs=2, batch_size=16, shuffle=False)
        ends.append([p.detach().clone() for p in f._est.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*ends))


# ------------------------------------------- checkpoints across packages

def test_jax_tcn_checkpoint_restores_in_the_port(jx):
    x = np.load(os.path.join(DATA, "tcn_x.npy"))
    f = TCNForecaster(future_seq_len=2, num_channels=(8, 8), kernel_size=3,
                      device="cpu")
    f.restore(os.path.join(DATA, "tcn"), sample_x=x)
    np.testing.assert_allclose(f.predict(x),
                               np.load(os.path.join(DATA, "tcn_pred.npy")),
                               rtol=0, atol=1e-5)


def test_port_tcn_checkpoint_restores_in_jax(jx, tmp_path):
    x, y = _xy(horizon=2)
    f = TCNForecaster(future_seq_len=2, num_channels=(8, 8), kernel_size=3,
                      device="cpu")
    f.fit(x, y, epochs=2, batch_size=16)
    f.save(str(tmp_path / "m"))
    g = jx["forecast"].TCNForecaster(future_seq_len=2, num_channels=(8, 8),
                                     kernel_size=3)
    g.restore(str(tmp_path / "m"), sample_x=x)
    np.testing.assert_allclose(g.predict(x), f.predict(x), rtol=0,
                               atol=1e-5)
    assert g._est._py_step == 12


# --------------------------------------------------------------- metrics

@pytest.mark.parametrize("metric", sorted(
    ["mse", "rmse", "mae", "r2", "mape", "smape", "mpe", "mspe",
     "accuracy", "logloss", "auc"]))
def test_evaluator_matches_jax(metric):
    pytest.importorskip("jax")
    from analytics_zoo_tpu.automl.metrics import Evaluator as JEvaluator
    rng = np.random.RandomState(3)
    if metric in ("accuracy", "logloss", "auc"):
        t = rng.randint(0, 2, 50)
        p = rng.rand(50)
    else:
        t = rng.randn(50, 2)
        p = t + 0.1 * rng.randn(50, 2)
    assert Evaluator.evaluate(metric, t, p) == \
        JEvaluator.evaluate(metric, t, p)
    assert Evaluator.get_metric_mode(metric) == \
        JEvaluator.get_metric_mode(metric)
    with pytest.raises(ValueError, match="unknown metric"):
        Evaluator.evaluate("nope", t, p)
