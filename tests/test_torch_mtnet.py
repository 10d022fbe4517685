"""MTNet in the port against the JAX package's, on the CPU (mirrors
JAX's test_zouwu.py TestMTNetFidelity, the MTNet forecaster tests and
``test_mtnet_legacy_alias_keeps_single_gru``).

- ``convert.flax_layout`` of ``MTNetModule`` equals ``jax.eval_shape`` of
  its flax ``init`` (stacked GRUs; ``ar_window`` 0 with one GRU): the step's
  weights under ``<enc>_attgru/steps``, ``W1`` and ``b2`` beside them.
- The forward from the same parameters, fp32: within 1e-5 (measured
  3e-8).
- A fit at dropout 0 from JAX's initial parameters and the same data
  (Adam 1e-3, mse, 3 epochs of 4 steps): epoch losses within rtol 1e-5
  and every parameter within atol 1e-5 (the NCF fit limits; measured
  3.5e-7 at worst). At Adam 1e-2 one leaf with a near-zero gradient
  (``context_attgru/b2``) ends 1.08e-5 apart after the 12 steps: the GRU
  gates' sums run in another order (``keras/layers.py`` takes a side's
  gates in one product), and Adam's normalised step magnifies that where
  the gradient is tiny.
- ``mixed_bfloat16``: the port's output is at most 1.5x as far from the
  float64 forward (the port's module in float64) as JAX's bf16 output is
  (measured 1.11x: 5.0e-4 against 4.5e-4).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_layout, flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.optimizers import Adam
from analytics_zoo_tpu_torch.zouwu.model.forecast import MTNetForecaster
from analytics_zoo_tpu_torch.zouwu.model.nets import MTNetModule

LR = 1e-3
SMALL = dict(output_dim=2, long_num=3, time_step=6, cnn_hid_size=8,
             rnn_hid_sizes=(4, 8), cnn_height=3, ar_window=2,
             cnn_dropout=0.0, rnn_dropout=0.0)


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
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.zouwu.model import nets
    return dict(jax=jax, Estimator=JEstimator, Adam=JAdam, nets=nets)


def _data(n=192, long_num=3, time_step=6, feats=2, horizon=2, seed=0):
    """JAX's TestMTNetFidelity data."""
    rng = np.random.RandomState(seed)
    total = (long_num + 1) * time_step
    t = np.arange(n + total + horizon)
    sig = np.stack([np.sin(t * 2 * np.pi / 12),
                    np.cos(t * 2 * np.pi / 12)], -1)[None] \
        + 0.02 * rng.standard_normal((1, len(t), feats))
    xs = np.stack([sig[0, i:i + total] for i in range(n)])
    ys = np.stack([sig[0, i + total:i + total + horizon, 0]
                   for i in range(n)])
    return xs.astype(np.float32), ys.astype(np.float32)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _pair(jx, feats=2, dtype=None, generator=None, **kw):
    jdt = None if dtype is None else jx["jax"].numpy.bfloat16
    return (jx["nets"].MTNetModule(dtype=jdt, **kw),
            MTNetModule(feats, dtype=dtype, generator=generator, **kw))


@pytest.mark.parametrize("kw", [
    SMALL, dict(SMALL, output_dim=1, ar_window=0, rnn_hid_sizes=(8,))])
def test_layout_and_forward_match_jax(jx, kw):
    """The layout against ``eval_shape`` of flax's init; the forward from
    the port's initial parameters carried into flax's tree (flax's own
    init of this scan takes 16 s to compile on one core)."""
    jax = jx["jax"]
    n = (kw["long_num"] + 1) * kw["time_step"]
    x = np.random.default_rng(1).standard_normal((16, n, 2)).astype(
        np.float32)
    jnet, tnet = _pair(jx, generator=torch.Generator().manual_seed(4), **kw)
    keys = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jnet.init(keys, x[:2]))["params"]
    assert _shapes(flax_layout(tnet)) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), shapes)
    params = state_dict_to_flax(tnet.state_dict(), shapes)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ("ar" in shapes) == (tnet.ar is not None)


def test_fit_matches_jax_from_flax(jx):
    x, y = _data(n=64)
    jnet, tnet = _pair(jx, **SMALL)
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
    np.testing.assert_allclose(test.predict(x, batch_size=32),
                               np.asarray(jest.predict(x, batch_size=32)),
                               rtol=0, atol=1e-5)


def test_bf16_against_float64(jx):
    x, _ = _data(n=32)
    jax = jx["jax"]
    jnet, tnet = _pair(jx, dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(3), **SMALL)
    ref = MTNetModule(2, **SMALL).double()
    ref.load_state_dict(tnet.state_dict())
    params = state_dict_to_flax(tnet.state_dict(), flax_layout(tnet))
    want = ref(torch.from_numpy(x).double()).detach().numpy()
    jax_dist = np.abs(np.asarray(jax.jit(jnet.apply)({"params": params}, x),
                                 np.float64) - want).max()
    mine = tnet(torch.from_numpy(x)).detach().numpy()
    assert mine.dtype == np.float32
    print("bf16 distance from float64: port", np.abs(mine - want).max(),
          "JAX", jax_dist)
    assert np.abs(mine - want).max() <= 1.5 * jax_dist


# --------------------------------------------------------- JAX's mirrors

class TestMTNetFidelity:
    def test_ref_hyperparameter_surface(self):
        xs, ys = _data()
        f = MTNetForecaster(future_seq_len=2, time_step=6, long_num=3,
                            cnn_height=3, cnn_hid_size=8,
                            rnn_hid_sizes=[4, 8], cnn_dropout=0.1,
                            rnn_dropout=0.1, device="cpu")
        f.fit(xs, ys, epochs=1, batch_size=32)
        assert f.predict(xs[:5]).shape == (5, 2)

    def test_ar_window_zero_disables_linear(self):
        m = MTNetModule(2, output_dim=1, long_num=2, time_step=4,
                        cnn_hid_size=4, rnn_hid_sizes=(4,), cnn_height=2,
                        ar_window=0)
        assert "ar" not in flax_layout(m)
        assert m(torch.zeros(2, 12, 2)).shape == (2, 1)

    def test_three_separate_encoders(self):
        m = MTNetModule(2, output_dim=1, long_num=2, time_step=4,
                        cnn_hid_size=4, rnn_hid_sizes=(4,), cnn_height=2)
        names = set(flax_layout(m))
        for enc in ("memory", "context", "query"):
            assert f"{enc}_conv" in names and f"{enc}_attgru" in names
        ag = flax_layout(m)["memory_attgru"]
        assert {"W1", "b2"} <= set(ag)
        assert {"W2", "W3", "b3", "V", "gru_0"} <= set(ag["steps"])
        assert not torch.equal(m.memory_conv.weight, m.context_conv.weight)

    def test_convergence_beats_mean_baseline(self):
        xs, ys = _data(n=256)
        f = MTNetForecaster(future_seq_len=2, time_step=6, long_num=3,
                            cnn_height=2, cnn_hid_size=8, rnn_hid_sizes=[8],
                            cnn_dropout=0.0, rnn_dropout=0.0, device="cpu")
        f.fit(xs[:192], ys[:192], epochs=30, batch_size=32)
        mse = float(np.mean((f.predict(xs[192:]) - ys[192:]) ** 2))
        base = float(np.mean((ys[192:] - ys[:192].mean()) ** 2))
        assert mse < base * 0.5, (mse, base)

    def test_old_aliases_still_work(self):
        xs, ys = _data()
        f = MTNetForecaster(future_seq_len=2, long_series_num=3,
                            series_length=6, cnn_hid_size=8,
                            rnn_hid_size=8, cnn_kernel_size=2, dropout=0.1,
                            device="cpu")
        f.fit(xs, ys, epochs=1, batch_size=32)
        assert f.predict(xs[:3]).shape == (3, 2)


def test_mtnet_mixed_precision():
    xs, ys = _data(n=64, long_num=3, time_step=4, horizon=1)
    f = MTNetForecaster(future_seq_len=1, long_num=3, time_step=4,
                        cnn_height=2, ar_window=2, cnn_dropout=0.0,
                        rnn_dropout=0.0, dtype="mixed_bfloat16",
                        device="cpu")
    h = f.fit(xs, ys, epochs=3, batch_size=16)
    assert h["loss"][-1] < h["loss"][0]
    pred = f.predict(xs)
    assert pred.dtype == np.float32 and pred.shape == (len(xs), 1)
    assert {p.dtype for p in f._est.model.parameters()} == {torch.float32}


def test_mtnet_legacy_alias_keeps_single_gru():
    legacy = MTNetForecaster(future_seq_len=1, series_length=6,
                             long_series_num=3, device="cpu")
    assert legacy.kw["rnn_hid_sizes"] == (32,)
    assert MTNetForecaster(future_seq_len=1, time_step=6, long_num=3,
                           device="cpu").kw["rnn_hid_sizes"] == (16, 32)
    assert MTNetForecaster(future_seq_len=1,
                           device="cpu").kw["rnn_hid_sizes"] == (16, 32)
    assert MTNetForecaster(future_seq_len=1, series_length=6,
                           rnn_hid_size=8,
                           device="cpu").kw["rnn_hid_sizes"] == (8,)


def test_forecaster_save_restore_crosses_packages(jx, tmp_path):
    """An MTNet forecaster saved by the port restores in JAX and predicts
    within 1e-5 of the port (the checkpoint holds flax's tree)."""
    from analytics_zoo_tpu.zouwu.model.forecast import (
        MTNetForecaster as JMT)
    xs, ys = _data(n=64)
    kw = dict(future_seq_len=2, time_step=6, long_num=3, cnn_height=3,
              cnn_hid_size=8, rnn_hid_sizes=[4, 8])
    f = MTNetForecaster(device="cpu", **kw)
    f.fit(xs, ys, epochs=1, batch_size=32)
    f.save(str(tmp_path / "m"))
    g = JMT(**kw)
    g.restore(str(tmp_path / "m"), sample_x=xs)
    np.testing.assert_allclose(np.asarray(g.predict(xs, batch_size=32)),
                               f.predict(xs, batch_size=32), rtol=0,
                               atol=1e-5)
