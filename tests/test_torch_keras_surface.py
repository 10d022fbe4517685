"""The port's keras surface against the JAX package's, on the CPU: the
weight regularizers, ``summary()`` and the TensorBoard summaries.

- **Regularizers** (keras/regularizers.py): ``l1``, ``l2`` and ``l1_l2``
  of random arrays, and of ``Dense`` kernels and biases through the
  model's penalty, within rtol 1e-6 of JAX's (float32 sums in another
  order); a regularized fit (``Dense(W_regularizer=l2,
  b_regularizer=l1)``, Adam and SGD, batch 16, 4 steps an epoch, 2
  epochs) held as tests/test_torch_keras_train.py holds NCF: each epoch's
  loss, penalty included, within rtol 1e-5 (the penalties and the losses
  measured within 2.2e-7 relative); after SGD every parameter within atol
  1e-6 (measured: 3.0e-8); after Adam within 1e-5 in all but 1% of each
  leaf and within 2 lr per step everywhere (measured: 6.0e-8).
- **summary()**: the same text as JAX's for NCF, Wide&Deep, Seq2Seq and
  a regularized Sequential, printed and returned.
- **The event writer** (common/summary.py): for a fixed wall time a
  record is byte for byte JAX's; files written by either package are
  read by the other's ``read_scalars``; after a fit,
  ``get_train_summary``/``get_validation_summary`` hold the same tags at
  the same steps as JAX's (losses and metrics within rtol 1e-5, the
  learning rates equal), ``set_tensorboard``'s layout and the default
  directories are JAX's, and the summaries add no read-back.

JAX is imported by fixtures only.
"""

import glob
import os
import time

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import summary as tsummary
from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.keras import Sequential
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.keras import regularizers as treg
from analytics_zoo_tpu_torch.learn import estimator as testimator
from analytics_zoo_tpu_torch.learn.optimizers import SGD, Adam
from analytics_zoo_tpu_torch.models import (ColumnFeatureInfo, NeuralCF,
                                            Seq2Seq, WideAndDeep)

LOSS = "sparse_categorical_crossentropy"
LR = {"adam": 1e-2, "sgd": 0.1}
NCF_ARGS = dict(user_count=50, item_count=40, class_num=5, user_embed=8,
                item_embed=8, hidden_layers=(16, 8), include_mf=True,
                mf_embed=8)
WND_COLUMNS = dict(
    wide_base_cols=["a", "b"], wide_base_dims=[10, 10],
    wide_cross_cols=["ab"], wide_cross_dims=[20],
    indicator_cols=["c"], indicator_dims=[4],
    embed_cols=["u", "i"], embed_in_dims=[30, 40], embed_out_dims=[8, 16],
    continuous_cols=["age"])
REGS = {"l1": lambda m: m.l1(0.01), "l2": lambda m: m.l2(0.02),
        "l1_l2": lambda m: m.l1_l2(0.01, 0.03)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _logs_in_tmp(monkeypatch, tmp_path):
    # the port's summaries go to tmp_path, not ./zoo_tpu_logs
    monkeypatch.setattr(testimator, "DEFAULT_LOG_DIR",
                        str(tmp_path / "default_logs"))


@pytest.fixture(scope="module")
def jax_api():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.common import summary as jsummary
    from analytics_zoo_tpu.keras import Sequential as JSequential
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.keras import regularizers as jreg
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    from analytics_zoo_tpu.learn.optimizers import Adam as JAdam
    from analytics_zoo_tpu.models import Seq2Seq as JSeq2Seq
    from analytics_zoo_tpu.models.recommendation import (
        ColumnFeatureInfo as JColumnFeatureInfo,
    )
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNeuralCF
    from analytics_zoo_tpu.models.recommendation import (
        WideAndDeep as JWideAndDeep,
    )
    return dict(jax=jax, summary=jsummary, Sequential=JSequential,
                layers=jl, reg=jreg, opt={"adam": JAdam, "sgd": JSGD},
                Seq2Seq=JSeq2Seq, NeuralCF=JNeuralCF,
                WideAndDeep=JWideAndDeep,
                ColumnFeatureInfo=JColumnFeatureInfo)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def assert_params(tnet, jparams, opt, lr, steps):
    """tests/test_torch_keras_train.py's scheme."""
    got = dict(_leaves(state_dict_to_flax(tnet.module.state_dict(),
                                          jparams)))
    for path, want in _leaves(jparams):
        diff = np.abs(got[path] - want)
        if opt == "sgd":
            assert diff.max() <= 1e-6, (path, diff.max())
        else:
            assert np.mean(diff > 1e-5) <= 1e-2, (path, diff.max())
            assert diff.max() <= 2 * lr * steps, (path, diff.max())


# ------------------------------------------------------------ regularizers

@pytest.mark.parametrize("name", sorted(REGS))
def test_regularizer_matches_jax(jax_api, name):
    w = np.random.RandomState(0).randn(37, 11).astype(np.float32)
    got = REGS[name](treg)(torch.from_numpy(w))
    want = REGS[name](jax_api["reg"])(jax_api["jax"].numpy.asarray(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 parameters accumulate in fp32
    half = torch.from_numpy(w).to(torch.bfloat16)
    assert REGS[name](treg)(half).dtype == torch.float32


def test_regularizer_spellings():
    assert treg.L1L2Regularizer is treg.Regularizer is treg.L1L2
    assert treg.get(None) is None
    r = treg.l1_l2(0.5, 0.25)
    assert treg.get(r) is r
    for spec, (l1, l2) in (("l1", (0.01, 0.0)), ("L2", (0.0, 0.01)),
                           ("l1_l2", (0.01, 0.01)), ("l1l2", (0.01, 0.01))):
        got = treg.get(spec)
        assert (got.l1, got.l2) == (l1, l2)
    fn = lambda w: w.sum()  # noqa: E731
    assert treg.get(fn) is fn
    with pytest.raises(ValueError, match="unknown regularizer"):
        treg.get("l3")
    assert float(treg.Regularizer()(torch.ones(3))) == 0.0
    assert repr(r) == "Regularizer(l1=0.5, l2=0.25)"


def reg_model(Sequential, layers, reg, w_name, b_name):
    """Two Denses, the first regularized as named, the second by
    ``l1_l2`` on its kernel, from either package."""
    net = Sequential()
    net.add(layers.Dense(
        8, activation="relu", input_shape=(6,),
        W_regularizer=REGS[w_name](reg) if w_name else None,
        b_regularizer=REGS[b_name](reg) if b_name else None))
    net.add(layers.Dense(3, activation="softmax",
                         W_regularizer=REGS["l1_l2"](reg)))
    return net


def reg_pair(jax_api, w_name, b_name, opt):
    jnet = reg_model(jax_api["Sequential"], jax_api["layers"],
                     jax_api["reg"], w_name, b_name)
    tnet = reg_model(Sequential, tl, treg, w_name, b_name)
    jnet.compile(optimizer=jax_api["opt"][opt](LR[opt]), loss=LOSS)
    params = jax_api["jax"].device_get(jnet.get_weights())
    # biases start at zero: give them values so that l1 and l2 see them
    params = jax_api["jax"].tree_util.tree_map(
        lambda a: a + np.float32(0.1), params)
    jnet.estimator._state["params"] = params
    tnet.module.load_state_dict(flax_to_state_dict(params))
    tnet.compile(optimizer=(Adam if opt == "adam" else SGD)(LR[opt]),
                 loss=LOSS, device="cpu")
    return jnet, tnet, params


@pytest.mark.parametrize("w_name,b_name", [
    ("l1", None), ("l2", None), ("l1_l2", None), (None, "l1"),
    (None, "l2"), ("l2", "l1"), ("l1_l2", "l1_l2")])
def test_dense_penalty_matches_jax(jax_api, w_name, b_name):
    jnet, tnet, params = reg_pair(jax_api, w_name, b_name, "sgd")
    want = jnet._param_penalty_fn(jnet.to_flax().order)(params)
    got = tnet._param_penalty_fn()(dict(tnet.module.named_parameters()))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    layer = tnet.layers[0]
    assert set(layer.param_regularizers) == \
        {k for k, n in (("kernel", w_name), ("bias", b_name)) if n}


def test_no_regularizer_no_penalty():
    net = Sequential().add(tl.Dense(2, input_shape=(3,)))
    assert net._param_penalty_fn() is None
    assert tl.Dense(2).penalty({"kernel": torch.ones(2)}) == 0.0


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_regularized_fit_matches_jax(jax_api, opt):
    jnet, tnet, _ = reg_pair(jax_api, "l2", "l1", opt)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.int32)
    want = jnet.fit(x, y, batch_size=16, nb_epoch=2)
    got = tnet.fit(x, y, batch_size=16, nb_epoch=2)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # the reported loss carries the penalty: evaluate's does not
    assert got["loss"][-1] > tnet.evaluate(x, y, batch_size=16)["loss"]
    assert_params(tnet, jax_api["jax"].device_get(jnet.get_weights()), opt,
                  LR[opt], 8)


# ----------------------------------------------------------------- summary

def _summary_models(api, Sequential_, layers, reg):
    get = (lambda n: api[n]) if api else (lambda n: globals()[n])
    return {
        "ncf": lambda: get("NeuralCF")(**NCF_ARGS),
        "wide_and_deep": lambda: get("WideAndDeep")(
            2, get("ColumnFeatureInfo")(**WND_COLUMNS)),
        "seq2seq": lambda: get("Seq2Seq")(
            input_dim=3, output_dim=3, hidden_size=8, num_layers=2,
            rnn_type="gru", encoder_seq_len=4, decoder_seq_len=3),
        "regularized": lambda: reg_model(Sequential_, layers, reg, "l2",
                                         "l1"),
    }


@pytest.mark.parametrize("kind", ["ncf", "wide_and_deep", "seq2seq",
                                  "regularized"])
def test_summary_text_equals_jax(jax_api, capsys, kind):
    want = _summary_models(jax_api, jax_api["Sequential"],
                           jax_api["layers"], jax_api["reg"])[kind]().summary()
    capsys.readouterr()
    got = _summary_models(None, Sequential, tl, treg)[kind]().summary()
    assert got == want
    assert capsys.readouterr().out == got + "\n"
    assert got.splitlines()[-1].startswith("Total params: ")


# -------------------------------------------------------- the event writer

@pytest.mark.parametrize("step,tag,value", [
    (0, "Loss", 0.5), (12345, "Throughput", 1.0e6),
    (7, "val/accuracy", -3.25), (2 ** 40, "LearningRate", 1e-3),
    (3, "Ünïcode tag", float("nan"))])
def test_record_bytes_equal_jax(jax_api, monkeypatch, step, tag, value):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.123)
    js = jax_api["summary"]
    assert tsummary._record(tsummary._event(step, tag, value)) == \
        js._record(js._event(step, tag, value))
    assert tsummary._record(tsummary._event(0, file_version="brain.Event:2")) \
        == js._record(js._event(0, file_version="brain.Event:2"))
    assert tsummary.crc32c(tag.encode()) == js.crc32c(tag.encode())


def _write(writer_cls, path, rows):
    w = writer_cls(path)
    for tag, value, step in rows:
        w.add_scalar(tag, value, step)
    w.close()
    w.add_scalar("after", 1.0, 1)            # dropped: the writer is closed
    w.flush()
    return glob.glob(os.path.join(path, "events.out.tfevents.*"))[0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_packages(jax_api, tmp_path, writer):
    js = jax_api["summary"]
    rng = np.random.RandomState(1)
    rows = [(t, float(rng.randn()), s) for s in range(0, 300, 3)
            for t in ("Loss", "Throughput")]
    cls = tsummary.SummaryWriter if writer == "port" else js.SummaryWriter
    path = _write(cls, str(tmp_path / writer), rows)
    read_port, read_jax = tsummary.read_scalars(path), js.read_scalars(path)
    assert read_port == read_jax
    want = {}
    for tag, value, step in rows:
        want.setdefault(tag, []).append((step, float(np.float32(value))))
    assert read_port == want


def test_writer_buffers_and_mirrors(tmp_path):
    w = tsummary.SummaryWriter(str(tmp_path), flush_every=4)
    size0 = os.path.getsize(w._path)
    for s in range(3):
        w.add_scalar("x", s, s)
    assert os.path.getsize(w._path) == size0      # buffered
    w.add_scalar("x", 3, 3)
    assert os.path.getsize(w._path) > size0       # the fourth flushes
    assert w.get_scalar("x") == [(0, 0.0), (1, 1.0), (2, 2.0), (3, 3.0)]
    assert w.get_scalar("y") == []
    w.close()
    w.close()
    assert tsummary.read_scalars(w._path)["x"] == w.get_scalar("x")


def _ncf_pair(jax_api, tmp_path):
    jm, tm = jax_api["NeuralCF"](**NCF_ARGS), NeuralCF(**NCF_ARGS)
    jm.compile(optimizer=jax_api["opt"]["sgd"](0.1), loss=LOSS,
               metrics=["accuracy"])
    tm.model.module.load_state_dict(flax_to_state_dict(
        jax_api["jax"].device_get(jm.model.get_weights())))
    # set before compile: kept across it
    tm.set_tensorboard(str(tmp_path / "port"), "ncf")
    tm.compile(optimizer=SGD(0.1), loss=LOSS, metrics=["accuracy"],
               device="cpu")
    jm.set_tensorboard(str(tmp_path / "jax"), "ncf")
    return jm, tm


def _ncf_data(n, seed):
    rng = np.random.RandomState(seed)
    x = np.stack([rng.randint(1, 51, n), rng.randint(1, 41, n)],
                 1).astype(np.float32)
    return x, ((x[:, 0] + x[:, 1]) % 5).astype(np.int32)


def test_fit_summaries_match_jax(jax_api, tmp_path):
    jm, tm = _ncf_pair(jax_api, tmp_path)
    x, y = _ncf_data(128, 0)
    xv, yv = _ncf_data(40, 1)
    kw = dict(batch_size=16, nb_epoch=2, validation_data=(xv, yv),
              summary_interval=3)
    jm.fit(x, y, **kw)
    tm.fit(x, y, **kw)
    jest, test = jm.model.estimator, tm.model.estimator
    for tag in ("Loss", "Throughput", "LearningRate"):
        got, want = test.get_train_summary(tag), jest.get_train_summary(tag)
        # windows of 3 steps, and each epoch's last: 8 steps an epoch
        assert [s for s, _ in got] == [s for s, _ in want] == \
            [3, 6, 8, 11, 14, 16], tag
        if tag == "Loss":
            np.testing.assert_allclose([v for _, v in got],
                                       [v for _, v in want], rtol=1e-5)
        elif tag == "LearningRate":
            assert [v for _, v in got] == pytest.approx([0.1] * 6)
        else:
            assert all(v > 0 for _, v in got)
    for tag in ("loss", "accuracy"):
        got = test.get_validation_summary(tag)
        want = jest.get_validation_summary(tag)
        assert [s for s, _ in got] == [s for s, _ in want] == [8, 16]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=1e-5)
    assert test.get_validation_summary("missing") == []
    # the files: <log_dir>/<app>/{train,validation}, each package's read
    # by the other
    js = jax_api["summary"]
    for part in ("train", "validation"):
        (port_file,) = glob.glob(str(tmp_path / "port" / "ncf" / part /
                                     "events.out.tfevents.*"))
        (jax_file,) = glob.glob(str(tmp_path / "jax" / "ncf" / part /
                                    "events.out.tfevents.*"))
        got, want = js.read_scalars(port_file), \
            tsummary.read_scalars(jax_file)
        assert sorted(got) == sorted(want)
        for tag in got:
            assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]]


def test_default_summary_directories(tmp_path):
    x, y = _ncf_data(32, 2)
    for model_dir in (None, str(tmp_path / "model")):
        m = NeuralCF(**NCF_ARGS)
        if model_dir:
            m.set_checkpoint(model_dir)
        m.compile(optimizer="sgd", loss=LOSS, device="cpu")
        m.fit(x, y, batch_size=16, nb_epoch=1)
        base = model_dir or testimator.DEFAULT_LOG_DIR
        for part in ("train", "validation"):
            assert glob.glob(os.path.join(base, part,
                                          "events.out.tfevents.*"))
        assert m.model.estimator.get_train_summary("Loss")[-1][0] == 2
    assert testimator.DEFAULT_LOG_DIR == str(tmp_path / "default_logs")


def test_set_tensorboard_redirects_later_events(tmp_path):
    m = NeuralCF(**NCF_ARGS)
    m.compile(optimizer="sgd", loss=LOSS, device="cpu")
    x, y = _ncf_data(32, 3)
    m.set_tensorboard(str(tmp_path), "first")
    m.fit(x, y, batch_size=16, nb_epoch=1)
    m.set_tensorboard(str(tmp_path), "second")
    m.fit(x, y, batch_size=16, nb_epoch=1)
    est = m.model.estimator
    assert est.get_train_summary("Loss")[0][0] == 4     # a new writer
    (first,) = glob.glob(str(tmp_path / "first" / "train" / "events.*"))
    (second,) = glob.glob(str(tmp_path / "second" / "train" / "events.*"))
    assert [s for s, _ in tsummary.read_scalars(first)["Loss"]] == [2]
    assert [s for s, _ in tsummary.read_scalars(second)["Loss"]] == [4]


def test_summaries_add_no_read_back(monkeypatch, tmp_path):
    """The writer sees only the values each window already read back: one
    read-back a window of ``summary_interval`` steps, as without it."""
    m = NeuralCF(**NCF_ARGS)
    m.set_tensorboard(str(tmp_path), "app")
    m.compile(optimizer="sgd", loss=LOSS, device="cpu")
    x, y = _ncf_data(128, 4)
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    m.fit(x, y, batch_size=16, nb_epoch=1, summary_interval=4)
    assert calls == [(4,), (4,)]
    assert len(m.model.estimator.get_train_summary("Throughput")) == 2
