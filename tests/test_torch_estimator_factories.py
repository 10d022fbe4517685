"""``Estimator.from_keras`` / ``from_graph`` of the port against the JAX
package's, on the CPU (mirrors JAX ``tests/test_estimator_factories.py``).

Both factories return the model's own estimator: settings compiled on
the model are kept and explicit arguments override them, a ``ZooModel``
is unwrapped through ``.model``, anything else raises ``TypeError`` and a
missing loss ``ValueError``. Rules are kept; a layout needing more
ranks than this process raises ``ValueError`` and ``"pp"`` raises naming
ROADMAP A9's third part (the ranks' fits are in
``tests/test_torch_multirank.py``). From the same parameters
(``convert.flax_to_state_dict``), the port's fit through ``from_keras``
and ``from_graph`` matches JAX's: each epoch's loss within rtol 1e-5 and
every parameter within 1e-6 after SGD, 1e-5 after Adam; and it is
bitwise the fit of the same model through ``compile`` / ``fit``. JAX is
imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input, Sequential
from analytics_zoo_tpu_torch.keras import layers as tl
from analytics_zoo_tpu_torch.learn import Estimator
from analytics_zoo_tpu_torch.learn.optimizers import SGD, Optimizer
from analytics_zoo_tpu_torch.models import NeuralCF

LOSS = "sparse_categorical_crossentropy"


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
def je():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.keras.models import Sequential as JSequential
    from analytics_zoo_tpu.learn.estimator import Estimator as JEstimator
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    return dict(jax=jax, Input=JInput, layers=jl, Sequential=JSequential,
                Estimator=JEstimator, SGD=JSGD)


def _data(n=64):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int32)
    return x, y


def _sequential(seq, layers):
    m = seq()
    m.add(layers.Dense(8, input_shape=(4,), activation="relu"))
    m.add(layers.Dense(2, activation="softmax"))
    return m


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _same_params(module, jparams, atol):
    mine = dict(_leaves(convert.state_dict_to_flax(module.state_dict(),
                                                   jparams)))
    for path, leaf in _leaves(jparams):
        np.testing.assert_allclose(mine[path], leaf, rtol=0, atol=atol,
                                   err_msg=path)


@pytest.mark.parametrize("opt,atol", [("sgd", 1e-6), ("adam", 1e-5)])
def test_from_keras_fit_matches_jax(je, opt, atol):
    jm = _sequential(je["Sequential"], je["layers"])
    tm = _sequential(Sequential, tl)
    x, y = _data()
    jm.predict(x[:8], distributed=False)
    tm.module.load_state_dict(convert.flax_to_state_dict(
        je["jax"].device_get(jm.get_weights())))
    jest = je["Estimator"].from_keras(
        keras_model=jm, loss=LOSS,
        optimizer=je["SGD"](0.1) if opt == "sgd" else "adam")
    test = Estimator.from_keras(
        keras_model=tm, loss=LOSS,
        optimizer=SGD(0.1) if opt == "sgd" else "adam", device="cpu")
    assert test is tm.estimator and test.device.type == "cpu"
    want = jest.fit((x, y), epochs=3, batch_size=16)
    got = test.fit((x, y), epochs=3, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _same_params(tm.module, je["jax"].device_get(jm.get_weights()), atol)
    np.testing.assert_allclose(
        test.predict(x, batch_size=16),
        np.asarray(jest.predict(x, batch_size=16)), rtol=0, atol=1e-5)


def test_from_graph_matches_jax(je):
    def graph(inp, layers):
        x = inp(shape=(4,))
        return x, layers.Dense(2, activation="softmax")(
            layers.Dense(8, activation="relu")(x))
    ji, jo = graph(je["Input"], je["layers"])
    ti, to = graph(Input, tl)
    jest = je["Estimator"].from_graph(inputs=ji, outputs=jo, loss=LOSS,
                                      optimizer=je["SGD"](0.1))
    test = Estimator.from_graph(inputs=ti, outputs=to, loss=LOSS,
                                optimizer=SGD(0.1), device="cpu")
    x, y = _data()
    jest.predict(x[:8], batch_size=8)
    jparams = je["jax"].device_get(jest.adapter.params)
    test.model.load_state_dict(convert.flax_to_state_dict(jparams))
    want = jest.fit((x, y), epochs=2, batch_size=16)
    got = test.fit((x, y), epochs=2, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["loss"][-1] < got["loss"][0]
    # JAX's trained parameters live in its device state
    _same_params(test.model, je["jax"].device_get(jest._state["params"]),
                 1e-6)


def test_from_keras_is_bitwise_compile_and_fit():
    x, y = _data(128)
    a, b = _sequential(Sequential, tl), _sequential(Sequential, tl)
    est = Estimator.from_keras(keras_model=a, loss=LOSS, optimizer="adam",
                               device="cpu")
    got = est.fit((x, y), epochs=2, batch_size=16)
    b.compile(optimizer="adam", loss=LOSS, device="cpu")
    want = b.fit(x, y, batch_size=16, nb_epoch=2)
    assert got["loss"] == want["loss"]
    for (n, p), (_, q) in zip(a.module.state_dict().items(),
                              b.module.state_dict().items()):
        assert torch.equal(p, q), n
    # the model and the estimator share their state: a later model.fit
    # goes on from the estimator's
    step = est._py_step
    a.fit(x, y, batch_size=16, nb_epoch=1)
    assert est._py_step == step + 8 and a.estimator is est


def test_compiled_settings_are_kept_and_overridden(tmp_path):
    m = _sequential(Sequential, tl)
    m.compile(optimizer="sgd", loss=LOSS, metrics=["accuracy"],
              device="cpu")
    est = Estimator.from_keras(keras_model=m)
    # the compiled optimizer and device win over the factory defaults
    assert type(est.optimizer) is type(Optimizer.get("sgd"))
    assert est.device.type == "cpu" and len(est.metrics) == 1
    est = Estimator.from_keras(keras_model=m, optimizer="adam",
                               model_dir=str(tmp_path / "ckpts"))
    assert type(est.optimizer) is type(Optimizer.get("adam"))
    assert est.model_dir == str(tmp_path / "ckpts")
    assert est.device.type == "cpu"
    x, y = _data()
    est.fit((x, y), epochs=1, batch_size=16)


def test_zoo_model_is_unwrapped():
    ncf = NeuralCF(user_count=10, item_count=10, class_num=2,
                   user_embed=4, item_embed=4, hidden_layers=(8,),
                   mf_embed=4)
    est = Estimator.from_keras(keras_model=ncf, loss=LOSS, device="cpu")
    assert est is ncf.model.estimator
    rng = np.random.default_rng(0)
    x = rng.integers(1, 11, (32, 2)).astype(np.float32)
    y = rng.integers(0, 2, 32).astype(np.int32)
    h = est.fit((x, y), epochs=1, batch_size=16)
    assert np.isfinite(h["loss"]).all()


def test_rejections():
    with pytest.raises(TypeError, match="zoo keras"):
        Estimator.from_keras(keras_model=object(), loss="mse")
    with pytest.raises(TypeError, match="zoo keras"):
        Estimator.from_keras(keras_model=torch.nn.Linear(2, 2), loss="mse")
    m = Sequential()
    m.add(tl.Dense(2, input_shape=(4,), activation="softmax"))
    with pytest.raises(ValueError, match="no loss"):
        Estimator.from_keras(keras_model=m)
    # rules alone are kept; on one rank nothing divides over "model"
    rules = [(r"kernel", (None, "model"))]
    est = Estimator.from_keras(keras_model=m, loss=LOSS, param_rules=rules,
                               device="cpu")
    assert est.strategy.param_rules == rules and est._shards == {}
    # a layout of more ranks than this process needs the ranks started
    with pytest.raises(ValueError, match="ranks"):
        Estimator.from_keras(keras_model=m, loss=LOSS, strategy="dp2,tp4",
                             device="cpu")
    x = Input(shape=(4,))
    with pytest.raises(ValueError, match="ranks"):
        Estimator.from_graph(inputs=x, outputs=tl.Dense(2)(x), loss="mse",
                             strategy="dp,tp2", device="cpu")
    with pytest.raises(NotImplementedError, match="A9's third part"):
        Estimator.from_graph(inputs=x, outputs=tl.Dense(2)(x), loss="mse",
                             strategy="pp", device="cpu")


def test_entry_points_run_on_cuda_unless_told(monkeypatch):
    """Without a device argument the estimator asks for the card, which
    raises where there is none (this CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _sequential(Sequential, tl)
    with pytest.raises(RuntimeError):
        Estimator.from_keras(keras_model=m, loss=LOSS)
