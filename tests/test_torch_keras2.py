"""The port's keras2 layers (``keras2/layers.py``) against the JAX
package's, on the CPU.

Each of the 17 classes and the 3 functional helpers is built by name in
both packages with the same Keras-2 arguments, inside a small model; the
port's model takes JAX's parameters (``convert.flax_to_state_dict``) and
the two forwards on the same seeded input agree within 1e-5 (fp32; the
convolutions sum in another order). The flax trees match leaf for leaf
(``convert.flax_layout``). The regularizers (``kernel_regularizer`` /
``bias_regularizer``) reach the train step: 3 SGD steps of a model with
l1, l2 and l1_l2 penalties, from the same parameters, within 1e-5 of
JAX's in loss and parameters (an l1 penalty on a zero bias moves it: its
gradient at 0 is jnp.abs's +1, ROADMAP C31). JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch import convert
from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import regularizers as treg
from analytics_zoo_tpu_torch.keras.layers import Reshape
from analytics_zoo_tpu_torch.keras2 import layers as tk2


@pytest.fixture(scope="module")
def jk():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.keras import Input as JInput
    from analytics_zoo_tpu.keras import Model as JModel
    from analytics_zoo_tpu.keras import regularizers
    from analytics_zoo_tpu.keras.layers import Reshape
    from analytics_zoo_tpu.keras2 import layers
    from analytics_zoo_tpu.learn import optimizers
    return dict(jax=jax, Input=JInput, Model=JModel, k2=layers,
                reg=regularizers, opt=optimizers, Reshape=Reshape)


SEQ, IMG = (8, 5), (6, 6, 3)
#: name -> (build(k2, x) over one input node, input shape)
CASES = {
    "Dense": (lambda k2, x: k2.Dense(units=6, activation="relu",
                                     name="k2_dense")(x), (5,)),
    "Dense_input_dim": (lambda k2, x: k2.Dense(3, use_bias=False,
                                               name="k2_dense_nb")(x),
                        (4,)),
    "Activation": (lambda k2, x: k2.Activation("tanh")(x), (5,)),
    "Dropout": (lambda k2, x: k2.Dropout(0.3)(x), (5,)),
    "Flatten": (lambda k2, x: k2.Flatten()(x), SEQ),
    "Conv1D": (lambda k2, x: k2.Conv1D(4, kernel_size=3, strides=1,
                                       padding="same", activation="relu",
                                       name="k2_conv1d")(x), SEQ),
    "Conv1D_strided": (lambda k2, x: k2.Conv1D(3, (2,), strides=(2,),
                                               name="k2_conv1d_s")(x), SEQ),
    "Conv2D": (lambda k2, x: k2.Conv2D(4, kernel_size=3, strides=(2, 2),
                                       name="k2_conv2d")(x), IMG),
    "Conv2D_same": (lambda k2, x: k2.Conv2D(2, (3, 2), padding="same",
                                            use_bias=False,
                                            name="k2_conv2d_same")(x), IMG),
    "Cropping1D": (lambda k2, x: k2.Cropping1D(cropping=(2, 1))(x), SEQ),
    "MaxPooling1D": (lambda k2, x: k2.MaxPooling1D(pool_size=2)(x), SEQ),
    "AveragePooling1D": (lambda k2, x: k2.AveragePooling1D(
        pool_size=3, strides=1)(x), SEQ),
    "GlobalAveragePooling1D": (lambda k2, x: k2.GlobalAveragePooling1D()(x),
                               SEQ),
    "GlobalMaxPooling1D": (lambda k2, x: k2.GlobalMaxPooling1D()(x), SEQ),
    "GlobalAveragePooling2D": (lambda k2, x: k2.GlobalAveragePooling2D()(x),
                               IMG),
    "LocallyConnected1D": (lambda k2, x: k2.LocallyConnected1D(
        3, kernel_size=2, strides=2, name="k2_local")(x), SEQ),
    "Maximum": (lambda k2, x: k2.Maximum()([x, k2.Activation("tanh")(x)]),
                (5,)),
    "Minimum": (lambda k2, x: k2.Minimum()([x, k2.Activation("relu")(x)]),
                (5,)),
    "Average": (lambda k2, x: k2.Average()([x, k2.Activation("tanh")(x),
                                            k2.Activation("relu")(x)]),
                (5,)),
    "maximum": (lambda k2, x: k2.maximum([x, k2.Activation("tanh")(x)]),
                (5,)),
    "minimum": (lambda k2, x: k2.minimum([x, k2.Activation("relu")(x)]),
                (5,)),
    "average": (lambda k2, x: k2.average([x, k2.Activation("tanh")(x)]),
                (5,)),
}


def _leaves(tree, host=True, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, host, f"{path}/{k}")
    else:
        yield path, np.asarray(tree) if host else tree


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(jk, name):
    build, shape = CASES[name]
    x = np.random.RandomState(len(name)).randn(4, *shape).astype(np.float32)
    ji = jk["Input"](shape=shape)
    jm = jk["Model"](ji, build(jk["k2"], ji))
    want = np.asarray(jm.predict(x, distributed=False))
    ti = Input(shape=shape)
    tm = Model(ti, build(tk2, ti))
    params = jk["jax"].device_get(jm.get_weights())
    like = convert.flax_layout(tm.module)
    assert [(p, tuple(v.shape)) for p, v in _leaves(like or {}, False)] \
        == [(p, v.shape) for p, v in _leaves(params)]
    if params:
        tm.module.load_state_dict(convert.flax_to_state_dict(params))
    tm.module.eval()
    with torch.no_grad():
        got = tm.module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_locally_connected_refuses_same_padding_in_both(jk):
    for k2 in (tk2, jk["k2"]):
        with pytest.raises(ValueError, match="padding='valid'"):
            k2.LocallyConnected1D(3, 2, padding="same")


def _reg_model(Input_, Model_, k2, reg, Reshape):
    """Dense (l2 kernel, l1 bias) -> Conv1D (l1_l2) -> Dense (l1)."""
    x = Input_(shape=(6,))
    h = k2.Dense(10, activation="tanh", kernel_regularizer=reg.l2(0.1),
                 bias_regularizer=reg.l1(0.05), name="reg_a")(x)
    h = k2.Conv1D(2, 2, kernel_regularizer=reg.l1_l2(0.02, 0.03),
                  name="reg_conv")(Reshape((5, 2))(h))
    out = k2.Dense(1, kernel_regularizer=reg.l1(0.01), name="reg_out")(
        k2.Flatten()(h))
    return Model_(x, out)


def test_regularizers_steps_match_jax(jk, tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.learn.optimizers import SGD
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))
    rng = np.random.RandomState(0)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randn(32, 1).astype(np.float32)
    jm = _reg_model(jk["Input"], jk["Model"], jk["k2"], jk["reg"],
                    jk["Reshape"])
    jm.compile(optimizer=jk["opt"].SGD(0.05), loss="mse")
    tm = _reg_model(Input, Model, tk2, treg, Reshape)
    params = jk["jax"].device_get(jm.get_weights())
    tm.module.load_state_dict(convert.flax_to_state_dict(params))
    tm.compile(optimizer=SGD(0.05), loss="mse", device="cpu")
    # one step an epoch: each epoch's loss is a step's
    jh = jm.fit(x, y, batch_size=32, nb_epoch=3, shuffle=False)
    th = tm.fit(x, y, batch_size=32, nb_epoch=3, shuffle=False)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-5)
    jp = jk["jax"].device_get(jm.get_weights())
    got = dict(_leaves(convert.state_dict_to_flax(tm.module.state_dict(),
                                                  jp)))
    moved = 0
    for path, want in _leaves(jp):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-5,
                                   err_msg=path)
        moved += not np.array_equal(want, dict(_leaves(params))[path])
    assert moved == len(got)
