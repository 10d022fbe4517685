"""The port's keras autograd (``keras/autograd.py``) and the ``Node``
operator sugar (``keras/engine.py``) against the JAX package's, on the CPU.

- Every op (the unary, reduction, binary and shape ops, ``batch_dot``'s
  three axis forms, ``l2_normalize`` with its 1e-12 floor, the sugar's
  ``+ - * /``, their reflected forms and unary ``-``) built in both
  packages from the same expression and evaluated through
  ``to_function`` on the same seeded numpy inputs: within 1e-6 (fp32
  values of order 1; a few ops take their sums in another order).
- ``to_function`` refuses a graph with parameters in both.
- A keras model compiled with a ``CustomLoss`` (mean absolute error in
  autograd) and a ``Lambda`` layer, started from JAX's parameters
  (``convert.flax_to_state_dict``): 3 Adam steps' losses and the
  parameters after them within 1e-5 of JAX's fit.
JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flax_to_state_dict,
                                             state_dict_to_flax)
from analytics_zoo_tpu_torch.keras import autograd as TA


@pytest.fixture(scope="module")
def ja():
    pytest.importorskip("jax")
    import jax
    from analytics_zoo_tpu.keras import autograd
    from analytics_zoo_tpu.keras import layers
    from analytics_zoo_tpu.keras.engine import Input
    from analytics_zoo_tpu.keras.models import Model
    from analytics_zoo_tpu.learn import optimizers
    return dict(jax=jax, A=autograd, layers=layers, Input=Input,
                Model=Model, opt=optimizers)


def _x(shape, seed, positive=False):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


X = (4, 3)
X3 = (4, 3, 2)
#: name -> (expression over the autograd module A and the variables,
#: input shapes, whether the inputs are positive)
OPS = {
    "abs": (lambda A, v: A.abs(v), [X], False),
    "exp": (lambda A, v: A.exp(v), [X], False),
    "log": (lambda A, v: A.log(v), [X], True),
    "sqrt": (lambda A, v: A.sqrt(v), [X], True),
    "square": (lambda A, v: A.square(v), [X], False),
    "neg": (lambda A, v: A.neg(v), [X], False),
    "softsign": (lambda A, v: A.softsign(v), [X], False),
    "softplus": (lambda A, v: A.softplus(v * 10.0), [X], False),
    "clip": (lambda A, v: A.clip(v, -0.3, 0.7), [X], False),
    "pow": (lambda A, v: A.pow(v, 3.0), [X], True),
    "mean_axis1": (lambda A, v: A.mean(v, axis=1), [X3], False),
    "mean_keep": (lambda A, v: A.mean(v, axis=2, keepDims=True), [X3],
                  False),
    "mean_all": (lambda A, v: A.mean(v), [X3], False),
    "sum_axis2": (lambda A, v: A.sum(v, axis=2), [X3], False),
    "sum_neg_axis": (lambda A, v: A.sum(v, axis=-2, keepDims=True), [X3],
                     False),
    "max_axis1": (lambda A, v: A.max(v, axis=1), [X3], False),
    "min_keep": (lambda A, v: A.min(v, axis=1, keepDims=True), [X3],
                 False),
    "maximum": (lambda A, u, v: A.maximum(u, v), [X, X], False),
    "maximum_scalar": (lambda A, v: A.maximum(v, 0.1), [X], False),
    "minimum": (lambda A, u, v: A.minimum(u, v), [X, X], False),
    "minimum_scalar": (lambda A, v: A.minimum(v, -0.1), [X], False),
    "batch_dot_21": (lambda A, u, v: A.batch_dot(u, v),
                     [(3, 2, 4), (3, 4, 5)], False),
    "batch_dot_11": (lambda A, u, v: A.batch_dot(u, v, axes=(1, 1)),
                     [(3, 4), (3, 4)], False),
    "batch_dot_22": (lambda A, u, v: A.batch_dot(u, v, axes=(2, 2)),
                     [(3, 2, 4), (3, 5, 4)], False),
    "dot": (lambda A, u, v: A.dot(u, v), [(3, 2, 4), (3, 4, 5)], False),
    "l2_normalize": (lambda A, v: A.l2_normalize(v, axis=1), [X], False),
    "l2_normalize_floor": (lambda A, v: A.l2_normalize(v * 0.0, axis=-1),
                           [X], False),
    "expand_dims": (lambda A, v: A.expand_dims(v, 1), [X], False),
    "squeeze": (lambda A, v: A.squeeze(A.expand_dims(v, 2), 2), [X],
                False),
    "stack": (lambda A, u, v: A.stack([u, v], axis=1), [X, X], False),
    "concatenate": (lambda A, u, v: A.concatenate([u, v], axis=-1),
                    [X, X], False),
    "contiguous": (lambda A, v: A.contiguous(A.exp(v)), [X], False),
    "sugar_add_sub_mul": (lambda A, u, v: (u - v) * 2.0 + 1.0, [X, X],
                          False),
    "sugar_div": (lambda A, u, v: u / (v * v + 4.0), [X, X], False),
    "sugar_reflected": (lambda A, u, v: 3.0 - u + 2.0 * v + 1.0 / (
        v * v + 1.0), [X, X], False),
    "sugar_neg": (lambda A, u: -u, [X], False),
}


def _run(A, expr, arrays, to_t):
    vs = [A.Variable(input_shape=a.shape[1:]) for a in arrays]
    fn = A.to_function(vs, expr(A, *vs))
    return fn(*[to_t(a) for a in arrays])


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(ja, name):
    expr, shapes, positive = OPS[name]
    arrays = [_x(s, i, positive) for i, s in enumerate(shapes)]
    want = np.asarray(ja["jax"].device_get(
        _run(ja["A"], expr, arrays, lambda a: a)))
    got = _run(TA, expr, arrays, torch.from_numpy).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_inferred_shapes_are_the_outputs(ja):
    """The port builds modules from node shapes: every op's inferred
    shape is its output's (without the batch)."""
    for name, (expr, shapes, positive) in sorted(OPS.items()):
        arrays = [_x(s, i, positive) for i, s in enumerate(shapes)]
        vs = [TA.Variable(input_shape=a.shape[1:]) for a in arrays]
        node = expr(TA, *vs)
        out = TA.to_function(vs, node)(*[torch.from_numpy(a)
                                         for a in arrays])
        if out.ndim:
            assert node.shape == tuple(out.shape[1:]), name
    assert TA.epsilon() == ja["A"].epsilon()


def test_to_function_refuses_parameters_in_both(ja):
    from analytics_zoo_tpu_torch.keras.layers import Dense
    for A, D in ((TA, Dense), (ja["A"], ja["layers"].Dense)):
        v = A.Variable(input_shape=(3,))
        with pytest.raises(ValueError, match="parameterized"):
            A.to_function([v], D(2)(v))


def _model(Input, Model, layers, A):
    """Dense -> Lambda -> sugar -> Dense, the same in either package."""
    inp = Input(shape=(4,))
    h = layers.Dense(8, activation="relu", name="ag_hidden")(inp)
    h = A.Lambda(lambda a: a * 0.5)(h) - 0.25
    out = layers.Dense(1, name="ag_out")(2.0 * h)
    return Model(inp, out)


def _mae(A):
    return A.CustomLoss(lambda yt, yp: A.mean(A.abs(yt - yp), axis=1),
                        y_shape=(1,))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def test_custom_loss_fit_matches_jax(ja, tmp_path, monkeypatch):
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu_torch.learn import estimator
    from analytics_zoo_tpu_torch.learn.optimizers import Adam
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path))
    jax = ja["jax"]
    rng = np.random.RandomState(0)
    x = rng.randn(48, 4).astype(np.float32)
    y = x.sum(1, keepdims=True).astype(np.float32)
    jm = _model(ja["Input"], ja["Model"], ja["layers"], ja["A"])
    jm.compile(optimizer=ja["opt"].Adam(1e-2), loss=_mae(ja["A"]))
    tm = _model(Input, Model, tl, TA)
    tm.module.load_state_dict(flax_to_state_dict(
        jax.device_get(jm.get_weights())))
    tm.compile(optimizer=Adam(1e-2), loss=_mae(TA), device="cpu")
    # one step an epoch: each epoch's loss is a step's
    jh = jm.fit(x, y, batch_size=48, nb_epoch=3, shuffle=False)
    th = tm.fit(x, y, batch_size=48, nb_epoch=3, shuffle=False)
    assert len(tm.estimator.step_losses) == 3
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-5)
    jp = jax.device_get(jm.get_weights())
    got = dict(_leaves(state_dict_to_flax(tm.module.state_dict(), jp)))
    for path, want in _leaves(jp):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-5,
                                   err_msg=path)
    # the reference's spot check: CustomLoss.forward on arrays
    np.testing.assert_allclose(
        _mae(TA).forward(np.zeros((2, 1)), np.ones((2, 1))),
        _mae(ja["A"]).forward(np.zeros((2, 1)), np.ones((2, 1))))
