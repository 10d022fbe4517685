"""Calibrated int8 of the recurrent cells (``InferenceModel.quantize(
mode="int8")``) against the JAX package's interceptor, on the CPU.

flax's ``GRUCell``, ``LSTMCell`` and ``SimpleCell`` are trees of
``nn.Dense``; JAX's ``int8_interceptor`` runs each Dense as an integer
product with its own per-tensor activation scale and per-output-channel
weight scales. JAX's own ``calibrate_activations`` cannot reach them
inside a keras model (it reads ``float(max|x|)`` inside ``nn.RNN``'s
scan, which raises for GRU and SimpleRNN, and the keras LSTM's
``OptimizedLSTMCell`` holds ``DenseParams``), so the reference here is
JAX's observer and interceptor over the flax cell applied step by step
(``nn.LSTMCell`` for the LSTM: the same parameter names). Held, for a
GRU, an LSTM and a SimpleRNN layer (8 steps of 5 features, 6 units),
with every kernel stored int8 by the weight pass that precedes
calibration (``min_elems=1``: as in JAX, the ranges are read on the
dequantized weights and the stored q runs) and with none (the kernels
quantized by the interceptor's own rule):

- every Dense's int8 kernel and its scales bitwise JAX's
  (``quantize_tree``: the port's side products hold the Denses'
  kernels concatenated, row for row);
- the calibrated ranges under JAX's Dense names: the input side's
  bitwise (both read the same ``x``), the hidden side's within 1e-6
  relative (the packages' float cells round the state apart; measured
  up to 1.2e-7);
- the int8 output within ``test_torch_quantize.py``'s 1e-5 of JAX's
  interceptor given the port's ranges (measured: at most 1.2e-7).

JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.inference import InferenceModel

T, D, H = 8, 5, 6
INT8_ATOL = 1e-5
HIDDEN_RTOL = 1e-6
#: keras layer -> (flax cell name, flax cell class for the eager run,
#: its Denses input side first)
CELLS = {
    "GRU": ("GRUCell_0", "GRUCell", ("ir", "iz", "in"), ("hr", "hz", "hn")),
    "LSTM": ("OptimizedLSTMCell_0", "LSTMCell", ("ii", "if", "ig", "io"),
             ("hi", "hf", "hg", "ho")),
    "SimpleRNN": ("SimpleCell_0", "SimpleCell", ("i",), ("h",)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import flax.linen as fnn
    from analytics_zoo_tpu.inference import quantize as jq
    from analytics_zoo_tpu.keras import Input, Model
    from analytics_zoo_tpu.keras import layers as jl
    return dict(jax=jax, nn=fnn, jq=jq, jl=jl, Input=Input, Model=Model)


def _data(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(4, T, D).astype(np.float32) for _ in range(2)]


def _models(jx, kind):
    """The keras model (the sequence of states) in both packages, the
    port's holding JAX's initial parameters."""
    from analytics_zoo_tpu_torch.keras import Input, Model
    from analytics_zoo_tpu_torch.keras import layers as tl
    jin = jx["Input"](shape=(T, D))
    jm = jx["Model"](input=jin, output=getattr(jx["jl"], kind)(
        H, return_sequences=True)(jin))
    params = jx["jax"].device_get(jm.to_flax().init(
        jx["jax"].random.PRNGKey(3), np.zeros((2, T, D), np.float32))[
            "params"])
    tin = Input(shape=(T, D))
    tm = Model(input=tin, output=getattr(tl, kind)(
        H, return_sequences=True)(tin))
    tm.module.load_state_dict(flax_to_state_dict(params), strict=True)
    return tm, params


def _jax_cell_run(jx, kind, cell_params, x, interceptor):
    """The flax cell applied step by step under ``interceptor``: the
    states ``[b, T, H]``."""
    fnn, jnp = jx["nn"], jx["jax"].numpy
    cell = getattr(fnn, CELLS[kind][1])(features=H)
    carry = cell.initialize_carry(jx["jax"].random.PRNGKey(0), x[:, 0].shape)
    outs = []
    with fnn.intercept_methods(interceptor):
        for t in range(T):
            carry, y = cell.apply({"params": cell_params}, carry,
                                  jnp.asarray(x[:, t]))
            outs.append(np.asarray(y))
    return np.stack(outs, 1)


@pytest.mark.parametrize("min_elems", [1, 10 ** 6])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_int8_cell_is_jax_interceptor(jx, kind, min_elems):
    name, _, inputs, hidden = CELLS[kind]
    tm, params = _models(jx, kind)
    batches = _data(7)
    im = InferenceModel(device="cpu").load_zoo(tm)
    im.quantize(min_elems=min_elems, mode="int8", calibration_data=batches)
    act = im._act_ranges
    assert sorted(act) == sorted(f"{name}/{d}" for d in inputs + hidden)

    # JAX's observer over the eager cell on the weights it calibrates on
    # (dequantized where the weight pass stored them): ranges by Dense
    jq = jx["jq"]
    qtree = jq.quantize_tree(params[name], min_elems=min_elems)
    cell_params = jq.dequantize_tree(qtree)
    jamax = {}

    def observer(next_fun, args, kwargs, context):
        path = jq._module_path(context.module)
        if isinstance(context.module, jx["nn"].Dense):
            jamax[path] = max(jamax.get(path, 0.0),
                              float(np.abs(np.asarray(args[0])).max()))
        return next_fun(*args, **kwargs)

    for b in batches:
        _jax_cell_run(jx, kind, cell_params, b, observer)
    for d in inputs:
        assert act[f"{name}/{d}"] == jamax[d]
    for d in hidden:
        assert abs(act[f"{name}/{d}"] - jamax[d]) <= \
            HIDDEN_RTOL * jamax[d]

    # q and the weight scales: each Dense's rows of the side products
    # (JAX's stored leaves, or its rule on the float kernels)
    if min_elems > 1:
        qtree = jq.quantize_tree(params[name], min_elems=1)
    cell = im._module._modules[name]
    for side, dense in zip(cell.__dict__["_zoo_sides"], (inputs, hidden)):
        want_q = np.concatenate([np.asarray(qtree[d]["kernel"].q).T
                                 for d in dense])
        want_s = np.concatenate([np.asarray(qtree[d]["kernel"].scale)
                                 .reshape(-1) for d in dense])
        np.testing.assert_array_equal(side.wq.numpy(), want_q)
        np.testing.assert_array_equal(side.ws.numpy(), want_s)
        np.testing.assert_array_equal(
            side.s_in.numpy(), np.float32(max(act[f"{name}/{dense[0]}"],
                                              1e-8) / 127.0))

    # the int8 states against JAX's interceptor given the port's ranges
    x = _data(11)[0]
    got = im.predict(x)
    want = _jax_cell_run(jx, kind, cell_params, x, jq.int8_interceptor(
        {d: act[f"{name}/{d}"] for d in inputs + hidden},
        qtree if min_elems == 1 else None))
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL)
    # and the quantized states stay near the float ones
    float_out = InferenceModel(device="cpu").load_zoo(tm).predict(x)
    assert float(np.abs(got - float_out).max()) < 0.05


def test_int8_text_classifier_keeps_its_argmax():
    """A GRU TextClassifier (the widths cut to test size) in int8 against
    its own float predict: every argmax kept, within 0.05."""
    from analytics_zoo_tpu_torch.models import TextClassifier
    clf = TextClassifier(class_num=4, vocab_size=50, token_length=8,
                         sequence_length=12, encoder="gru",
                         encoder_output_dim=16)
    rng = np.random.RandomState(2)
    x = rng.randint(1, 50, (16, 12)).astype(np.float32)
    im = InferenceModel(device="cpu").load_zoo(clf)
    want = im.predict(x)
    im.quantize(min_elems=1, mode="int8", calibration_data=[x[:8]])
    got = im.predict(x)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9
    assert float(np.abs(got - want).max()) < 0.05
