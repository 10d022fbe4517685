"""The port's post-training int8 (``InferenceModel.quantize``) against the
JAX package's, on the CPU.

The same parameters (``convert.flax_to_state_dict``) and the same numpy
inputs go through both packages:

- weight mode: every ``QuantizedLeaf``'s q and scale bitwise equal to
  JAX's ``quantize_tree`` for a small NCF, a 2-block BERT (hidden 64, 4
  heads: the ``[in, h, d]`` projections, the ``[h, d]`` biases, the
  ``[h, d, out]`` output and the embedding tables), a TCN (its convs) and
  a ``resnet-lite`` ImageClassifier at 16 px (its 4-D kernels; the batch
  norms stay float, as in JAX);
  ``tree_nbytes`` and ``dequantize_tree`` equal; predictions within
  1e-5;
- int8 mode: the calibration dict has JAX's keys (no attention
  projection among them) with values within 1e-6 relative; one int8
  Dense (with an n that ``int_mm`` pads), one int8 Conv1D and one int8
  Conv2D / Conv3D (3x3 at stride 2 under XLA's SAME, 1x1, explicit and
  asymmetric padding) bitwise JAX's interceptor for the same input and
  amax, from a stored and from an on-the-fly kernel; whole models within
  1e-5 of JAX's int8 output with the same argmax (measured on this
  suite's inputs: NCF 1.5e-8, BERT 3.6e-7, TCN 0; weight mode: NCF
  3.0e-8, BERT 7.2e-7, TCN 4.8e-7); int8 ``resnet-lite`` against its own
  float output within JAX's limits (tests/test_inference_net.py: argmax
  agreement >= 0.97, nrmse < 0.1);
- ``mobilenet-v2`` at 32 px in both modes: q and scales bitwise JAX's,
  its 53 calibrated layers (17 depthwise) JAX's, the output within 1e-6;
  one grouped int8 Conv2D (depthwise, a depth multiplier of 2, two
  groups, and groups wide enough to leave float32's exact sums) bitwise
  JAX's interceptor;
- JAX's own quantize tests (tests/test_inference_net.py): idempotence,
  the errors, a bare ``torch.nn.Linear`` model refused, the byte shrink.

JAX is imported inside fixtures only: the card's machine has none.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.common import flax_compat
from analytics_zoo_tpu_torch.convert import flax_to_state_dict
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference import quantize as tq

NCF_ARGS = dict(user_count=50, item_count=30, class_num=5, user_embed=8,
                item_embed=6, hidden_layers=(16, 8), include_mf=True,
                mf_embed=7)
BERT_SMALL = dict(vocab=100, hidden_size=64, n_block=2, n_head=4,
                  intermediate_size=128, max_position_len=64)
BERT_LEN = 16
TCN_ARGS = dict(future_seq_len=2, num_channels=(8, 8), kernel_size=3,
                dropout=0.0)
#: whole int8 models against JAX's int8 output (measured above). An
#: ImageClassifier's convolutions quantize the outputs of batch norms,
#: which the packages compute a few fp32 ulps apart, so an activation on
#: a rounding boundary can land one step apart (about amax / 127) and the
#: difference rides on: resnet-lite is held within 1e-3 (measured: 2.5e-4)
INT8_ATOL = 1e-5
INT8_ATOL_LITE = 1e-3
INT8_ATOL_MNV2 = 1e-6
MNV2_RANGE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import flax.linen as fnn
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu.inference import quantize as jq
    return dict(jax=jax, nn=fnn, JIM=JIM, jq=jq)


def _pairs(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(1, 51, n), rng.randint(1, 31, n)],
                    1).astype(np.float32)


def _ncf(jx):
    """(JAX InferenceModel, port InferenceModel) holding one NCF's
    parameters."""
    from analytics_zoo_tpu.models.recommendation import NeuralCF as JNCF

    from analytics_zoo_tpu_torch.models import NeuralCF
    jim = jx["JIM"]().load_zoo(JNCF(**NCF_ARGS))
    params = jx["jax"].device_get(jim._params["params"])
    ncf = NeuralCF(**NCF_ARGS)
    ncf.model.module.load_state_dict(flax_to_state_dict(params))
    return jim, InferenceModel(device="cpu").load_zoo(ncf)


def _bert_ids(n, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, BERT_SMALL["vocab"], (n, BERT_LEN)).astype(np.int32)
    seg = (np.arange(BERT_LEN)[None] >= rng.randint(4, BERT_LEN, (n, 1))
           ).astype(np.int32)
    return ids, seg


def _bert(jx, use_flash=True):
    """The classifier of text/estimators.py in both packages, fed
    ``(ids, segments)``; JAX's sits under ``clf``."""
    from analytics_zoo_tpu.text import estimators as jest
    from analytics_zoo_tpu.text.bert import BertConfig as JConfig

    from analytics_zoo_tpu_torch.text import BertConfig
    from analytics_zoo_tpu_torch.text.estimators import _ClassifierModule
    fnn = jx["nn"]

    class TwoInput(fnn.Module):
        @fnn.compact
        def __call__(self, ids, seg):
            return jest._ClassifierModule(
                JConfig(use_flash=use_flash, **BERT_SMALL), 2,
                name="clf")(ids, seg, None)

    ids, seg = _bert_ids(2)
    jim = jx["JIM"]().load_flax(TwoInput(), (ids, seg))
    params = jx["jax"].device_get(jim._params["params"])["params"]["clf"]
    module = _ClassifierModule(BertConfig(use_flash=use_flash,
                                          **BERT_SMALL), 2)
    module.load_state_dict(flax_to_state_dict(params))
    return jim, InferenceModel(device="cpu").load_torch(module, (ids, seg))


def _tcn_x(n=32, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 3)).astype(np.float32)


def _tcn(jx):
    from analytics_zoo_tpu.zouwu.model import nets

    from analytics_zoo_tpu_torch.zouwu.model.nets import TemporalConvNet
    x = _tcn_x()
    jim = jx["JIM"]().load_flax(nets.TemporalConvNet(**TCN_ARGS), x[:2])
    net = TemporalConvNet(3, **TCN_ARGS)
    net.load_state_dict(flax_to_state_dict(
        jx["jax"].device_get(jim._params["params"])["params"]))
    return jim, InferenceModel(device="cpu").load_torch(net, x[:2])


LITE = dict(class_num=4, model_name="resnet-lite", image_size=16)


def _lite_x(n=24, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)


def _lite(jx):
    """``resnet-lite`` in both packages, its parameters and running
    statistics JAX's."""
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JImageClassifier,
    )

    from analytics_zoo_tpu_torch.models import ImageClassifier
    jim = jx["JIM"]().load_zoo(JImageClassifier(**LITE))
    variables = jx["jax"].device_get(jim._params)
    clf = ImageClassifier(**LITE)
    sd = flax_to_state_dict(variables["params"])
    sd.update(flax_to_state_dict(variables["model_state"]["batch_stats"]))
    clf.model.module.load_state_dict(sd, strict=True)
    return jim, InferenceModel(device="cpu").load_zoo(clf)


MNV2 = dict(class_num=4, model_name="mobilenet-v2", image_size=32)


def _mnv2_x(n=16, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _mnv2(jx):
    """``mobilenet-v2`` in both packages (its 17 depthwise convolutions
    grouped, one group a channel), parameters and statistics JAX's."""
    from analytics_zoo_tpu.models.image.imageclassification import (
        ImageClassifier as JImageClassifier,
    )

    from analytics_zoo_tpu_torch.models import ImageClassifier
    jim = jx["JIM"]().load_zoo(JImageClassifier(**MNV2))
    variables = jx["jax"].device_get(jim._params)
    clf = ImageClassifier(**MNV2)
    sd = flax_to_state_dict(variables["params"])
    sd.update(flax_to_state_dict(variables["model_state"]["batch_stats"]))
    clf.model.module.load_state_dict(sd, strict=True)
    return jim, InferenceModel(device="cpu").load_zoo(clf)


MODELS = {"ncf": (_ncf, lambda: _pairs(64, 1), 64),
          "bert": (_bert, lambda: _bert_ids(24, 1), 64),
          "tcn": (_tcn, _tcn_x, 16),
          "lite": (_lite, _lite_x, 64)}


def _jax_tree(name, jim):
    tree = jim._params["params"]
    return tree["params"]["clf"] if name == "bert" else (
        tree["params"] if name == "tcn" else tree)


def _compare(jq, want, got, path=""):
    """Bitwise equality of two quantized trees; the quantized paths."""
    out = []
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            out += _compare(jq, want[k], got[k], f"{path}/{k}")
    elif isinstance(want, jq.QuantizedLeaf):
        assert isinstance(got, tq.QuantizedLeaf), path
        assert got.q.dtype == np.int8 and got.scale.dtype == np.float32
        np.testing.assert_array_equal(got.q, np.asarray(want.q))
        np.testing.assert_array_equal(got.scale, np.asarray(want.scale))
        out.append(path)
    else:
        assert not isinstance(got, tq.QuantizedLeaf), path
        np.testing.assert_array_equal(got, np.asarray(want))
    return out


def _predict(name, im, x):
    return np.asarray(im.predict(x, batch_size=len(x[0]) if name == "bert"
                                 else len(x)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weight_mode_is_jax_bit_for_bit(jx, name):
    make, data, min_elems = MODELS[name]
    jim, im = make(jx)
    x = data()
    jim.quantize(min_elems=min_elems)
    im.quantize(min_elems=min_elems)
    quantized = _compare(jx["jq"], jx["jax"].device_get(
        _jax_tree(name, jim)), im._qtree)
    assert quantized, "nothing was quantized"
    assert tq.tree_nbytes(im._qtree) == jx["jq"].tree_nbytes(
        _jax_tree(name, jim))
    _compare(jx["jq"], jx["jax"].device_get(jx["jq"].dequantize_tree(
        _jax_tree(name, jim))), tq.dequantize_tree(im._qtree))
    if name == "bert":
        # the flax layouts JAX's rule runs on: [in, h, d] projections
        # (one scale per d), their [h, d] biases, [h, d, out] outputs
        att = "/bert/block_0/attention"
        assert {f"{att}/query/kernel", f"{att}/query/bias",
                f"{att}/out/kernel", "/bert/word_embeddings/embedding"} \
            <= set(quantized)
        assert im._qtree["bert"]["block_0"]["attention"]["query"][
            "kernel"].scale.shape == (1, 1, BERT_SMALL["hidden_size"]
                                      // BERT_SMALL["n_head"])
    np.testing.assert_allclose(_predict(name, im, x),
                               np.asarray(jim.predict(x)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_int8_mode_matches_jax(jx, name):
    make, data, min_elems = MODELS[name]
    jim, im = make(jx)
    x = data()
    calib = tuple(a[:16] for a in x) if isinstance(x, tuple) else x[:16]
    jim.quantize(mode="int8", calibration_data=calib, min_elems=min_elems)
    im.quantize(mode="int8", calibration_data=calib, min_elems=min_elems)
    want_ranges = {k[len("clf/"):] if name == "bert" else k: v
                   for k, v in jim._act_ranges.items()}
    assert set(im._act_ranges) == set(want_ranges)
    for k, v in want_ranges.items():
        assert im._act_ranges[k] == pytest.approx(v, rel=1e-6), k
    if name == "bert":
        # JAX intercepts nn.Dense only: the FFN, the pooler, the head —
        # never an attention projection (DenseGeneral)
        assert not [k for k in im._act_ranges if "attention" in k]
        assert {"bert/block_0/intermediate", "bert/block_1/output",
                "bert/pooler", "classifier"} <= set(im._act_ranges)
    got, want = _predict(name, im, x), np.asarray(jim.predict(x))
    np.testing.assert_allclose(
        got, want, rtol=0, atol=INT8_ATOL_LITE if name == "lite"
        else INT8_ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("k,n", [(12, 5), (16, 24)])
def test_one_int8_dense_is_jax_bit_for_bit(jx, stored, k, n):
    """n = 5 pads to 8 and k = 12 to 16 inside ``int_mm``."""
    fnn, jnp = jx["nn"], jx["jax"].numpy
    jq = jx["jq"]

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(n, name="d")(x)

    x = np.random.RandomState(k + n).randn(3, 7, k).astype(np.float32)
    params = J().init(jx["jax"].random.PRNGKey(1), x)["params"]
    amax = float(np.abs(x).max()) * 0.8           # some inputs clip
    qparams = jq.quantize_tree(params, min_elems=1) if stored else None
    with fnn.intercept_methods(jq.int8_interceptor({"d": amax}, qparams)):
        want = np.asarray(J().apply({"params": params}, jnp.asarray(x)))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.d = flax_compat.Dense(k, n)

        def forward(self, a):
            return self.d(a)

    mod = T()
    mod.load_state_dict(flax_to_state_dict(jx["jax"].device_get(params)))
    if stored:
        tq.quantize_module(mod, min_elems=1)
    assert tq.int8_modules(mod, {"d": amax}) == ["d"]
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("kernel,dilation", [(3, 1), (7, 4)])
def test_one_int8_conv1d_is_jax_bit_for_bit(jx, stored, kernel, dilation):
    fnn, jnp = jx["nn"], jx["jax"].numpy
    jq = jx["jq"]

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(6, (kernel,), kernel_dilation=(dilation,),
                            padding="VALID", name="c")(x)

    x = np.random.RandomState(kernel).randn(4, 40, 5).astype(np.float32)
    params = J().init(jx["jax"].random.PRNGKey(dilation), x)["params"]
    amax = float(np.abs(x).max())
    qparams = jq.quantize_tree(params, min_elems=1) if stored else None
    with fnn.intercept_methods(jq.int8_interceptor({"c": amax}, qparams)):
        want = np.asarray(J().apply({"params": params}, jnp.asarray(x)))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c = flax_compat.Conv(5, 6, kernel, dilation)

        def forward(self, a):
            return self.c(a)

    mod = T()
    mod.load_state_dict(flax_to_state_dict(jx["jax"].device_get(params)))
    if stored:
        tq.quantize_module(mod, min_elems=1)
    tq.int8_modules(mod, {"c": amax})
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("kernel,strides,padding", [
    ((3, 3), (2, 2), "SAME"), ((1, 1), (1, 1), "VALID"),
    ((1, 1), (2, 2), "SAME"), ((3, 3), (1, 1), ((1, 1), (1, 1))),
    ((3, 2), (2, 1), ((0, 1), (2, 0))), ((2, 3, 3), (1, 2, 2), "SAME")])
def test_one_int8_conv2d_and_3d_is_jax_bit_for_bit(jx, stored, kernel,
                                                   strides, padding):
    fnn, jnp = jx["nn"], jx["jax"].numpy
    jq = jx["jq"]

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(6, kernel, strides=strides, padding=padding,
                            name="c")(x)

    shape = (4,) + (9,) * len(kernel) + (5,)
    x = np.random.RandomState(len(kernel)).randn(*shape).astype(np.float32)
    params = J().init(jx["jax"].random.PRNGKey(1), x)["params"]
    amax = float(np.abs(x).max())
    qparams = jq.quantize_tree(params, min_elems=1) if stored else None
    with fnn.intercept_methods(jq.int8_interceptor({"c": amax}, qparams)):
        want = np.asarray(J().apply({"params": params}, jnp.asarray(x)))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c = flax_compat.Conv(5, 6, kernel, strides=strides,
                                      padding=padding)

        def forward(self, a):
            return self.c(a)

    mod = T()
    mod.load_state_dict(flax_to_state_dict(jx["jax"].device_get(params)))
    if stored:
        tq.quantize_module(mod, min_elems=1)
    tq.int8_modules(mod, {"c": amax})
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["weight", "int8"])
def test_mobilenet_v2_is_jax_bit_for_bit(jx, mode):
    """``mobilenet-v2`` at 32 px, calibrated on 8 rows: every quantized
    leaf's q and scale bitwise JAX's (the depthwise kernels ``[3, 3, 1,
    c]`` among them where they reach ``min_elems``), the calibrated
    layers JAX's (52 convolutions, 17 of them depthwise, and the Dense),
    and the output within ``INT8_ATOL_MNV2`` of JAX's with the same
    argmax (measured: 4.5e-7 in int8 mode). The activation ranges are
    held at ``MNV2_RANGE_RTOL``: they are the max |x| after eval-mode
    batch norms, which the packages compute a few fp32 ulps apart
    (measured: 1.3e-6)."""
    jim, im = _mnv2(jx)
    x = _mnv2_x()
    if mode == "weight":
        jim.quantize(min_elems=1024)
        im.quantize(min_elems=1024)
    else:
        jim.quantize(mode="int8", calibration_data=x[:8], min_elems=1024)
        im.quantize(mode="int8", calibration_data=x[:8], min_elems=1024)
        assert set(im._act_ranges) == set(jim._act_ranges)
        assert len(im._act_ranges) == 53
        assert sum(k.startswith("keraslayerwrapper_")
                   for k in im._act_ranges) == 17
        for k, v in jim._act_ranges.items():
            assert im._act_ranges[k] == pytest.approx(
                v, rel=MNV2_RANGE_RTOL), k
    quantized = _compare(jx["jq"], jx["jax"].device_get(
        jim._params["params"]), im._qtree)
    assert any(k.startswith("/keraslayerwrapper_") for k in quantized)
    got, want = _predict("mnv2", im, x), np.asarray(jim.predict(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=INT8_ATOL_MNV2)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("stored", [False, True])
@pytest.mark.parametrize("cin,cout,groups,strides,padding", [
    (6, 6, 6, (1, 1), ((1, 1), (1, 1))), (6, 6, 6, (2, 2), "SAME"),
    (4, 8, 4, (2, 2), ((1, 1), (1, 1))), (6, 4, 2, (1, 1), "VALID"),
    # 9 * 120 taps a group: past float32's exact sums, one int_mm a group
    (240, 8, 2, (1, 1), "SAME")])
def test_one_int8_grouped_conv_is_jax_bit_for_bit(jx, stored, cin, cout,
                                                  groups, strides, padding):
    """A grouped Conv2D (JAX passes ``feature_group_count`` to its int8
    convolution) bitwise JAX's interceptor: the depthwise and small
    groups through the exact float32 grouped convolution, the wide
    groups through ``int_mm``."""
    fnn, jnp = jx["nn"], jx["jax"].numpy
    jq = jx["jq"]

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Conv(cout, (3, 3), strides=strides, padding=padding,
                            feature_group_count=groups, name="c")(x)

    x = np.random.RandomState(cin).randn(3, 9, 9, cin).astype(np.float32)
    params = J().init(jx["jax"].random.PRNGKey(2), x)["params"]
    amax = float(np.abs(x).max())
    qparams = jq.quantize_tree(params, min_elems=1) if stored else None
    with fnn.intercept_methods(jq.int8_interceptor({"c": amax}, qparams)):
        want = np.asarray(J().apply({"params": params}, jnp.asarray(x)))

    class T(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c = flax_compat.Conv(cin, cout, (3, 3), strides=strides,
                                      padding=padding,
                                      feature_group_count=groups)

        def forward(self, a):
            return self.c(a)

    mod = T()
    mod.load_state_dict(flax_to_state_dict(jx["jax"].device_get(params)))
    if stored:
        tq.quantize_module(mod, min_elems=1)
    tq.int8_modules(mod, {"c": amax})
    got = mod(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int8_resnet_lite_within_jax_limits(jx):
    _, im = _lite(jx)
    x = _lite_x(64, seed=5)
    want = np.asarray(im.predict(x, batch_size=32))
    # calibrated on half the rows, as JAX's own limit test does
    im.quantize(mode="int8", calibration_data=x[:32], min_elems=1024)
    assert len(im._act_ranges) == 10      # nine convolutions, the Dense
    got = np.asarray(im.predict(x, batch_size=32))
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    nrmse = float(np.sqrt(np.mean((got - want) ** 2)) / want.std())
    assert agree >= 0.97 and nrmse < 0.1, (agree, nrmse)


def test_int_mm_pads_every_dimension_exactly():
    rng = np.random.RandomState(0)
    for m, k, n in ((1, 5, 2), (16, 8, 8), (33, 20, 10)):
        a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
        got = tq.int_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        np.testing.assert_array_equal(
            got.numpy(), a.numpy().astype(np.int64) @ b.numpy().astype(
                np.int64))


def test_bf16_activation_is_divided_in_float32():
    """JAX's x / s_in promotes a bf16 x to float32; torch would keep bf16
    for a 0-dim divisor, rounding twice."""
    x = torch.tensor([0.7578125, -1.3046875, 2.015625], dtype=torch.bfloat16)
    s = tq._act_scale(2.015625)
    want = np.clip(np.round(x.float().numpy() / np.float32(s.item())),
                   -127, 127).astype(np.int8)
    np.testing.assert_array_equal(tq.quantize_activation(x, s).numpy(),
                                  want)


# ------------------------------------------- JAX's own quantize tests

def _mlp_model():
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as zl
    m = Sequential()
    m.add(zl.Dense(16, activation="relu", input_shape=(8,)))
    m.add(zl.Dense(3))
    return m


def test_quantize_is_idempotent():
    x = np.random.RandomState(9).randn(8, 8).astype(np.float32)
    im = InferenceModel(device="cpu").load_zoo(_mlp_model())
    im.quantize(min_elems=4)
    once, tree = im.predict(x), im._qtree
    im.quantize(min_elems=4)        # a second call keeps what it had
    np.testing.assert_array_equal(im.predict(x), once)
    assert tq.tree_nbytes(im._qtree) == tq.tree_nbytes(tree)


def test_quantize_requires_model():
    with pytest.raises(RuntimeError, match="load a model"):
        InferenceModel(device="cpu").quantize()


def test_mode_and_calibration_are_checked():
    im = InferenceModel(device="cpu").load_zoo(_mlp_model())
    with pytest.raises(ValueError, match="'weight' or 'int8'"):
        im.quantize(mode="int4")
    with pytest.raises(ValueError, match="calibration_data"):
        im.quantize(mode="int8")
    with pytest.raises(ValueError, match="empty"):
        im.quantize(mode="int8", calibration_data=[])


def test_bare_torch_linear_model_refused_with_clear_error():
    """A user module of bare ``torch.nn.Linear`` layers has no flax Dense
    counterpart: calibration says so instead of silently doing nothing,
    as JAX refuses torch-translated graphs."""
    m = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU())
    x = np.zeros((4, 8), np.float32)
    im = InferenceModel(device="cpu").load_torch(m, x)
    with pytest.raises(ValueError, match="no flax nn.Dense"):
        im.quantize(mode="int8", calibration_data=x)


def test_recurrent_cells_refused_in_int8_mode():
    """Recurrent cells are no longer refused in int8 mode: the GRU's six
    Denses and the head calibrate and run int8 (their parity with JAX's
    interceptor is tests/test_torch_quantize_recurrent.py's); weight mode
    still covers them."""
    from analytics_zoo_tpu_torch.keras import Sequential
    from analytics_zoo_tpu_torch.keras import layers as zl
    m = Sequential()
    m.add(zl.GRU(8, input_shape=(5, 4)))
    m.add(zl.Dense(2))
    x = np.random.RandomState(0).randn(4, 5, 4).astype(np.float32)
    im = InferenceModel(device="cpu").load_zoo(m)
    want = im.predict(x)
    im.quantize(mode="int8", calibration_data=x)
    assert sorted(k for k in im._act_ranges if k.startswith("GRUCell_0")) \
        == [f"GRUCell_0/{d}" for d in ("hn", "hr", "hz", "in", "ir", "iz")]
    got = im.predict(x)
    assert got.shape == (4, 2) and float(np.abs(got - want).max()) < 0.05
    im2 = InferenceModel(device="cpu").load_zoo(m)
    im2.quantize(min_elems=16)       # weight mode covers them
    assert im2.predict(x).shape == (4, 2)


def test_weight_int8_shrinks_and_keeps_the_argmax():
    from analytics_zoo_tpu_torch.models import NeuralCF
    args = dict(NCF_ARGS, user_count=2000, item_count=1000, user_embed=32,
                item_embed=32, mf_embed=32, hidden_layers=(64, 32))
    rng = np.random.RandomState(8)
    x = np.stack([rng.randint(1, 2001, 256), rng.randint(1, 1001, 256)],
                 1).astype(np.float32)
    ncf = NeuralCF(**args)
    im = InferenceModel(device="cpu").load_zoo(ncf)
    before, bytes_before = im.predict(x), tq.resident_bytes(im._module)
    im.quantize(min_elems=1024)
    after, bytes_after = im.predict(x), tq.resident_bytes(im._module)
    # the tables and kernels dominate: int8 keeps them resident at a
    # quarter of the bytes, plus one scale per channel
    assert bytes_after < 0.3 * bytes_before, (bytes_after, bytes_before)
    assert tq.tree_nbytes(im._qtree) == bytes_after
    assert (after.argmax(1) == before.argmax(1)).mean() >= 0.97
    np.testing.assert_allclose(after, before, atol=0.03)


def test_quantized_model_serves_unchanged():
    from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                                 InputQueue, OutputQueue)
    x = np.random.RandomState(3).randn(8, 8).astype(np.float32)
    im = InferenceModel(device="cpu").load_zoo(_mlp_model())
    im.quantize(mode="int8", calibration_data=x, min_elems=16)
    want = [im.predict(x[i:i + 1], batch_size=4)[0] for i in range(4)]
    with Broker.launch(backend="python") as b, \
            ClusterServing(im, b.port, batch_size=4, max_batch_size=4,
                           warmup=False):
        in_q, out_q = InputQueue(port=b.port), OutputQueue(port=b.port)
        uris = [in_q.enqueue(f"q{i}", x=x[i]) for i in range(4)]
        for i, u in enumerate(uris):
            np.testing.assert_array_equal(out_q.query(u, timeout=30.0),
                                          want[i])
