"""The port's OpenVINO IR import (``net/openvino_net.py``,
``InferenceModel.load_openvino``) against the JAX package's, on the CPU.

No openvino package exists on either machine, so the IRs are built by
hand (tests/torch_model_files.py's ``IRBuilder``, a JAX-free copy of
tests/test_openvino.py's): JAX's test graphs (the MLP, conv + bias +
BatchNormInference + MaxPool, ReduceMean/Reshape on static consts, the
opset1 BatchNorm input order, two inputs, Unsqueeze's negative axes,
Gather with ``batch_dims`` both ways, a dangling unsupported layer,
ceil-mode Max- and AvgPool with and without exclude-pad, the window
that starts in the padding, ``same_upper``) and the rest of JAX's
subset (``same_lower`` with odd padding, GroupConvolution, PReLU,
Clamp, Elu, Sigmoid, Tanh, Power, Sqrt, Exp, Divide, Subtract,
Transpose, Concat, Squeeze, SoftMax, MatMul's transposes). Each IR runs
through both packages on the same seeded input: within 1e-5 (fp32).
An unsupported layer raises ``NotImplementedError`` naming it in both.
JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.net import Net, OpenVINONet
from torch_model_files import IRBuilder


@pytest.fixture(scope="module")
def jv():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu.net import openvino_net
    return dict(ov=openvino_net, IM=JIM)


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _param(b, shape):
    return b.layer("Parameter", {"shape": ",".join(map(str, shape)),
                                 "element_type": "f32"}, out_shape=shape)


def _chain(b, src, layers):
    """Wire ``layers`` [(type, attrs, [extra const arrays], version)] one
    after another from ``src`` (input 0), each extra const an input;
    ends in a Result."""
    last = src
    for typ, attrs, consts, version in layers:
        lay = b.layer(typ, attrs, 1 + len(consts), (), version=version)
        b.edge(last, lay, 0)
        for i, arr in enumerate(consts):
            b.edge(b.const(arr), lay, i + 1)
        last = lay
    res = b.layer("Result", None, 1)
    b.edge(last, res, 0)
    return b


def _mlp():
    b = IRBuilder()
    x = _param(b, (4, 6))
    return _chain(b, x, [
        ("MatMul", {"transpose_a": "false", "transpose_b": "false"},
         [_r(0, 6, 8)], "opset1"),
        ("Add", None, [_r(1, 8)], "opset1"),
        ("ReLU", None, [], "opset1"),
        ("MatMul", {"transpose_b": "true"}, [_r(2, 3, 8)], "opset1"),
        ("Add", None, [_r(3, 3)], "opset1"),
        ("SoftMax", {"axis": "1"}, [], "opset1")]), [_r(4, 4, 6)]


def _conv_bn_pool():
    b = IRBuilder()
    x = _param(b, (2, 3, 8, 8))
    return _chain(b, x, [
        ("Convolution", {"strides": "1,1", "pads_begin": "1,1",
                         "pads_end": "1,1", "dilations": "1,1",
                         "auto_pad": "explicit"},
         [_r(0, 4, 3, 3, 3, scale=0.3)], "opset1"),
        ("Add", None, [_r(1, 1, 4, 1, 1)], "opset1"),
        ("BatchNormInference", {"eps": "1e-05"},
         [np.abs(_r(2, 4)) + 0.5, _r(3, 4), _r(4, 4),
          np.abs(_r(5, 4)) + 0.5], "opset5"),
        ("MaxPool", {"kernel": "2,2", "strides": "2,2", "pads_begin": "0,0",
                     "pads_end": "0,0"}, [], "opset1")]), \
        [_r(6, 2, 3, 8, 8)]


def _reshape_reduce():
    b = IRBuilder()
    x = _param(b, (2, 3, 4))
    return _chain(b, x, [
        ("ReduceMean", {"keep_dims": "false"}, [np.array([2], np.int64)],
         "opset1"),
        ("Reshape", {"special_zero": "false"},
         [np.array([3, 2], np.int64)], "opset1")]), \
        [np.arange(24, dtype=np.float32).reshape(2, 3, 4)]


def _bn_opset1():
    b = IRBuilder()
    x = _param(b, (2, 3, 4, 4))
    consts = [np.abs(_r(1, 3)) + 0.5, _r(2, 3), _r(3, 3),
              np.abs(_r(4, 3)) + 0.5]
    cg, cb = b.const(consts[0]), b.const(consts[1])
    cm, cv = b.const(consts[2]), b.const(consts[3])
    bn = b.layer("BatchNormInference", {"eps": "1e-5"}, 5, (),
                 version="opset1")
    for port, src in enumerate((cg, cb, x, cm, cv)):   # data third
        b.edge(src, bn, port)
    res = b.layer("Result", None, 1)
    b.edge(bn, res, 0)
    return b, [_r(5, 2, 3, 4, 4)]


def _two_inputs():
    b = IRBuilder()
    a, c = _param(b, (2, 3)), _param(b, (2, 3))
    sub = b.layer("Subtract", None, 2, ())
    b.edge(a, sub, 0)
    b.edge(c, sub, 1)
    return _chain(b, sub, [("Multiply", None, [_r(0, 2, 3)], "opset1")]), \
        [_r(1, 2, 3), _r(2, 2, 3)]


def _unsqueeze_squeeze():
    b = IRBuilder()
    x = _param(b, (3,))
    return _chain(b, x, [
        ("Unsqueeze", None, [np.array([-2, -1], np.int64)], "opset1"),
        ("Transpose", None, [np.array([1, 0, 2], np.int64)], "opset1"),
        ("Squeeze", None, [np.array([0], np.int64)], "opset1")]), \
        [np.arange(3, dtype=np.float32)]


def _gather_attr_axis():
    b = IRBuilder()
    x = _param(b, (2, 4))
    return _chain(b, x, [
        ("Gather", {"batch_dims": "1", "axis": "1"},
         [np.array([[0], [1]], np.int64)], "opset8")]), \
        [np.arange(8, dtype=np.float32).reshape(2, 4)]


def _gather_batch_dims():
    b = IRBuilder()
    x = _param(b, (2, 3, 4))
    return _chain(b, x, [
        ("Gather", {"batch_dims": "1"},
         [np.array([[2, 0], [1, -1]], np.int64),
          np.array(1, np.int64).reshape(())], "opset8")]), \
        [np.arange(24, dtype=np.float32).reshape(2, 3, 4)]


def _dangling():
    b = IRBuilder()
    x = _param(b, (2, 3))
    _chain(b, x, [("ReLU", None, [], "opset1")])
    b.layer("NonMaxSuppression", None, 0, (1,))
    return b, [np.array([[-1.0, 0.0, 2.0]] * 2, np.float32)]


def _conv_pool(pool_type, pool_attrs, in_shape, kernel=1, seed=0,
               conv_attrs=None):
    b = IRBuilder()
    x = _param(b, in_shape)
    layers = [("Convolution", conv_attrs or {
        "strides": "1,1", "pads_begin": "0,0", "pads_end": "0,0",
        "dilations": "1,1"},
        [_r(seed, 4, in_shape[1], kernel, kernel, scale=0.3)], "opset1")]
    if pool_type:
        layers.append((pool_type, pool_attrs, [], "opset1"))
    return _chain(b, x, layers), [_r(seed + 1, *in_shape)]


def _group_prelu_activations():
    b = IRBuilder()
    x = _param(b, (2, 4, 6, 6))
    return _chain(b, x, [
        ("GroupConvolution", {"strides": "2,1", "pads_begin": "1,0",
                              "pads_end": "0,1", "dilations": "1,2"},
         [_r(0, 2, 3, 2, 3, 3, scale=0.3)], "opset1"),
        ("PReLU", None, [np.abs(_r(1, 6)) * 0.2], "opset1"),
        ("Elu", {"alpha": "0.7"}, [], "opset1"),
        ("Clamp", {"min": "-0.5", "max": "1.5"}, [], "opset1"),
        ("Sigmoid", None, [], "opset1"),
        ("Power", None, [np.array([2.0], np.float32)], "opset1"),
        ("Sqrt", None, [], "opset1"),
        ("Exp", None, [], "opset1"),
        ("Tanh", None, [], "opset1"),
        ("Divide", None, [np.abs(_r(2, 1, 6, 1, 1)) + 1.0], "opset1"),
        ("Concat", {"axis": "1"}, [_r(3, 2, 2, 3, 3)], "opset1")]), \
        [_r(4, 2, 4, 6, 6)]


GRAPHS = {
    "mlp": _mlp, "conv_bn_pool": _conv_bn_pool,
    "reshape_reduce": _reshape_reduce, "bn_opset1": _bn_opset1,
    "two_inputs": _two_inputs, "unsqueeze_squeeze": _unsqueeze_squeeze,
    "gather_attr_axis": _gather_attr_axis,
    "gather_batch_dims": _gather_batch_dims, "dangling": _dangling,
    "ceil_maxpool": lambda: _conv_pool(
        "MaxPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "0,0",
                    "pads_end": "0,0", "rounding_type": "ceil"},
        (1, 3, 11, 11), kernel=3),
    "ceil_avgpool_exclude_pad": lambda: _conv_pool(
        "AvgPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "0,0",
                    "pads_end": "0,0", "rounding_type": "ceil",
                    "exclude-pad": "true"}, (1, 2, 7, 7), seed=2),
    "ceil_window_in_padding": lambda: _conv_pool(
        "MaxPool", {"kernel": "2,2", "strides": "2,2", "pads_begin": "1,1",
                    "pads_end": "1,1", "rounding_type": "ceil"},
        (1, 2, 3, 3), seed=4),
    "ceil_avgpool_include_pad": lambda: _conv_pool(
        "AvgPool", {"kernel": "3,3", "strides": "2,2", "pads_begin": "1,0",
                    "pads_end": "0,0", "rounding_type": "ceil",
                    "exclude-pad": "false"}, (1, 2, 7, 8), seed=6),
    "same_upper": lambda: _conv_pool(
        "MaxPool", {"kernel": "2,2", "strides": "2,2",
                    "auto_pad": "same_upper"}, (1, 3, 7, 8), kernel=3,
        seed=8, conv_attrs={"strides": "2,1", "auto_pad": "same_upper",
                            "dilations": "1,1"}),
    "same_lower": lambda: _conv_pool(
        "AvgPool", {"kernel": "3,2", "strides": "2,2",
                    "auto_pad": "same_lower", "exclude-pad": "true"},
        (1, 3, 8, 7), kernel=2, seed=10,
        conv_attrs={"strides": "1,2", "auto_pad": "same_lower",
                    "dilations": "1,1"}),
    "group_prelu_activations": _group_prelu_activations,
}


def _files(name, tmp_path):
    b, xs = GRAPHS[name]()
    xp, bp = b.write(tmp_path)
    return xp, bp, xs


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ir_matches_jax(jv, tmp_path, name):
    xp, bp, xs = _files(name, tmp_path)
    want = np.asarray(jv["ov"].OpenVINONet(xp, bp).predict(*xs))
    net = OpenVINONet(xp, bp, device="cpu")
    got = net.predict(*xs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jp = jv["ov"].OpenVINONet(xp, bp).params
    assert sorted(net.params) == sorted(jp)


@pytest.mark.parametrize("name", ["mlp", "conv_bn_pool", "two_inputs"])
def test_inference_model_load_openvino_matches_jax(jv, tmp_path, name):
    xp, bp, xs = _files(name, tmp_path)
    x = xs[0] if len(xs) == 1 else tuple(xs)
    want = jv["IM"]().load_openvino(xp, bp, batch_size=4).predict(x)
    im = InferenceModel(device="cpu").load_openvino(xp, bp, batch_size=4)
    np.testing.assert_allclose(im.predict(x), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        Net.load_openvino(xp, bp, device="cpu").predict(*xs),
        np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unsupported_layer_raises_in_both(jv, tmp_path):
    b = IRBuilder()
    x = _param(b, (1, 4))
    _chain(b, x, [("NonMaxSuppression", None, [], "opset1")])
    xp, bp = b.write(tmp_path)
    for net in (OpenVINONet(xp, bp, device="cpu"),
                jv["ov"].OpenVINONet(xp, bp, jit=False)):
        with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
            net.predict(np.zeros((1, 4), np.float32))


def test_needs_a_device_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xp, bp, _ = _files("mlp", tmp_path)
    for load in (lambda: OpenVINONet(xp, bp),
                 lambda: Net.load_openvino(xp, bp),
                 lambda: InferenceModel().load_openvino(xp, bp)):
        with pytest.raises(RuntimeError, match="CUDA"):
            load()
