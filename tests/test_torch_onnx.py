"""The port's ONNX import (``net/onnx_net.py``) against the JAX package's,
on the CPU.

No ``onnx`` package exists on either machine, so the graphs are encoded
by hand (tests/torch_model_files.py, a JAX-free copy of
tests/test_onnx.py's encoder): JAX's test graphs (the MLP, Gemm with
``transB`` and ``alpha``, conv + BatchNormalization + pools, the omitted
zero attribute, Flatten's 2-D rule, AveragePool's excluded padding,
``auto_pad`` SAME_UPPER, the unary chain, LeakyRelu/Elu/Clip/Pow, both
Clip forms, ReduceMean/Expand/Where/Pad/ReduceSum, Cast and both Slice
forms, Pad's float value, ReduceSum's empty axes) and a few of the
remaining ops (asymmetric pads, SAME_LOWER, Gemm's ``transA`` and
``beta``, Gather, Transpose, Reshape, Squeeze/Unsqueeze, Constant,
Erf/Sigmoid/Tanh/Div/Sub/Mul, MatMul on 3-D). Each graph runs through
both packages on the same seeded input: within 1e-5 (fp32). The
parameters are the same float initializers, the integer ones stay host
constants in both. An unsupported op raises ``NotImplementedError``
naming it, and bytes that are no ModelProto ``ValueError``, in both.
JAX is imported by fixtures only.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.net import Net, ONNXNet, onnx_to_torch
from torch_model_files import (_int_field, _len_field, attr_float,
                               attr_int, attr_ints, model_proto, node,
                               tensor_proto)


@pytest.fixture(scope="module")
def jo():
    pytest.importorskip("jax")
    from analytics_zoo_tpu.net import onnx_net
    return onnx_net


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _f(v):
    return np.float32(v).reshape(())


def _mlp():
    w1, b1, w2, b2 = _r(0, 4, 8), _r(1, 8), _r(2, 8, 3), _r(3, 3)
    nodes = [node("Gemm", ["x", "w1", "b1"], ["h"]),
             node("Relu", ["h"], ["a"]),
             node("Gemm", ["a", "w2", "b2"], ["y"],
                  attrs=[attr_float("alpha", 1.0)]),
             node("Softmax", ["y"], ["p"], attrs=[attr_int("axis", -1)])]
    inits = [tensor_proto(n, v) for n, v in
             (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2))]
    return model_proto(nodes, inits, ["x", "w1", "b1", "w2", "b2"], ["p"]), \
        [_r(4, 5, 4)]


def _gemm():
    nodes = [node("Gemm", ["x", "w", "b"], ["g"],
                  attrs=[attr_int("transB", 1)]),
             node("MatMul", ["g", "m"], ["mm"]),
             node("Add", ["mm", "c"], ["y"])]
    inits = [tensor_proto("w", _r(1, 3, 4)), tensor_proto("b", _r(2, 3)),
             tensor_proto("m", _r(3, 3, 2)), tensor_proto("c", _r(4, 2))]
    return model_proto(nodes, inits, ["x", "w", "b", "m", "c"], ["y"]), \
        [_r(5, 6, 4)]


def _gemm_trans_a_beta():
    nodes = [node("Gemm", ["x", "w", "b"], ["y"],
                  attrs=[attr_int("transA", 1), attr_int("transB", 1),
                         attr_float("alpha", 0.5), attr_float("beta", 2.0)])]
    inits = [tensor_proto("w", _r(1, 3, 6)), tensor_proto("b", _r(2, 3))]
    return model_proto(nodes, inits, ["x", "w", "b"], ["y"]), [_r(3, 6, 4)]


def _conv_bn():
    nodes = [node("Conv", ["x", "w", "b"], ["c"],
                  attrs=[attr_ints("kernel_shape", [3, 3]),
                         attr_ints("strides", [1, 1]),
                         attr_ints("pads", [1, 1, 1, 1])]),
             node("BatchNormalization", ["c", "scale", "bias", "mean",
                                         "var"], ["n"],
                  attrs=[attr_float("epsilon", 1e-3)]),
             node("Relu", ["n"], ["r"]),
             node("MaxPool", ["r"], ["p"],
                  attrs=[attr_ints("kernel_shape", [2, 2]),
                         attr_ints("strides", [2, 2])]),
             node("GlobalAveragePool", ["p"], ["gap"]),
             node("Flatten", ["gap"], ["y"], attrs=[attr_int("axis", 1)])]
    inits = [tensor_proto("w", _r(1, 5, 3, 3, 3, scale=0.3)),
             tensor_proto("b", _r(2, 5)),
             tensor_proto("scale", np.abs(_r(3, 5)) + 0.5),
             tensor_proto("bias", _r(4, 5)), tensor_proto("mean", _r(5, 5)),
             tensor_proto("var", np.abs(_r(6, 5)) + 0.5)]
    return model_proto(nodes, inits, ["x", "w", "b", "scale", "bias",
                                      "mean", "var"], ["y"]), \
        [_r(7, 2, 3, 8, 8)]


def _asymmetric_pads():
    """ONNX pads are [x1_begin, x2_begin, x1_end, x2_end]; F.pad takes the
    last dim first."""
    nodes = [node("Conv", ["x", "w"], ["c"],
                  attrs=[attr_ints("pads", [0, 2, 1, 0]),
                         attr_ints("strides", [2, 1])]),
             node("MaxPool", ["c"], ["m"],
                  attrs=[attr_ints("kernel_shape", [3, 2]),
                         attr_ints("pads", [1, 0, 0, 1])]),
             node("AveragePool", ["m"], ["y"],
                  attrs=[attr_ints("kernel_shape", [2, 3]),
                         attr_ints("strides", [1, 2]),
                         attr_ints("pads", [0, 1, 1, 2])])]
    return model_proto(nodes, [tensor_proto("w", _r(1, 4, 3, 3, 2))],
                       ["x", "w"], ["y"]), [_r(2, 2, 3, 9, 7)]


def _auto_pad(kind):
    auto = _len_field(1, b"auto_pad") + _len_field(5, kind.encode()) \
        + _int_field(20, 3)
    nodes = [node("Conv", ["x", "w"], ["y"],
                  attrs=[attr_ints("kernel_shape", [3, 3]),
                         attr_ints("strides", [2, 2]), auto])]
    return model_proto(nodes, [tensor_proto("w", _r(1, 4, 3, 3, 3, scale=.3))],
                       ["x", "w"], ["y"]), [_r(2, 2, 3, 8, 7)]


def _omitted_zero_and_sum():
    axis0 = _len_field(1, b"axis") + _int_field(20, 2)
    nodes = [node("Concat", ["x", "x"], ["c"], attrs=[axis0]),
             node("Sum", ["c", "c", "c"], ["y"])]
    return model_proto(nodes, [], ["x"], ["y"]), \
        [np.arange(6, dtype=np.float32).reshape(2, 3)]


def _flatten():
    return model_proto([node("Flatten", ["x"], ["y"],
                             attrs=[attr_int("axis", 2)])], [], ["x"],
                       ["y"]), [np.arange(24, dtype=np.float32).reshape(
                           2, 3, 2, 2)]


def _avgpool_excludes_pad():
    return model_proto([node("AveragePool", ["x"], ["y"],
                             attrs=[attr_ints("kernel_shape", [2, 2]),
                                    attr_ints("strides", [2, 2]),
                                    attr_ints("pads", [1, 1, 1, 1])])],
                       [], ["x"], ["y"]), [_r(3, 1, 2, 4, 4)]


def _unary_chain():
    nodes = [node("Abs", ["x"], ["a"]), node("Add", ["a", "one"], ["a1"]),
             node("Log", ["a1"], ["l"]), node("Exp", ["l"], ["e"]),
             node("Sqrt", ["e"], ["s"]), node("Neg", ["s"], ["y"])]
    return model_proto(nodes, [tensor_proto("one", _f(1.0))], ["x", "one"],
                       ["y"]), [_r(0, 3, 4)]


def _leaky_elu_clip_pow():
    nodes = [node("LeakyRelu", ["x"], ["lr"],
                  attrs=[attr_float("alpha", 0.2)]),
             node("Elu", ["lr"], ["el"], attrs=[attr_float("alpha", 0.5)]),
             node("Clip", ["el", "lo", "hi"], ["cl"]),
             node("Pow", ["cl", "two"], ["y"])]
    inits = [tensor_proto("lo", _f(-0.4)), tensor_proto("hi", _f(0.9)),
             tensor_proto("two", _f(2.0))]
    return model_proto(nodes, inits, ["x", "lo", "hi", "two"], ["y"]), \
        [_r(1, 2, 5)]


def _clip_attrs():
    return model_proto([node("Clip", ["x"], ["y"],
                             attrs=[attr_float("min", -0.5),
                                    attr_float("max", 0.5)])], [], ["x"],
                       ["y"]), [_r(2, 8)]


def _reduce_pad_where_expand():
    nodes = [node("ReduceMean", ["x"], ["m"],
                  attrs=[attr_ints("axes", [1]), attr_int("keepdims", 1)]),
             node("Expand", ["m", "shape"], ["me"]),
             node("Where", ["cond", "x", "me"], ["w"]),
             node("Pad", ["w", "pads"], ["p"]),
             node("ReduceSum", ["p"], ["y"],
                  attrs=[attr_ints("axes", [0, 1]),
                         attr_int("keepdims", 0)])]
    cond = (np.random.RandomState(3).rand(3, 4) > 0.5).astype(np.int32)
    inits = [tensor_proto("shape", np.asarray([3, 4], np.int64)),
             tensor_proto("cond", cond),
             tensor_proto("pads", np.asarray([1, 0, 0, 2], np.int64))]
    return model_proto(nodes, inits, ["x", "shape", "cond", "pads"],
                       ["y"]), [_r(3, 3, 4)]


def _cast_slice():
    nodes = [node("Cast", ["x"], ["c"], attrs=[attr_int("to", 6)]),
             node("Cast", ["c"], ["f"], attrs=[attr_int("to", 1)]),
             node("Slice", ["f", "starts", "ends", "axes", "steps"], ["s"]),
             node("Slice", ["s"], ["y"],
                  attrs=[attr_ints("starts", [0, 1]),
                         attr_ints("ends", [2, 3]),
                         attr_ints("axes", [0, 1])])]
    inits = [tensor_proto("starts", np.asarray([1, 0], np.int64)),
             tensor_proto("ends", np.asarray([4, 6], np.int64)),
             tensor_proto("axes", np.asarray([0, 1], np.int64)),
             tensor_proto("steps", np.asarray([1, 2], np.int64))]
    return model_proto(nodes, inits, ["x", "starts", "ends", "axes",
                                      "steps"], ["y"]), \
        [(np.arange(24, dtype=np.float32) + 0.7).reshape(4, 6)]


def _pad_float_value():
    inits = [tensor_proto("pads", np.asarray([0, 1, 0, 1], np.int64)),
             tensor_proto("cv", _f(-2.5))]
    return model_proto([node("Pad", ["x", "pads", "cv"], ["y"])], inits,
                       ["x", "pads", "cv"], ["y"]), [_r(5, 2, 3)]


def _reduce_sum_noop():
    return model_proto([node("ReduceSum", ["x"], ["y"],
                             attrs=[attr_int("noop_with_empty_axes", 1)])],
                       [], ["x"], ["y"]), [_r(6, 3, 2)]


def _shape_ops():
    const = _len_field(1, b"value") + _len_field(
        6, tensor_proto("k", _r(9, 6))) + _int_field(20, 4)
    nodes = [node("Transpose", ["x"], ["t"], attrs=[attr_ints("perm",
                                                               [0, 2, 1])]),
             node("Reshape", ["t", "shape"], ["r"]),
             node("Gather", ["r", "idx"], ["g"], attrs=[attr_int("axis", 1)]),
             node("Unsqueeze", ["g"], ["u"], attrs=[attr_ints("axes", [1])]),
             node("Squeeze", ["u"], ["q"], attrs=[attr_ints("axes", [1])]),
             node("Constant", [], ["k"], attrs=[const]),
             node("Mul", ["q", "k"], ["m"]), node("Erf", ["m"], ["e"]),
             node("Sigmoid", ["e"], ["s"]), node("Sub", ["s", "m"], ["d"]),
             node("Tanh", ["d"], ["th"]), node("Div", ["th", "two"], ["y"])]
    inits = [tensor_proto("shape", np.asarray([0, -1], np.int64)),
             tensor_proto("idx", np.asarray([5, 0, -1, 3, 2, 7], np.int64)),
             tensor_proto("two", _f(2.0))]
    return model_proto(nodes, inits, ["x", "shape", "idx", "two"], ["y"]), \
        [_r(8, 3, 4, 2)]


def _matmul_3d():
    return model_proto([node("MatMul", ["x", "w"], ["y"])],
                       [tensor_proto("w", _r(1, 4, 5))], ["x", "w"],
                       ["y"]), [_r(2, 2, 3, 4)]


GRAPHS = {"mlp": _mlp, "gemm_transB": _gemm, "gemm_transA_beta":
          _gemm_trans_a_beta, "conv_bn_pools": _conv_bn,
          "asymmetric_pads": _asymmetric_pads,
          "same_upper": lambda: _auto_pad("SAME_UPPER"),
          "same_lower": lambda: _auto_pad("SAME_LOWER"),
          "omitted_zero_sum": _omitted_zero_and_sum, "flatten": _flatten,
          "avgpool_excludes_pad": _avgpool_excludes_pad,
          "unary_chain": _unary_chain,
          "leaky_elu_clip_pow": _leaky_elu_clip_pow,
          "clip_attrs": _clip_attrs,
          "reduce_pad_where_expand": _reduce_pad_where_expand,
          "cast_slice": _cast_slice, "pad_float_value": _pad_float_value,
          "reduce_sum_noop": _reduce_sum_noop, "shape_ops": _shape_ops,
          "matmul_3d": _matmul_3d}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_matches_jax(jo, name):
    data, xs = GRAPHS[name]()
    want = jo.ONNXNet(data).predict(*xs)
    net = ONNXNet(data, device="cpu")
    got = net.predict(*xs)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jp = jo.ONNXNet(data).params
    assert sorted(net.params) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(net.params[k], np.asarray(jp[k]))


def test_file_entry_points_and_apply_fn(jo, tmp_path):
    data, (x,) = _mlp()
    p = str(tmp_path / "m.onnx")
    with open(p, "wb") as fh:
        fh.write(data)
    want = jo.ONNXNet(p).predict(x)
    np.testing.assert_allclose(Net.load_onnx(p, device="cpu").predict(x),
                               want, rtol=1e-5, atol=1e-5)
    apply_fn, variables = onnx_to_torch(data)
    params = {k: torch.tensor(v) for k, v in variables["params"].items()}
    with torch.no_grad():
        out = apply_fn({"params": params}, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="inputs"):
        apply_fn({"params": params})


def test_unsupported_op_and_bad_bytes_raise_in_both(jo):
    data = model_proto([node("FancyOp", ["x"], ["y"])], [], ["x"], ["y"])
    for net in (ONNXNet(data, device="cpu"), jo.ONNXNet(data)):
        with pytest.raises(NotImplementedError, match="FancyOp"):
            net.predict(np.zeros((1, 2), np.float32))
    for to in (onnx_to_torch, jo.onnx_to_jax):
        with pytest.raises(ValueError, match="ModelProto"):
            to(_int_field(3, 7))
    data = model_proto([node("Conv", ["x", "w"], ["y"],
                             attrs=[attr_int("group", 2)])],
                       [tensor_proto("w", _r(0, 2, 1, 1, 1))], ["x", "w"],
                       ["y"])
    for net in (ONNXNet(data, device="cpu"), jo.ONNXNet(data)):
        with pytest.raises(NotImplementedError, match="grouped"):
            net.predict(_r(1, 1, 2, 3, 3))


def test_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, _ = _mlp()
    with pytest.raises(RuntimeError, match="CUDA"):
        ONNXNet(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        Net.load_onnx(data)
