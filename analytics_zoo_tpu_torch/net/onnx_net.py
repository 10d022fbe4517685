"""ONNX import — parse ONNX graphs and run them with torch, no onnx package.

Counterpart of ``analytics_zoo_tpu/net/onnx_net.py`` (ref
``pyzoo/zoo/pipeline/api/net/onnx/onnx_loader.py:141``). Neither machine
has the ``onnx`` package, so the ONNX **protobuf wire format** is read
directly (ModelProto / GraphProto / NodeProto / TensorProto /
AttributeProto, through ``common/protowire.py``) and each node becomes a
torch call: on the card cuBLAS and cuDNN compute MatMul, Gemm and Conv,
as XLA computes them in the JAX package outside any Pallas kernel.

Supported ops (JAX's list): MatMul, Gemm, Add/Sum/Sub/Mul/Div/Pow/Neg/Abs,
Relu/LeakyRelu/Elu/Sigmoid/Tanh/Softmax/Erf, Exp/Log/Sqrt/Clip, Conv,
MaxPool, AveragePool, GlobalAveragePool, BatchNormalization (inference),
Flatten, Reshape, Transpose, Concat, Gather, Squeeze/Unsqueeze,
ReduceMean/ReduceSum, Pad (constant), Cast, Where, Expand, Slice (attr
and input forms), Identity, Constant. An unsupported op raises
``NotImplementedError`` naming it; integer and bool initializers stay
host constants, so shape operands stay concrete. ONNX ``pads`` list every
dim's begin, then every dim's end; ``F.pad`` takes the last dim first.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)

# ------------------------------------------------------------------ protobuf
# wire-level decoding is shared with data/tfrecord.py: common/protowire.py

from analytics_zoo_tpu_torch.common.protowire import (  # noqa: E402
    WIRE_I32, WIRE_VARINT, iter_fields, read_varint,
)

_read_varint = read_varint


def _fields(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Parse one message into {field_number: [(wire_type, value), ...]}."""
    out: Dict[int, List[Tuple[int, Any]]] = {}
    for field, wt, v in iter_fields(buf):
        out.setdefault(field, []).append((wt, v))
    return out


def _ints(entries) -> List[int]:
    """Repeated int64 field: packed (one LEN record) or unpacked."""
    vals: List[int] = []
    for wt, v in entries:
        if wt == WIRE_VARINT:
            vals.append(v)
        else:
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                vals.append(x)
    return vals


def _signed(v: int) -> int:
    # protobuf int64 stores negatives as 2^64 complements
    return v - (1 << 64) if v >= (1 << 63) else v


# -------------------------------------------------------------- onnx schema

_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64}
#: bfloat16 (16) has no numpy dtype without ml_dtypes: a bf16
#: initializer decodes through torch (``_tensor``)
_BF16 = 16


def _tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = _fields(buf)
    dims = _ints(f.get(1, []))
    code = f[2][0][1] if 2 in f else 1
    name = f[8][0][1].decode() if 8 in f else ""
    if code == _BF16:
        if 9 not in f:
            raise NotImplementedError("bfloat16 initializers must be "
                                      "raw_data")
        bits = np.frombuffer(f[9][0][1], np.uint16).astype(np.uint32)
        # widen to float32 (exact), as JAX's params hold them once cast
        arr = (bits << 16).view(np.float32)
        return name, arr.reshape(dims)
    dtype = _DTYPES[code]
    if 9 in f:  # raw_data
        arr = np.frombuffer(f[9][0][1], dtype=dtype)
    elif 4 in f:  # float_data (packed floats arrive as one LEN record)
        chunks = []
        for wt, v in f[4]:
            if wt == WIRE_I32:
                chunks.append(struct.unpack("<f", v)[0])
            else:
                chunks.extend(np.frombuffer(v, np.float32))
        arr = np.asarray(chunks, np.float32)
    elif 7 in f:  # int64_data
        arr = np.asarray([_signed(x) for x in _ints(f[7])], np.int64)
    elif 5 in f:  # int32_data
        arr = np.asarray([_signed(x) for x in _ints(f[5])], np.int32)
    else:
        arr = np.zeros(dims, dtype)
    return name, np.asarray(arr, dtype).reshape(dims)


def _attr(buf: bytes) -> Tuple[str, Any]:
    """One AttributeProto → (name, value). proto3 serializers OMIT
    default-valued scalars (i=0, f=0.0), so the ``type`` field (20) decides
    the kind and absence of the value field means the type's zero value."""
    f = _fields(buf)
    name = f[1][0][1].decode()
    atype = f[20][0][1] if 20 in f else None

    def floats():
        vals = []
        for wt, v in f.get(7, []):
            if wt == WIRE_I32:
                vals.append(struct.unpack("<f", v)[0])
            else:
                vals.extend(np.frombuffer(v, np.float32))
        return [float(x) for x in vals]

    if atype == 1 or (atype is None and 3 in f):     # FLOAT
        return name, (struct.unpack("<f", f[3][0][1])[0]
                      if 3 in f else 0.0)
    if atype == 2 or (atype is None and 4 in f):     # INT
        return name, _signed(f[4][0][1]) if 4 in f else 0
    if atype == 3 or (atype is None and 5 in f):     # STRING
        return name, (f[5][0][1].decode(errors="replace")
                      if 5 in f else "")
    if atype == 4 or (atype is None and 6 in f):     # TENSOR
        return name, _tensor(f[6][0][1])[1] if 6 in f else None
    if atype == 6 or (atype is None and 7 in f):     # FLOATS
        return name, floats()
    if atype == 7 or (atype is None and 8 in f):     # INTS
        return name, [_signed(x) for x in _ints(f.get(8, []))]
    return name, None


class _Node:
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, buf: bytes):
        f = _fields(buf)
        self.inputs = [v.decode() for _, v in f.get(1, [])]
        self.outputs = [v.decode() for _, v in f.get(2, [])]
        self.op = f[4][0][1].decode() if 4 in f else ""
        self.attrs = dict(_attr(v) for _, v in f.get(5, []))


def parse_onnx(data: bytes):
    """ModelProto bytes → (nodes, initializers, input names, output names)."""
    model = _fields(data)
    if 7 not in model:
        raise ValueError("not an ONNX ModelProto (no graph field)")
    g = _fields(model[7][0][1])
    nodes = [_Node(v) for _, v in g.get(1, [])]
    inits = dict(_tensor(v) for _, v in g.get(5, []))

    def names(entries):
        out = []
        for _, v in entries:
            vf = _fields(v)
            out.append(vf[1][0][1].decode() if 1 in vf else "")
        return out

    graph_inputs = [n for n in names(g.get(11, [])) if n not in inits]
    graph_outputs = names(g.get(12, []))
    return nodes, inits, graph_inputs, graph_outputs


# ------------------------------------------------------------ op translation

_TORCH_DTYPES = {1: torch.float32, 6: torch.int32, 7: torch.int64,
                 9: torch.bool, 10: torch.float16, 11: torch.float64,
                 16: torch.bfloat16}


def _host_ints(v) -> List[int]:
    """A shape/axis/index operand as Python ints (a host constant, or a
    tensor computed in the graph)."""
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    return [int(i) for i in np.asarray(v).reshape(-1)]


def _same_pads(in_shape, kernel, strides, dilations, upper: bool):
    """auto_pad SAME_UPPER/SAME_LOWER -> explicit per-dim (lo, hi) pads."""
    pads = []
    for size, k, s, d in zip(in_shape, kernel, strides, dilations):
        eff = (k - 1) * d + 1
        total = max((int(np.ceil(size / s)) - 1) * s + eff - size, 0)
        lo = total // 2 if upper else total - total // 2
        pads.append((lo, total - lo))
    return pads


def _conv_pads(a, in_spatial, kernel, strides, dilations):
    auto = a.get("auto_pad", "") or "NOTSET"
    if isinstance(auto, bytes):
        auto = auto.decode()
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        return _same_pads(in_spatial, kernel, strides, dilations,
                          auto == "SAME_UPPER")
    if auto == "VALID":
        return [(0, 0)] * len(kernel)
    if auto != "NOTSET":
        raise NotImplementedError(f"auto_pad {auto!r} not supported")
    p = a.get("pads") or [0] * (2 * len(kernel))
    half = len(p) // 2
    return [(p[i], p[i + half]) for i in range(half)]


def _pad_spatial(x, pads, value: float):
    """``pads`` [(lo, hi)] per spatial dim; ``F.pad`` lists the last dim
    first."""
    if not any(lo or hi for lo, hi in pads):
        return x
    flat = [v for lo_hi in reversed(pads) for v in lo_hi]
    return F.pad(x, flat, value=value)


def _window_sum(x, k, s):
    """Sum over each window (no padding): ``avg_pool`` with a divisor of
    1, one spatial dim lifted to two."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1, k[0]), (1, s[0]),
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, k, s, divisor_override=1)


def _window_max(x, k, s):
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[len(k)]
    return pool(x, k, s)


def _pool(x, a):
    k = tuple(a["kernel_shape"])
    s = tuple(a.get("strides") or k)
    pads = _conv_pads(a, x.shape[2:], k, s, (1,) * len(k))
    return pads, k, s


def _conv(x, w, b, a):
    if a.get("group", 1) not in (0, 1):
        raise NotImplementedError("grouped Conv not supported")
    kernel = a.get("kernel_shape") or list(w.shape[2:])
    strides = tuple(a.get("strides") or [1] * len(kernel))
    dil = tuple(a.get("dilations") or [1] * len(kernel))
    pads = _conv_pads(a, x.shape[2:], kernel, strides, dil)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[len(kernel)]
    if all(lo == hi for lo, hi in pads):
        return conv(x, w, b, strides, [lo for lo, _ in pads], dil)
    return conv(_pad_spatial(x, pads, 0.0), w, b, strides, 0, dil)


def _apply_node(node: _Node, env: Dict[str, Any], dev: torch.device):
    a = node.attrs
    raw = [env[i] if i else None for i in node.inputs]

    def t(v):
        """A data operand as a tensor on the device (a host constant
        converted)."""
        if v is None or isinstance(v, torch.Tensor):
            return v
        return torch.tensor(np.asarray(v), device=dev)

    x = [t(v) for v in raw]
    op = node.op
    if op == "MatMul":
        return torch.matmul(x[0], x[1])
    if op == "Gemm":
        A = x[0].T if a.get("transA") else x[0]
        B = x[1].T if a.get("transB") else x[1]
        out = a.get("alpha", 1.0) * (A @ B)
        if len(x) > 2 and x[2] is not None:
            out = out + a.get("beta", 1.0) * x[2]
        return out
    if op in ("Add", "Sum"):
        out = x[0]
        for v in x[1:]:          # Sum is variadic in ONNX
            out = out + v
        return out
    if op == "Sub":
        return x[0] - x[1]
    if op == "Mul":
        return x[0] * x[1]
    if op == "Div":
        return x[0] / x[1]
    if op == "Relu":
        return torch.relu(x[0])
    if op == "Sigmoid":
        return torch.sigmoid(x[0])
    if op == "Tanh":
        return torch.tanh(x[0])
    if op == "Erf":
        return torch.erf(x[0])
    if op == "Softmax":
        return torch.softmax(x[0], dim=a.get("axis", -1))
    if op == "Conv":
        return _conv(x[0], x[1], x[2] if len(x) > 2 else None, a)
    if op == "MaxPool":
        pads, k, s = _pool(x[0], a)
        return _window_max(_pad_spatial(x[0], pads, float("-inf")), k, s)
    if op == "AveragePool":
        pads, k, s = _pool(x[0], a)
        summed = _window_sum(_pad_spatial(x[0], pads, 0.0), k, s)
        if a.get("count_include_pad", 0) or not any(
                p != (0, 0) for p in pads):
            return summed / float(np.prod(k))
        # ONNX default count_include_pad=0: divide by the number of VALID
        # cells in each window, not the full kernel size
        ones = torch.ones((1, 1) + tuple(x[0].shape[2:]), dtype=x[0].dtype,
                          device=dev)
        return summed / _window_sum(_pad_spatial(ones, pads, 0.0), k, s)
    if op == "GlobalAveragePool":
        return x[0].mean(dim=tuple(range(2, x[0].ndim)), keepdim=True)
    if op == "BatchNormalization":
        scale, bias, mean, var = x[1], x[2], x[3], x[4]
        shape = (1, -1) + (1,) * (x[0].ndim - 2)
        inv = torch.rsqrt(var.reshape(shape) + a.get("epsilon", 1e-5))
        return (x[0] - mean.reshape(shape)) * inv * scale.reshape(shape) \
            + bias.reshape(shape)
    if op == "Flatten":
        # ONNX Flatten is always 2-D: (prod(d[:axis]), prod(d[axis:]))
        ax = a.get("axis", 1)
        lead = int(np.prod(x[0].shape[:ax])) if ax > 0 else 1
        return x[0].reshape(lead, -1)
    if op == "Reshape":
        shape = _host_ints(raw[1])
        shape = [x[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
        return x[0].reshape(shape)
    if op == "Transpose":
        perm = a.get("perm") or list(range(x[0].ndim))[::-1]
        return x[0].permute(*perm)
    if op == "Concat":
        return torch.cat(x, dim=a.get("axis", 0))
    if op == "Gather":
        axis = a.get("axis", 0) % x[0].ndim
        idx = x[1].long()
        idx = torch.where(idx < 0, idx + x[0].shape[axis], idx)
        out = torch.index_select(x[0], axis, idx.reshape(-1))
        return out.reshape(tuple(x[0].shape[:axis]) + tuple(idx.shape)
                           + tuple(x[0].shape[axis + 1:]))
    if op == "Squeeze":
        axes = a.get("axes") or (_host_ints(raw[1]) if len(raw) > 1
                                 else None)
        return torch.squeeze(x[0], dim=tuple(axes)) if axes else \
            torch.squeeze(x[0])
    if op == "Unsqueeze":
        axes = a.get("axes") or _host_ints(raw[1])
        out = x[0]
        for ax in sorted(axes):
            out = torch.unsqueeze(out, ax)
        return out
    if op == "Identity":
        return x[0]
    if op == "Constant":
        return t(a["value"])
    if op == "LeakyRelu":
        alpha = a.get("alpha", 0.01)
        return torch.where(x[0] >= 0, x[0], alpha * x[0])
    if op == "Elu":
        alpha = a.get("alpha", 1.0)
        return torch.where(x[0] >= 0, x[0], alpha * (torch.exp(x[0]) - 1.0))
    if op == "Clip":
        # opset<11: attrs; opset>=11: optional min/max inputs
        lo = x[1] if len(x) > 1 and x[1] is not None else a.get("min")
        hi = x[2] if len(x) > 2 and x[2] is not None else a.get("max")
        if lo is None and hi is None:
            return x[0]
        return torch.clamp(x[0], lo, hi)
    if op == "Exp":
        return torch.exp(x[0])
    if op == "Log":
        return torch.log(x[0])
    if op == "Sqrt":
        return torch.sqrt(x[0])
    if op == "Pow":
        return x[0] ** x[1]
    if op == "Neg":
        return -x[0]
    if op == "Abs":
        return torch.abs(x[0])
    if op in ("ReduceMean", "ReduceSum"):
        axes = a.get("axes") or (_host_ints(raw[1])
                                 if len(raw) > 1 and raw[1] is not None
                                 else None)
        if op == "ReduceSum" and not axes and \
                a.get("noop_with_empty_axes"):
            return x[0]                 # opset-13: empty axes = identity
        keep = bool(a.get("keepdims", 1))
        dims = tuple(axes) if axes else tuple(range(x[0].ndim))
        return (x[0].mean if op == "ReduceMean" else x[0].sum)(
            dim=dims, keepdim=keep)
    if op == "Pad":
        mode = a.get("mode", b"constant")
        mode = mode.decode() if isinstance(mode, bytes) else mode
        if mode != "constant":
            raise NotImplementedError(f"Pad mode {mode!r} not supported")
        pads = a.get("pads") or _host_ints(raw[1])
        value = (x[2] if len(x) > 2 and x[2] is not None
                 else a.get("value", 0.0))
        n = x[0].ndim
        flat = []
        for i in reversed(range(n)):     # F.pad: the last dim first
            flat += [int(pads[i]), int(pads[i + n])]
        return F.pad(x[0], flat, value=float(value))
    if op == "Cast":
        to = int(a["to"])
        if to not in _TORCH_DTYPES:
            raise NotImplementedError(f"Cast to dtype code {to} "
                                      "not supported")
        return x[0].to(_TORCH_DTYPES[to])
    if op == "Where":
        return torch.where(x[0].bool(), x[1], x[2])
    if op == "Expand":
        shape = _host_ints(raw[1])
        return torch.broadcast_to(x[0], np.broadcast_shapes(
            tuple(x[0].shape), tuple(shape)))
    if op == "Slice":
        # opset>=10: starts/ends[/axes/steps] inputs; opset<10: attrs
        if len(raw) == 1:
            starts, ends = list(a["starts"]), list(a["ends"])
            axes = list(a.get("axes") or range(len(starts)))
            steps = [1] * len(starts)
        else:
            starts, ends = _host_ints(raw[1]), _host_ints(raw[2])
            axes = (_host_ints(raw[3]) if len(raw) > 3 and raw[3] is not None
                    else list(range(len(starts))))
            steps = (_host_ints(raw[4]) if len(raw) > 4
                     and raw[4] is not None else [1] * len(starts))
        idx = [slice(None)] * x[0].ndim
        for ax, st, en, sp in zip(axes, starts, ends, steps):
            idx[ax] = slice(st, en, sp)
        return x[0][tuple(idx)]
    raise NotImplementedError(f"ONNX op {op!r} has no translation")


def onnx_to_torch(data: bytes):
    """ONNX ModelProto bytes -> ``(apply_fn, {"params": initializers})``
    (JAX's ``onnx_to_jax``): ``apply_fn(variables, *inputs)`` runs the
    graph on torch tensors, ``variables["params"]`` the float
    initializers as tensors on the inputs' device."""
    nodes, inits, graph_inputs, graph_outputs = parse_onnx(data)
    # integer/bool initializers are shape/index operands (Reshape, Slice,
    # Pad, Expand, Gather indices…): they stay host constants so the op
    # consuming them sees concrete values; float initializers are the
    # parameters
    params: Dict[str, Any] = {}
    static: Dict[str, Any] = {}
    for k, v in inits.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
            static[k] = arr
        else:
            params[k] = arr

    def apply_fn(variables, *inputs):
        if len(inputs) != len(graph_inputs):
            raise ValueError(f"model takes {len(graph_inputs)} inputs "
                             f"({graph_inputs}), got {len(inputs)}")
        dev = inputs[0].device if inputs else torch.device("cpu")
        env: Dict[str, Any] = dict(static)
        env.update(variables["params"])
        env.update(dict(zip(graph_inputs, inputs)))
        for node in nodes:
            result = _apply_node(node, env, dev)
            outs = result if isinstance(result, tuple) else (result,)
            for name, val in zip(node.outputs, outs):
                env[name] = val
        outs = [env[o] for o in graph_outputs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    return apply_fn, {"params": params}


class ONNXNet:
    """Inference over an ONNX graph (mirrors TorchNet): the float
    initializers live on ``device`` (``cuda`` unless given), each
    predict runs the graph there under ``inference_mode``."""

    def __init__(self, path_or_bytes, device: DeviceLike = None):
        self.device = resolve_device(device)
        data = path_or_bytes
        if isinstance(data, str):
            with open(data, "rb") as fh:
                data = fh.read()
        self.apply_fn, self.variables = onnx_to_torch(data)
        self._on_device = {k: torch.tensor(v, device=self.device)
                           for k, v in self.variables["params"].items()}

    @property
    def params(self):
        return self.variables["params"]

    def predict(self, *inputs):
        xs = tuple(as_tensor(a, self.device) for a in inputs)
        with torch.inference_mode():
            out = self.apply_fn({"params": self._on_device}, *xs)
        return to_numpy(out)

    __call__ = predict
