"""OpenVINO IR importer — run OpenVINO models on the card.

Counterpart of ``analytics_zoo_tpu/net/openvino_net.py`` (ref
``InferenceModel.load_openvino(model_path, weight_path)``,
``pyzoo/zoo/pipeline/inference/inference_model.py:69``). The IR is parsed
directly (the ``.xml`` topology with ``xml.etree``, the ``.bin`` weights
by offset and size; no openvino package) and each layer becomes a torch
call, so IR artifacts serve through ``InferenceModel`` and ``Net``.

JAX's opset subset: Parameter/Const/Result, Convolution/GroupConvolution
(NCHW, explicit pads and auto_pad same_upper/same_lower), MatMul,
Add/Multiply/Subtract/Divide/Power, ReLU/Sigmoid/Tanh/Elu/Clamp/PReLU,
MaxPool/AvgPool (floor and ceil rounding, exclude-pad), ReduceMean,
BatchNormInference, SoftMax, Reshape/Squeeze/Unsqueeze/Transpose/Concat/
Gather (with batch_dims), Sqrt/Exp. An unsupported layer type raises
``NotImplementedError`` naming it (``onnx_net``'s contract). A pool's
output size is JAX's ``_pool`` rule, computed here and realised by
explicit padding, not by torch's ``ceil_mode`` (which drops a window that
starts in the right padding under a different rule and counts padding
otherwise). FakeQuantize/int8 IRs are not supported.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.common.device import (DeviceLike, as_tensor,
                                                   resolve_device, to_numpy)

_DTYPES = {
    "f32": np.float32, "FP32": np.float32,
    "f16": np.float16, "FP16": np.float16,
    "f64": np.float64,
    "i64": np.int64, "I64": np.int64,
    "i32": np.int32, "I32": np.int32,
    "i8": np.int8, "u8": np.uint8,
    "boolean": np.bool_, "BOOL": np.bool_,
}


class _Layer:
    def __init__(self, el):
        self.id = int(el.get("id"))
        self.name = el.get("name", f"layer_{self.id}")
        self.type = el.get("type")
        self.version = el.get("version", "opset1")
        data = el.find("data")
        self.attrs: Dict[str, str] = dict(data.attrib) if data is not None \
            else {}
        self.in_ports: List[int] = [
            int(p.get("id")) for p in el.findall("./input/port")]
        self.out_ports: List[int] = [
            int(p.get("id")) for p in el.findall("./output/port")]

    def ints(self, key: str, default=None) -> Optional[Tuple[int, ...]]:
        v = self.attrs.get(key)
        if v is None or v == "":
            return default
        return tuple(int(x) for x in v.split(","))

    def __repr__(self):
        return f"<{self.type} {self.name!r}>"


def parse_ir(xml_bytes: bytes, bin_bytes: bytes):
    """IR xml+bin → (layers in topo order, edges, const arrays)."""
    root = ET.fromstring(xml_bytes)
    if root.tag != "net":
        raise ValueError("not an OpenVINO IR file (missing <net> root)")
    layers = [_Layer(el) for el in root.findall("./layers/layer")]
    by_id = {l.id: l for l in layers}
    # edge: (to_layer, to_port) <- (from_layer, from_port)
    edges: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for e in root.findall("./edges/edge"):
        edges[(int(e.get("to-layer")), int(e.get("to-port")))] = (
            int(e.get("from-layer")), int(e.get("from-port")))

    consts: Dict[int, np.ndarray] = {}
    for l in layers:
        if l.type != "Const":
            continue
        dt = _DTYPES.get(l.attrs.get("element_type", "f32"))
        if dt is None:
            raise NotImplementedError(
                f"OpenVINO IR element_type "
                f"{l.attrs.get('element_type')!r} not supported")
        off = int(l.attrs["offset"])
        size = int(l.attrs["size"])
        shape = l.ints("shape", ())
        arr = np.frombuffer(bin_bytes[off:off + size], dtype=dt)
        consts[l.id] = arr.reshape(shape if shape else arr.shape).copy()

    # topological order over the edge graph — iterative DFS (deep IRs
    # easily exceed Python's recursion limit: every Const is a layer)
    order: List[_Layer] = []
    seen: set = set()

    def visit(root: int):
        stack: List[Tuple[int, bool]] = [(root, False)]
        while stack:
            lid, expanded = stack.pop()
            if expanded:
                order.append(by_id[lid])
                continue
            if lid in seen:
                continue
            seen.add(lid)
            stack.append((lid, True))
            for port in by_id[lid].in_ports:
                src = edges.get((lid, port))
                if src is not None and src[0] not in seen:
                    stack.append((src[0], False))

    has_results = any(l.type == "Result" for l in layers)
    for l in layers:
        if l.type == "Result":
            visit(l.id)
    # EVERY declared Parameter stays an input (a Parameter unreachable
    # from the Results must not change the model's input arity/binding)
    for l in layers:
        if l.type == "Parameter":
            visit(l.id)
    if not has_results:
        # graphs without Result layers (older IR): visit everything;
        # when Results exist, dangling non-Parameter subgraphs stay OUT
        for l in layers:
            visit(l.id)
    return order, edges, consts


def _auto_pads(l: _Layer, in_spatial, kernel, strides, dilations):
    """pads from explicit pads_begin/pads_end or auto_pad same_upper/
    same_lower (ref IR Convolution/Pooling attributes)."""
    auto = l.attrs.get("auto_pad", "explicit")
    if auto in ("same_upper", "same_lower"):
        pads = []
        for i, k in enumerate(kernel):
            eff = (k - 1) * dilations[i] + 1
            out = -(-in_spatial[i] // strides[i])
            total = max(0, (out - 1) * strides[i] + eff - in_spatial[i])
            lo = total // 2
            hi = total - lo
            pads.append((hi, lo) if auto == "same_lower" else (lo, hi))
        return pads
    begin = l.ints("pads_begin", (0,) * len(kernel))
    end = l.ints("pads_end", (0,) * len(kernel))
    return list(zip(begin, end))


def _spatial_op(x, pads, value, fn):
    """``fn`` on ``x`` padded by ``pads`` [(begin, end)] per spatial dim
    (``F.pad`` lists the last dim first)."""
    flat = [v for be in reversed(pads) for v in be]
    if any(flat):
        x = F.pad(x, flat, value=value)
    return fn(x)


def _conv(x, w, l: _Layer, groups: int):
    spatial = len(x.shape) - 2
    strides = l.ints("strides", (1,) * spatial)
    dilations = l.ints("dilations", (1,) * spatial)
    kernel = w.shape[-spatial:]
    pads = _auto_pads(l, x.shape[2:], kernel, strides, dilations)
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
    if all(b == e for b, e in pads):
        return conv(x, w, None, strides, [b for b, _ in pads], dilations,
                    groups)
    return _spatial_op(x, pads, 0.0, lambda y: conv(
        y, w, None, strides, 0, dilations, groups))


def _window_sum(x, k, s):
    """The sum over each window (no padding): ``avg_pool`` with a divisor
    of 1, one spatial dim lifted to two."""
    if len(k) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1, k[0]), (1, s[0]),
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(k) == 2 else F.avg_pool3d
    return pool(x, tuple(k), tuple(s), divisor_override=1)


def _pool(x, l: _Layer, average: bool):
    spatial = len(x.shape) - 2
    kernel = l.ints("kernel")
    strides = l.ints("strides", (1,) * spatial)
    pads = _auto_pads(l, x.shape[2:], kernel, strides,
                      (1,) * spatial)
    ceil_ext = [0] * spatial
    if l.attrs.get("rounding_type", "floor") == "ceil":
        # ceil output size == floor after extending the end padding so the
        # last (partial) window fits: out = ceil((in+pb+pe-k)/s)+1
        pads = list(pads)
        for i, k in enumerate(kernel):
            pb, pe = pads[i]
            span = x.shape[2 + i] + pb + pe - k
            out_ceil = -(-span // strides[i]) + 1
            # Caffe/torch clamp: a window starting ENTIRELY in the end
            # padding is dropped (else MaxPool grows a -inf column and
            # exclude-pad AvgPool a 0/0 NaN one)
            if (out_ceil - 1) * strides[i] >= x.shape[2 + i] + pb:
                out_ceil -= 1
            extra = max(0, (out_ceil - 1) * strides[i] + k
                        - (x.shape[2 + i] + pb + pe))
            ceil_ext[i] = extra
            pads[i] = (pb, pe + extra)
    if not average:
        pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[spatial]
        return _spatial_op(x, pads, float("-inf"),
                           lambda y: pool(y, kernel, strides))
    out = _spatial_op(x, pads, 0.0,
                      lambda y: _window_sum(y, kernel, strides))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    if l.attrs.get("exclude-pad", "true") in ("true", "True", "1"):
        return out / _spatial_op(ones, pads, 0.0,
                                 lambda y: _window_sum(y, kernel, strides))
    if any(ceil_ext):
        # include-pad divisor counts the window clipped to input +
        # EXPLICIT pads — the ceil extension is not real padding
        expl = [(b, e - c) for (b, e), c in zip(pads, ceil_ext)]
        ones = _spatial_op(ones, expl, 1.0, lambda y: y)
        return out / _spatial_op(
            ones, [(0, c) for c in ceil_ext], 0.0,
            lambda y: _window_sum(y, kernel, strides))
    return out / float(np.prod(kernel))


def _host_ints(v) -> List[int]:
    if isinstance(v, torch.Tensor):
        return [int(i) for i in v.reshape(-1).tolist()]
    return [int(i) for i in np.asarray(v).reshape(-1)]


def _take(data, idx, axis: int):
    """``jnp.take(data, idx, axis)``: negative indices wrap."""
    idx = torch.where(idx < 0, idx + data.shape[axis], idx)
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                       + tuple(data.shape[axis + 1:]))


def _apply_layer(l: _Layer, ins: List[Any]):
    t = l.type
    if t == "Convolution":
        return _conv(ins[0], ins[1], l, groups=1)
    if t == "GroupConvolution":
        # IR weights [G, O/G, I/G, kh, kw] -> OIHW with O=G*(O/G)
        w = ins[1]
        g = w.shape[0]
        w = w.reshape((w.shape[0] * w.shape[1],) + tuple(w.shape[2:]))
        return _conv(ins[0], w, l, groups=g)
    if t == "MatMul":
        a, b = ins
        if l.attrs.get("transpose_a", "false") == "true":
            a = a.transpose(-1, -2)
        if l.attrs.get("transpose_b", "false") == "true":
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    if t == "Add":
        return ins[0] + ins[1]
    if t == "Subtract":
        return ins[0] - ins[1]
    if t == "Multiply":
        return ins[0] * ins[1]
    if t == "Divide":
        return ins[0] / ins[1]
    if t == "Power":
        return ins[0] ** ins[1]
    if t == "Sqrt":
        return torch.sqrt(ins[0])
    if t == "Exp":
        return torch.exp(ins[0])
    if t == "ReLU":
        return torch.relu(ins[0])
    if t == "PReLU":
        slope = ins[1]
        if slope.ndim == 1 and ins[0].ndim > 2:  # per-channel, NCHW
            slope = slope.reshape((1, -1) + (1,) * (ins[0].ndim - 2))
        return torch.where(ins[0] > 0, ins[0], slope * ins[0])
    if t == "Sigmoid":
        return torch.sigmoid(ins[0])
    if t == "Tanh":
        return torch.tanh(ins[0])
    if t == "Elu":
        return F.elu(ins[0], alpha=float(l.attrs.get("alpha", 1.0)))
    if t == "Clamp":
        return torch.clamp(ins[0], float(l.attrs["min"]),
                           float(l.attrs["max"]))
    if t in ("SoftMax", "Softmax"):
        return torch.softmax(ins[0], dim=int(l.attrs.get("axis", 1)))
    if t == "MaxPool":
        return _pool(ins[0], l, average=False)
    if t == "AvgPool":
        return _pool(ins[0], l, average=True)
    if t == "ReduceMean":
        axes = tuple(_host_ints(ins[1]))
        keep = l.attrs.get("keep_dims", "true") in ("true", "True", "1")
        return torch.mean(ins[0], dim=axes, keepdim=keep)
    if t == "BatchNormInference":
        # input order CHANGED across opsets (opset5 release note: data
        # moved first): opset1 = (gamma, beta, data, mean, variance),
        # opset5+ = (data, gamma, beta, mean, variance)
        if l.version in ("opset1", "opset2", "opset3", "opset4"):
            gamma, beta, x, mean, var = ins
        else:
            x, gamma, beta, mean, var = ins
        eps = float(l.attrs.get("eps", l.attrs.get("epsilon", 1e-5)))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean.reshape(shape)) * gamma.reshape(shape) \
            / torch.sqrt(var.reshape(shape) + eps) + beta.reshape(shape)
    if t == "Reshape":
        target = _host_ints(ins[1])
        if l.attrs.get("special_zero", "true") in ("true", "True", "1"):
            target = [ins[0].shape[i] if v == 0 else v
                      for i, v in enumerate(target)]
        return ins[0].reshape(target)
    if t == "Squeeze":
        if len(ins) > 1:
            return torch.squeeze(ins[0], dim=tuple(_host_ints(ins[1])))
        return torch.squeeze(ins[0])
    if t == "Unsqueeze":
        out = ins[0]
        raw = _host_ints(ins[1])
        out_rank = out.ndim + len(raw)
        # negative axes index the OUTPUT rank, not the intermediate one
        for a in sorted(a % out_rank for a in raw):
            out = torch.unsqueeze(out, a)
        return out
    if t == "Transpose":
        return ins[0].permute(*_host_ints(ins[1]))
    if t == "Concat":
        return torch.cat(ins, dim=int(l.attrs.get("axis", 0)))
    if t == "Gather":
        bd = int(l.attrs.get("batch_dims", 0))
        axis = _host_ints(ins[2])[0] if len(ins) > 2 \
            else int(l.attrs.get("axis", 0))
        data = ins[0]
        idx = ins[1].long()
        if bd < 0:
            bd += idx.ndim
        if axis < 0:
            axis += data.ndim
        if bd == 0:
            return _take(data, idx, axis)
        # batch_dims > 0 (IR Gather-7/8): one index table per leading
        # batch entry, as JAX vmaps over them
        lead = tuple(data.shape[:bd])
        d = data.reshape((-1,) + tuple(data.shape[bd:]))
        i = idx.reshape((-1,) + tuple(idx.shape[bd:]))
        out = torch.stack([_take(d[n], i[n], axis - bd)
                           for n in range(d.shape[0])])
        return out.reshape(lead + tuple(out.shape[1:]))
    raise NotImplementedError(
        f"OpenVINO layer type {t!r} ({l.name}) has no translation")


def openvino_to_torch(xml_bytes: bytes, bin_bytes: bytes):
    """IR -> ``(apply_fn, {"params": float consts})`` (JAX's
    ``openvino_to_jax``): ``apply_fn(variables, *inputs)`` runs the graph
    on torch tensors. Integer/bool consts (shape/axis/index operands) stay
    host constants, as in ``onnx_net.onnx_to_torch``."""
    order, edges, consts = parse_ir(xml_bytes, bin_bytes)

    params: Dict[str, Any] = {}
    static: Dict[int, np.ndarray] = {}
    for lid, arr in consts.items():
        if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
            static[lid] = arr
        else:
            params[str(lid)] = arr.astype(np.float32) \
                if arr.dtype == np.float16 else arr

    # declaration (id) order, not traversal order — positional binding
    # must follow the IR's declared input order
    graph_inputs = sorted((l for l in order if l.type == "Parameter"),
                          key=lambda l: l.id)
    param_ids = list(params)

    def apply_fn(variables, *inputs):
        if len(inputs) != len(graph_inputs):
            raise ValueError(
                f"model takes {len(graph_inputs)} inputs "
                f"({[l.name for l in graph_inputs]}), got {len(inputs)}")
        dev = inputs[0].device if inputs else torch.device("cpu")
        env: Dict[Tuple[int, int], Any] = {}
        for l, x in zip(graph_inputs, inputs):
            env[(l.id, l.out_ports[0])] = x
        for lid, arr in static.items():
            env[(lid, 0)] = torch.as_tensor(arr, device=dev)
        for lid in param_ids:
            env[(int(lid), 0)] = variables["params"][lid]
        outs: List[Any] = []
        for l in order:
            if l.type in ("Parameter", "Const"):
                continue
            ins = []
            for port in l.in_ports:
                src = edges.get((l.id, port))
                if src is None:
                    raise ValueError(
                        f"layer {l.name!r} input port {port} unconnected")
                ins.append(env[src])
            if l.type == "Result":
                outs.append(ins[0])
                continue
            out = _apply_layer(l, ins)
            env[(l.id, l.out_ports[0] if l.out_ports else 0)] = out
        return outs[0] if len(outs) == 1 else tuple(outs)

    apply_fn.n_inputs = len(graph_inputs)
    return apply_fn, {"params": params}


def read_ir(model_path: str, weight_path: str):
    with open(model_path, "rb") as f:
        xml_bytes = f.read()
    with open(weight_path, "rb") as f:
        bin_bytes = f.read()
    return openvino_to_torch(xml_bytes, bin_bytes)


class IRModule(torch.nn.Module):
    """An IR's graph as an ``nn.Module`` (what ``InferenceModel`` and
    ``OpenVINONet`` hold): the float consts are its parameters, named by
    layer id, frozen."""

    def __init__(self, model_path: str, weight_path: str):
        super().__init__()
        self.apply_fn, variables = read_ir(model_path, weight_path)
        self.n_inputs = self.apply_fn.n_inputs
        self.consts = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.tensor(v), requires_grad=False)
            for k, v in variables["params"].items()})

    def forward(self, *xs):
        return self.apply_fn({"params": dict(self.consts.items())}, *xs)


class OpenVINONet:
    """Inference over an IR: the float consts live on ``device``
    (``cuda`` unless given), each predict runs the graph there under
    ``inference_mode``."""

    def __init__(self, model_path: str, weight_path: str,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.module = IRModule(model_path, weight_path).to(self.device)
        self.apply_fn = self.module.apply_fn
        self.n_inputs = self.module.n_inputs

    @property
    def params(self):
        return {k: p.detach().cpu().numpy()
                for k, p in self.module.consts.items()}

    def predict(self, *inputs):
        xs = tuple(as_tensor(a, self.device) for a in inputs)
        with torch.inference_mode():
            out = self.module(*xs)
        return to_numpy(out)
