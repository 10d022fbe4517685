"""Post-training int8 quantization for inference, and int8 storage of
the decode KV page pool.

Counterpart of ``analytics_zoo_tpu/inference/quantize.py``:

- **Weight int8** (``quantize_tree``, ``quantize_module``): each float
  leaf with ndim >= 2 and at least ``min_elems`` elements becomes int8
  under symmetric per-last-axis float32 scales (zero-amax channels take
  scale 1.0), computed in numpy by the JAX package's own expressions, so
  q and scale are its bits. "Last axis" is the flax layout's
  (``convert.ParamLayout``): an ``nn.Linear`` weight ``[out, in]`` is the
  transpose of a flax kernel, the attention projections are ``[in, h, d]``
  in flax (one scale per ``d``, shared across heads) and its output
  ``[h, d, out]``, an embedding table ``[rows, dim]`` gets one scale per
  column. ``quantize_module`` computes on the flax leaves and maps q and
  the scales back: the module keeps int8 buffers (``<leaf>_q``,
  ``<leaf>_scale``) resident and dequantizes ``q * scale`` on every read
  of the leaf, inside each forward, before the consuming op (as JAX's
  ``dequantize_tree`` runs inside the jitted apply; a cached float copy
  would undo the 4x size reduction).
- **Calibrated int8** (``calibrate_activations``, ``int8_modules``):
  forward pre-hooks record max|x| into each module whose flax counterpart
  is ``nn.Dense`` or ``nn.Conv`` (keras ``Dense``, ``flax_compat.Dense``
  without an attention projection's flax shape, ``flax_compat.Conv``),
  keyed by its flax path; those modules then run JAX's int8 interceptor:
  ``x`` quantized per tensor (``round(x.float() / s_in)``, half to even,
  clipped to ±127), an ``int8 x int8 -> int32`` product (``int_mm``; on
  the card ``torch._int_mm``, zero-padded to its shape rules), rescaled
  by ``s_in * s_w``, plus the bias, in x's dtype. The integer product is
  exact, so a layer gives JAX's bits for the same input and amax. A 1-D,
  2-D or 3-D convolution (``_conv_int8_plan``'s ranks; every padding form
  ``flax_compat.Conv`` takes) is the same product over its input's
  windows: the int8 input zero-padded (exact: q(0) = 0) and unfolded into
  ``[b * positions, prod(k) * in]`` rows (a 1x1 kernel is a reshape),
  against the kernel flattened as ``convert`` holds it. A grouped
  convolution (JAX passes ``feature_group_count`` to its int8
  convolution) sums each output over its group's ``prod(k) * in /
  groups`` taps: where ``127 * 127`` times that count stays below 2^24
  (a depthwise 3x3: 9 taps) the int8 values run as a float32 grouped
  convolution, whose every partial sum is an integer float32 holds
  exactly, so any order of summation, TF32's inputs included, gives the
  int32 result; a wider group runs one ``int_mm`` a group. The
  attention projections (JAX's ``DenseGeneral``) stay float, as there.
- **Paged KV int8** (``ZOO_KV_DTYPE=int8``, its lines 290-342), in numpy
  on the host as there: one float32 symmetric scale per page sits beside
  the pool; the paged kernels (ops/paged_attention.py) dequantize with
  the same ``q.float() * scale`` expression the host read path uses, so
  both see identical bits. Storage drops 4x per page against float32.

- **Calibrated int8 of the recurrent cells**: a flax cell is a tree of
  Denses (GRU's ``ir``/``iz``/``in``, ``hr``/``hz``/``hn``; LSTM's
  ``ii``..``io``, ``hi``..``ho``; SimpleCell's ``i``, ``h``), and JAX's
  interceptor gives each Dense its own per-tensor activation scale and
  per-output-channel weight scales. The port's cells run one product a
  side over the concatenated Denses; the Denses of a side all read the
  same input (``x_t`` or the hidden state), so each has the same
  calibrated amax (recorded per Dense path, every step of every batch),
  and the side's integer product with the per-row scales of the
  concatenated kernel is each Dense's, row for row (``Int8Side``). q and
  the scales are JAX's bits. (JAX's own calibration cannot reach these
  Denses: its observer reads ``float(max|x|)`` inside ``nn.RNN``'s scan,
  which raises for GRU and SimpleRNN models, and flax's
  ``OptimizedLSTMCell`` holds ``DenseParams``, not ``nn.Dense``: ROADMAP
  C21. The tests hold the port to JAX's interceptor run step by step
  over the cells.)
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

KV_DTYPES = ("float32", "int8")


def resolve_kv_dtype(kv_dtype=None) -> np.dtype:
    """Storage dtype for the decode KV page pool: the explicit argument
    when given, else the ``ZOO_KV_DTYPE`` env knob (``float32`` default;
    ``int8`` stores pages quantized under per-page symmetric scales)."""
    if kv_dtype is None:
        kv_dtype = os.environ.get("ZOO_KV_DTYPE", "").strip().lower() \
            or "float32"
    if isinstance(kv_dtype, str):
        kv_dtype = {"fp32": "float32", "f32": "float32"}.get(
            kv_dtype, kv_dtype)
    dt = np.dtype(kv_dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.int8)):
        raise ValueError(
            f"ZOO_KV_DTYPE must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return dt


def page_scale(amax: float) -> np.float32:
    """Symmetric per-page scale for a page whose running max |x| is
    ``amax`` (zero-amax pages get scale 1.0 so all-zero pages stay exact)."""
    return np.float32(amax / 127.0) if amax > 0.0 else np.float32(1.0)


def quantize_rows(rows, scale) -> np.ndarray:
    """Float rows → int8 under one shared (per-page) scale."""
    return np.clip(np.round(np.asarray(rows, np.float32)
                            / np.float32(scale)),
                   -127, 127).astype(np.int8)


def dequantize_rows(q, scale) -> np.ndarray:
    """int8 rows → float32 as ``q * scale`` — the expression the paged
    kernels fuse, so the host read path and the kernels agree bitwise."""
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def requantize_rows(q, old_scale, new_scale) -> np.ndarray:
    """Rescale already-quantized rows after a later append raised the
    page's amax (so its scale grew). The round trip costs at most half a
    step of the final scale."""
    return quantize_rows(dequantize_rows(q, old_scale), new_scale)


# ---------------------------------------------------------------------------
# Weight int8
# ---------------------------------------------------------------------------

class QuantizedLeaf(NamedTuple):
    """int8 values and per-last-axis float32 scales (broadcastable to the
    leaf's shape)."""

    q: Any          # int8, the leaf's shape
    scale: Any      # float32, keepdims over every axis but the last


def _quantize_array(w: np.ndarray) -> QuantizedLeaf:
    w = np.asarray(w)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return QuantizedLeaf(q, scale)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def quantize_tree(params, min_elems: int = 1024):
    """Quantize the float leaves with ndim >= 2 and >= ``min_elems``
    elements (kernels and tables, where the bytes are); smaller leaves
    (biases, norms) stay float. Idempotent: a ``QuantizedLeaf`` stays as
    it is. Leaves come back as numpy arrays."""
    if isinstance(params, QuantizedLeaf):
        return QuantizedLeaf(np.asarray(params.q), np.asarray(params.scale))
    if isinstance(params, dict):
        return {k: quantize_tree(v, min_elems) for k, v in params.items()}
    a = _host(params)
    if a.ndim >= 2 and a.size >= min_elems and \
            np.issubdtype(a.dtype, np.floating):
        return _quantize_array(a)
    return a


def dequantize_tree(qparams):
    """The inverse of ``quantize_tree``: ``q.astype(float32) * scale``."""
    if isinstance(qparams, QuantizedLeaf):
        return np.asarray(qparams.q).astype(np.float32) * qparams.scale
    if isinstance(qparams, dict):
        return {k: dequantize_tree(v) for k, v in qparams.items()}
    return qparams


def _leaves(tree) -> list:
    if isinstance(tree, QuantizedLeaf):
        return [tree.q, tree.scale]
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    return [tree]


def tree_nbytes(params) -> int:
    """Bytes of every leaf of a (quantized) parameter tree."""
    return int(sum(_host(a).nbytes for a in _leaves(params)))


def resident_bytes(module: torch.nn.Module) -> int:
    """Bytes the module holds in parameters and buffers, each storage
    once."""
    seen, total = set(), 0
    for t in list(module.parameters()) + list(module.buffers()):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


class _Dequantized:
    """Mixin of a module whose quantized leaves live as ``<leaf>_q`` /
    ``<leaf>_scale`` buffers: reading the leaf dequantizes it."""

    def __getattr__(self, name):
        if name in self.__dict__.get("_zoo_q_leaves", ()):
            bufs = self.__dict__["_buffers"]
            # int8 * float32 promotes to float32: float(q) * scale, one op
            return bufs[name + "_q"] * bufs[name + "_scale"]
        return super().__getattr__(name)


_CLASSES: Dict[Tuple[type, type], type] = {}


def _swap_class(mod: torch.nn.Module, mixin: type) -> None:
    cls = type(mod)
    if issubclass(cls, mixin):
        return
    key = (cls, mixin)
    if key not in _CLASSES:
        _CLASSES[key] = type(f"{mixin.__name__.strip('_')}{cls.__name__}",
                             (mixin, cls), {})
    mod.__class__ = _CLASSES[key]


def _minimal_scale(s: torch.Tensor) -> torch.Tensor:
    """``s`` narrowed to length 1 along every axis it is constant on: the
    product with q is unchanged, bit for bit."""
    for d in range(s.dim()):
        first = s.narrow(d, 0, 1)
        if s.shape[d] > 1 and bool((s == first).all()):
            s = first
    return s.contiguous()


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield list(path + (k,)), v


def _set_path(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def quantize_module(module: torch.nn.Module, min_elems: int = 1024):
    """Weight-quantize ``module`` in place by JAX's rule on its flax
    layout; returns the quantized parameter tree (``QuantizedLeaf`` where
    a leaf was quantized, numpy elsewhere), what ``tree_nbytes`` measures
    and what compares with the JAX package's ``quantize_tree``. A second
    call keeps the leaves already quantized and quantizes what now
    qualifies."""
    from analytics_zoo_tpu_torch.convert import ParamLayout
    state = module.__dict__.get("_zoo_quant")
    if state is None:
        layout = ParamLayout(module)
        prior: Dict[str, QuantizedLeaf] = {}
    else:
        layout, prior = state["layout"], state["leaves"]
    # every parameter as a float tensor (quantized ones dequantized, then
    # replaced by their stored leaves before quantize_tree sees them)
    floats = {}
    for name in layout.names:
        mod_name, _, attr = name.rpartition(".")
        floats[name] = getattr(module.get_submodule(mod_name), attr)
    tree = layout.to_tree(floats)
    for path, _ in list(_walk(tree)):
        name = layout.torch_name(path)
        if name in prior:
            _set_path(tree, path, prior[name])
    qtree = quantize_tree(tree, min_elems)
    fresh = {layout.torch_name(p): leaf
             for p, leaf in _walk(qtree) if isinstance(leaf, QuantizedLeaf)
             and layout.torch_name(p) not in prior}
    if fresh:
        # back to the torch layout through the layout's own map: q as
        # exact floats, the scales broadcast to the leaf, then narrowed
        qf = layout.from_tree(_map_tree(qtree, lambda v: (
            v.q.astype(np.float32) if isinstance(v, QuantizedLeaf)
            else v)))
        sf = layout.from_tree(_map_tree(qtree, lambda v: (
            np.broadcast_to(v.scale, v.q.shape)
            if isinstance(v, QuantizedLeaf) else v)))
        for name, leaf in fresh.items():
            mod_name, _, attr = name.rpartition(".")
            mod = module.get_submodule(mod_name)
            dev = mod._parameters[attr].device
            del mod._parameters[attr]
            mod.register_buffer(attr + "_q",
                                qf[name].to(torch.int8).to(dev))
            mod.register_buffer(attr + "_scale",
                                _minimal_scale(sf[name]).to(dev))
            mod.__dict__["_zoo_q_leaves"] = frozenset(
                mod.__dict__.get("_zoo_q_leaves", ())) | {attr}
            _swap_class(mod, _Dequantized)
            prior[name] = leaf
    module.__dict__["_zoo_quant"] = {"layout": layout, "leaves": prior}
    return qtree


# ---------------------------------------------------------------------------
# Calibrated int8: activations per tensor, products in integers
# ---------------------------------------------------------------------------

def _int8_kind(mod: torch.nn.Module) -> Optional[str]:
    """"dense" / "conv" for a module whose flax counterpart JAX
    intercepts (``nn.Dense``, ``nn.Conv``), else None. A
    ``flax_compat.Dense`` with a flax kernel shape of its own is an
    attention projection (``DenseGeneral``) and stays float."""
    from analytics_zoo_tpu_torch.common import flax_compat
    if isinstance(mod, flax_compat.Conv):
        return "conv"
    if isinstance(mod, flax_compat.Dense) and \
            "flax_kernel_shape" not in mod.__dict__:
        return "dense"
    return None


def _cells(module: torch.nn.Module):
    """``(flax path, cell)`` of every recurrent cell in ``module``."""
    from analytics_zoo_tpu_torch.keras.layers import _RNNCell
    return [(name.replace(".", "/"), mod)
            for name, mod in module.named_modules()
            if isinstance(mod, _RNNCell)]


def _cell_observer(amax: Dict[str, float], path: str, cell):
    """Record a step's input and hidden state as each Dense of that side
    sees it (``<cell>/<dense>``, max|x| per tensor)."""
    sides = ((cell.INPUT, 0), (cell.RECURRENT, 1))

    def observe(x, h):
        for gates, i in sides:
            m = float((x, h)[i].abs().max())
            for name, _ in gates:
                key = f"{path}/{name}"
                amax[key] = max(amax.get(key, 0.0), m)
    return observe


def calibrate_activations(module: torch.nn.Module, forward, batches
                          ) -> Dict[str, float]:
    """Run ``forward(batch)`` over the calibration batches with forward
    pre-hooks recording each int8-capable module's max|x| (per tensor),
    keyed by its flax path (``a/b/c``). Raises JAX's error when no module
    qualifies (a model of bare ``torch.nn.Linear`` layers, as JAX refuses
    torch-translated graphs). A recurrent cell records each of its
    Denses' input at every step (``_cell_observer``)."""
    amax: Dict[str, float] = {}

    def hook_for(path):
        def hook(mod, args):
            if args and isinstance(args[0], torch.Tensor):
                amax[path] = max(amax.get(path, 0.0),
                                 float(args[0].abs().max()))
        return hook

    handles = [mod.register_forward_pre_hook(hook_for(name.replace(".", "/")))
               for name, mod in module.named_modules()
               if name and _int8_kind(mod) is not None]
    cells = _cells(module)
    for path, cell in cells:
        cell.__dict__["_zoo_observe"] = _cell_observer(amax, path, cell)
    try:
        for b in batches:
            forward(b)
    finally:
        for h in handles:
            h.remove()
        for _, cell in cells:
            cell.__dict__.pop("_zoo_observe", None)
    if not amax:
        raise ValueError(
            "calibration saw no flax nn.Dense/nn.Conv layers — activation "
            "int8 covers flax/zoo-keras models (torch-translated graphs "
            "run weight-only quantization instead)")
    return amax


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: ``torch._int_mm``'s shape rules on CUDA: more than 16 rows, inner and
#: output widths multiples of 8 (dev/int_mm_probe.py: torch 2.11 on the
#: H100 refuses 16 rows, and a row-major ``b`` at some shapes with
#: CUBLAS_STATUS_NOT_SUPPORTED, so ``b`` goes column-major)
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [m, k] int8 @ b [k, n] int8 -> int32 [m, n]``, exactly. The
    operands are zero-padded to ``torch._int_mm``'s shape rules (rows to
    a multiple of 8 above 16, k and n to multiples of 8), ``b`` laid out
    column-major (the transpose of a contiguous ``[n, k]``, as a weight
    ``w.t()`` is), and the result sliced; zero padding adds nothing to an
    integer sum. There is no float fallback: a product the rules still
    refuse raises."""
    m, k = a.shape
    n = b.shape[1]
    mp = max(ceil_to(m, INT_MM_MULTIPLE),
             ceil_to(INT_MM_MIN_ROWS, INT_MM_MULTIPLE))
    kp, np_ = ceil_to(k, INT_MM_MULTIPLE), ceil_to(n, INT_MM_MULTIPLE)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()
    if (kp, np_) != (k, n):
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, np_ - n))
    elif not bt.is_contiguous():
        bt = bt.contiguous()
    return torch._int_mm(a, bt.t())[:m, :n]


def _act_scale(amax: float) -> torch.Tensor:
    # a Python float, then float32 (JAX: jnp.float32(max(a, 1e-8) / 127.0))
    return torch.tensor(np.float32(max(float(amax), 1e-8) / 127.0))


def quantize_activation(x: torch.Tensor, s_in: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s_in), -127, 127)`` as int8, in float32 (a bf16
    ``x`` meets JAX's float32 ``s_in`` promoted, so it is cast first).
    ``s_in`` lies on x's device: CUDA divides by a CPU scalar as a
    product with its reciprocal, which is not the quotient's bits."""
    return torch.clamp(torch.round(x.float() / s_in), -127, 127).to(
        torch.int8)


def _weight_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's in-trace kernel quantization for a layer whose kernel was
    not stored quantized: per output channel, ``[out, in]`` int8 and
    ``(out,)`` scales."""
    w = weight.detach().float()
    w_amax = w.abs().amax(dim=1)
    s_w = torch.where(w_amax == 0, torch.ones_like(w_amax), w_amax / 127.0)
    wq = torch.clamp(torch.round(w / s_w[:, None]), -127, 127)
    return wq.to(torch.int8), s_w


def im2col(xq: torch.Tensor, kernel, strides, dilation) -> torch.Tensor:
    """``xq [b, *spatial, c]`` (padded already) as the rows of an
    implicit GEMM: ``[b * prod(out), prod(k) * c]``, each row one output
    position's window in the flattened kernel's ``(*k, c)`` order. A 1x1
    kernel is a strided view, reshaped; otherwise each spatial dim is
    unfolded (every ``dilation``-th tap of the dilated span) and the taps
    moved in front of the channels."""
    nd = len(kernel)
    c = xq.shape[-1]
    if all(k == 1 for k in kernel):
        idx = (slice(None),) + tuple(slice(None, None, s) for s in strides)
        return xq[idx].reshape(-1, c)
    win = xq
    for i, (k, s, d) in enumerate(zip(kernel, strides, dilation)):
        win = win.unfold(1 + i, (k - 1) * d + 1, s)
        if d > 1:
            win = win[..., ::d]
    # [b, *out, c, *k] -> [b, *out, *k, c]
    order = tuple(range(nd + 1)) + tuple(range(nd + 2, 2 * nd + 2)) + \
        (nd + 1,)
    return win.permute(order).reshape(-1, math.prod(kernel) * c)


#: the largest sum of int8 products float32 holds exactly: every integer
#: of magnitude up to 2^24
EXACT_FLOAT_SUM = 2 ** 24


def grouped_int8_conv(conv, xq: torch.Tensor, wq: torch.Tensor
                      ) -> torch.Tensor:
    """The integer sums of a grouped convolution ``conv`` (a
    ``flax_compat.Conv`` with ``groups > 1``) over the padded int8 input
    ``xq [b, *spatial, in]`` and kernel ``wq [out, prod(k) * in /
    groups]``, as exact float32 ``[b * positions, out]`` rows (module
    docstring: one float32 grouped convolution where its sums stay exact,
    else one ``int_mm`` a group)."""
    from analytics_zoo_tpu_torch.common import flax_compat as fc
    k, g = conv.kernel_size, conv.groups
    taps = math.prod(k) * conv.group_features
    if 127 * 127 * taps < EXACT_FLOAT_SUM:
        y = fc._CONV[len(k)](
            fc.channels_first(xq.float()),
            wq.float().view(conv.out_features, *k, conv.group_features)
            .permute(0, len(k) + 1, *range(1, len(k) + 1)),
            stride=conv.strides, dilation=conv.dilation, groups=g)
        return fc.channels_last(y).reshape(-1, conv.out_features)
    a = im2col(xq, k, conv.strides, conv.dilation)
    a = a.view(a.shape[0], math.prod(k), g, conv.group_features)
    og = conv.out_features // g
    return torch.cat([
        int_mm(a[:, :, i].reshape(a.shape[0], taps),
               wq[i * og:(i + 1) * og].t()).float()
        for i in range(g)], dim=-1)


class _Int8:
    """Mixin of a calibrated Dense or Conv: runs JAX's int8 interceptor
    (the module docstring) in place of its float forward. A convolution
    quantizes its input, zero-pads it in int8 (exact: q(0) = 0, as XLA
    pads the int8 operand), and runs the same ``int_mm`` over the input's
    windows (:func:`im2col`); a grouped one :func:`grouped_int8_conv`."""

    def forward(self, x):
        bufs = self._buffers
        s_in, wq = bufs["_zoo_s_in"], bufs["_zoo_wq"]   # wq [out, k] int8
        s = s_in * bufs["_zoo_ws"]
        lead = x.shape[:-1]
        if self.__dict__["_zoo_kind"] == "conv":
            from analytics_zoo_tpu_torch.common.flax_compat import pad_last
            pads = self.pads(x.shape[1:-1])
            xq = pad_last(quantize_activation(x, s_in), pads)
            lead = (x.shape[0],) + tuple(
                (n - (k - 1) * d - 1) // st + 1 for n, k, d, st in zip(
                    xq.shape[1:-1], self.kernel_size, self.dilation,
                    self.strides))
            if self.groups > 1:
                y = grouped_int8_conv(self, xq, wq) * s
            else:
                a = im2col(xq, self.kernel_size, self.strides,
                           self.dilation)
                y = int_mm(a, wq.t()).float() * s
        else:
            a = quantize_activation(x, s_in).reshape(-1, x.shape[-1])
            y = int_mm(a, wq.t()).float() * s
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(*lead, y.shape[-1]).to(x.dtype)


class Int8Side:
    """A calibrated cell side's product: the Denses of the side
    concatenated, ``x`` quantized by their shared ``s_in``, one ``int8 x
    int8 -> int32`` product, each row rescaled by ``s_in * s_w`` of its
    Dense's output channel, plus the bias (a Dense without one adds
    zeros: ``y + 0`` is ``y``); in x's dtype, as JAX's interceptor."""

    def __init__(self, wq: torch.Tensor, ws: torch.Tensor,
                 s_in: torch.Tensor):
        self.wq, self.ws, self.s_in = wq, ws, s_in
        self.s = s_in * ws

    def __call__(self, x, b):
        a = quantize_activation(x, self.s_in).reshape(-1, x.shape[-1])
        y = int_mm(a, self.wq.t()).float() * self.s
        if b is not None:
            y = y + b
        return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


def _dense_int8(mod: torch.nn.Module) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 kernel ``[out, in]`` and per-output scales of a Dense (or
    a cell's Linear): the stored ones where its weight was quantized,
    else JAX's in-trace rule."""
    if "weight" in mod.__dict__.get("_zoo_q_leaves", ()):
        return (mod._buffers["weight_q"],
                mod._buffers["weight_scale"].reshape(-1))
    return _weight_int8(mod.weight)


class _Int8Cell:
    """Mixin of a calibrated recurrent cell: ``weights()`` gives each
    side's ``Int8Side`` and its concatenated float bias."""

    def weights(self):
        return tuple((self.__dict__["_zoo_sides"][i], self._side(gates)[1])
                     for i, gates in enumerate((self.INPUT,
                                                self.RECURRENT)))


def _int8_cell(path: str, cell, act_amax: Dict[str, float]) -> List[str]:
    sides = []
    names = []
    for gates in (cell.INPUT, cell.RECURRENT):
        mods = [cell._modules[n] for n, _ in gates]
        qs = [_dense_int8(m) for m in mods]
        wq = torch.cat([q for q, _ in qs])
        ws = torch.cat([w for _, w in qs]).float().contiguous()
        # the Denses of a side read one input: one amax, one s_in
        s_in = _act_scale(act_amax[f"{path}/{gates[0][0]}"]).to(wq.device)
        sides.append(Int8Side(wq, ws, s_in))
        names += [f"{path}/{n}" for n, _ in gates]
    cell.__dict__["_zoo_sides"] = tuple(sides)
    _swap_class(cell, _Int8Cell)
    return names


def int8_modules(module: torch.nn.Module, act_amax: Dict[str, float]
                 ) -> List[str]:
    """Switch each calibrated module (its flax path in ``act_amax``) to
    the int8 forward, with the stored int8 kernel where the weight was
    quantized, else the kernel quantized once by JAX's in-trace rule; a
    calibrated recurrent cell runs its sides' ``Int8Side`` products.
    Returns the switched flax paths (a cell's by Dense)."""
    done = []
    for path, cell in _cells(module):
        if f"{path}/{cell.INPUT[0][0]}" in act_amax:
            done += _int8_cell(path, cell, act_amax)
    for name, mod in module.named_modules():
        path = name.replace(".", "/")
        kind = _int8_kind(mod)
        if kind is None or path not in act_amax:
            continue
        wq, ws = _dense_int8(mod)
        mod.register_buffer("_zoo_wq", wq)
        mod.register_buffer("_zoo_ws", ws.float().contiguous())
        mod.register_buffer("_zoo_s_in",
                            _act_scale(act_amax[path]).to(wq.device))
        mod.__dict__["_zoo_kind"] = kind
        _swap_class(mod, _Int8)
        done.append(path)
    return done
