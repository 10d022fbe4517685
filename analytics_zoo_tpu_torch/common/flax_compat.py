"""PyTorch counterparts of the flax.linen layers the JAX models build on.

- ``Dense`` — ``nn.Dense`` and ``nn.DenseGeneral``: ``weight [out, in]``
  (the flax kernel flattened to ``[in, out]`` and transposed) and
  ``bias [out]``. With ``dtype`` set, input and parameters are cast to it;
  with None they promote as ``flax.linen.dtypes.promote_dtype`` does (a
  bf16 input meets fp32 parameters in fp32).
- ``LayerNorm`` — ``nn.LayerNorm``: ``weight`` (flax ``scale``) and
  ``bias``; statistics and normalisation in fp32, the output rounded to
  ``dtype`` (or to the promoted input/parameter dtype).
- ``Embed`` — ``nn.Embed``: one ``embedding [num, features]`` table read
  with ``jnp.take``'s rule (ops/embedding_bag.py), so an id out of range
  gives a row of NaN and never reads outside the table.
- ``Conv`` — ``nn.Conv`` over ``[batch, *spatial, features]`` with 1, 2
  or 3 spatial dims, ``strides``, ``kernel_dilation``, an optional bias and
  flax's padding forms (``"VALID"``, ``"SAME"``, an int, or ``((lo, hi),
  ...)``; ``"SAME"`` follows XLA's rule, the odd cell on the high side, so
  at stride 2 it is not torch's symmetric padding). flax's kernel ``[*k,
  in, out]`` is held flattened to ``[prod(k) * in, out]`` and transposed,
  ``weight [out, prod(k) * in]``, so ``convert`` carries it as it carries
  a Dense kernel. The forward views it as ``[out, *k, in]`` and permutes
  it to torch's ``[out, in, *k]``: a ``channels_last`` tensor, no copy.
  ``feature_group_count`` (``groups``) splits the input and output
  features into that many groups as flax's does: the kernel is then
  ``[*k, in / groups, out]`` (``[out, prod(k) * in / groups]`` here) and
  the convolution takes ``groups=`` (a depthwise convolution has
  ``groups = in``).
  The input keeps JAX's channels-last layout: it is permuted to a
  channels-first view (``channels_last`` in memory), the convolution runs
  on cuDNN, and the output is permuted back, so no activation is
  transposed. Symmetric padding rides the convolution's own padding;
  asymmetric padding is ``F.pad`` first (zeros, as XLA pads). Both are
  cross-correlations: the kernel is never flipped. ``dtype`` follows
  ``Dense``'s rule. Under fp32 on the card cuDNN may take TF32 unless
  ``torch.backends.cudnn.allow_tf32`` is off (``init_orca_context``'s
  precision).
- ``BatchNorm`` — ``nn.BatchNorm`` over the last axis, flax's semantics,
  not ``nn.BatchNorm2d``'s: ``weight`` (flax ``scale``), ``bias``, and the
  buffers ``mean`` and ``var`` (flax's ``batch_stats`` collection). In
  training the batch's statistics normalise in fp32 (also for a bf16
  input) and the running ones move as ``ra = m * ra + (1 - m) * batch``
  with the *biased* variance; in eval the running ones normalise. The
  output is in ``dtype`` (None: the promoted input/parameter dtype).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.ops.embedding_bag import embedding_lookup


def _shard_of(param):
    """The strategy's shard a parameter is the block of (the estimator
    marks it), or None."""
    return getattr(param, "_zoo_shard", None)


def promote(dtype: Optional[torch.dtype], *tensors) -> torch.dtype:
    """``dtype`` if given, else the promoted dtype of ``tensors``."""
    if dtype is not None:
        return dtype
    out = tensors[0].dtype
    for t in tensors[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (None: promote)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(int(in_features), int(out_features), bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        if _shard_of(self.weight) is not None:
            # split by output features (sharded_params): the rank's
            # columns, gathered
            from analytics_zoo_tpu_torch.parallel import tensor_parallel
            return tensor_parallel.column_linear(x, self.weight, self.bias,
                                                 self.compute_dtype)
        cd = promote(self.compute_dtype, x, self.weight)
        return F.linear(x.to(cd), self.weight.to(cd),
                        None if self.bias is None else self.bias.to(cd))

    @staticmethod
    def sharded_params(shards) -> set:
        """Under a strategy: the weight where it is split by output
        features (its bias too where split alike); any other shard is
        gathered for the product."""
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        axis = tp.covers(shards, ["weight"], 0)
        if axis is None:
            return set()
        return {"weight"} | ({"bias"} if tp.covers(shards, ["bias"], 0, axis)
                             else set())


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's precision rule: fp32 inside, the
    output in ``dtype`` (None: the promoted input/parameter dtype)."""

    def __init__(self, features: int, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(int(features), eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        out = promote(self.compute_dtype, x, self.weight)
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(out)


class Embed(nn.Module):
    """``nn.Embed``: a table named ``embedding``, looked up under
    ``jnp.take``'s rule."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(
            torch.empty(int(num_embeddings), int(features)))
        nn.init.normal_(self.embedding, std=features ** -0.5)

    def forward(self, ids):
        if _shard_of(self.embedding) is not None:
            from analytics_zoo_tpu_torch.parallel import tensor_parallel
            return tensor_parallel.lookup_columns(
                [self.embedding], lambda t: embedding_lookup(t[0], ids))
        return embedding_lookup(self.embedding, ids)

    @staticmethod
    def sharded_params(shards) -> set:
        """Under a strategy: the table where it is split by columns (the
        lookup kernel on the block)."""
        from analytics_zoo_tpu_torch.parallel import tensor_parallel
        return tensor_parallel.table_covered(shards)


def _tuple(v, n: int) -> Tuple[int, ...]:
    """An int, or a sequence of ``n`` ints, as a tuple of ``n`` ints."""
    if isinstance(v, int):
        return (int(v),) * n
    v = tuple(int(e) for e in v)
    if len(v) != n:
        raise ValueError(f"expected {n} values, got {v}")
    return v


Padding = Union[str, int, Sequence]


def canonical_padding(padding: Padding, n: int):
    """flax's padding forms as ``"SAME"``, ``"VALID"`` or ``n`` ``(lo,
    hi)`` pairs: an int pads every side alike; a sequence holds an int or
    a pair per spatial dim."""
    if isinstance(padding, str):
        p = padding.upper()
        if p not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        return p
    if isinstance(padding, int):
        return ((int(padding), int(padding)),) * n
    out = tuple((int(e), int(e)) if isinstance(e, int)
                else (int(e[0]), int(e[1])) for e in padding)
    if len(out) != n:
        raise ValueError(f"padding {padding!r} for {n} spatial dims")
    return out


def resolve_pads(padding, spatial: Sequence[int], window: Sequence[int],
                 strides: Sequence[int], dilation: Sequence[int] = None
                 ) -> Tuple[Tuple[int, int], ...]:
    """The ``(lo, hi)`` zero padding of each spatial dim. ``"SAME"`` is
    XLA's rule (``lax.padtype_to_pads``): the output is ``ceil(in /
    stride)`` long, the total ``max((out - 1) * stride + span - in, 0)``
    with ``span`` the dilated window, ``lo = total // 2`` and the rest on
    the high side."""
    n = len(spatial)
    if padding == "VALID":
        return ((0, 0),) * n
    if padding != "SAME":
        return tuple(padding)
    dilation = dilation or (1,) * n
    pads = []
    for size, k, s, d in zip(spatial, window, strides, dilation):
        out = -(-int(size) // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - int(size), 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def out_size(size: int, k: int, s: int, d: int, lo: int, hi: int) -> int:
    """A window's output length over ``size`` padded by ``lo`` and
    ``hi``."""
    return (int(size) + lo + hi - ((k - 1) * d + 1)) // s + 1


def pad_last(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    """``x [batch, *spatial, channels]`` padded by ``pads`` (a pair per
    spatial dim) with ``value``."""
    flat = [0, 0]
    for lo, hi in reversed(tuple(pads)):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    """``[batch, *spatial, c]`` as a ``[batch, c, *spatial]`` view (a
    ``channels_last`` tensor when ``x`` is contiguous)."""
    nd = x.dim()
    return x.permute(0, nd - 1, *range(1, nd - 1))


def channels_last(y: torch.Tensor) -> torch.Tensor:
    """The inverse view of :func:`channels_first`."""
    nd = y.dim()
    return y.permute(0, *range(2, nd), 1)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class Conv(nn.Module):
    """flax ``nn.Conv(out_features, kernel_size, strides, padding,
    kernel_dilation, use_bias)`` on ``[batch, *spatial, in_features]``.
    An int ``kernel_size`` is a 1-D convolution."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Union[int, Sequence[int]],
                 dilation: Union[int, Sequence[int]] = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None,
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Padding = "VALID", feature_group_count: int = 1):
        super().__init__()
        ks = (int(kernel_size),) if isinstance(kernel_size, int) \
            else tuple(int(k) for k in kernel_size)
        nd = len(ks)
        if nd not in _CONV:
            raise ValueError(f"{nd} spatial dims: Conv takes 1, 2 or 3")
        self.in_features, self.out_features = int(in_features), \
            int(out_features)
        self.kernel_size = ks
        self.dilation = _tuple(dilation, nd)
        self.strides = _tuple(strides, nd)
        self.padding = canonical_padding(padding, nd)
        self.groups = int(feature_group_count)
        if self.in_features % self.groups or self.out_features % self.groups:
            raise ValueError(
                f"feature_group_count {self.groups} must divide the input "
                f"({self.in_features}) and output ({self.out_features}) "
                "features")
        #: input features a group's kernel sees
        self.group_features = self.in_features // self.groups
        self.weight = nn.Parameter(torch.empty(
            self.out_features, math.prod(ks) * self.group_features))
        self.bias = nn.Parameter(torch.zeros(self.out_features)) \
            if bias else None
        #: the flax kernel's shape (``convert.flax_leaves``)
        self.flax_kernel_shape = ks + (self.group_features, self.out_features)
        self.compute_dtype = dtype
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def pads(self, spatial: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        """The ``(lo, hi)`` padding of each spatial dim of an input."""
        return resolve_pads(self.padding, spatial, self.kernel_size,
                            self.strides, self.dilation)

    def torch_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """``[out, in / groups, *k]``: a view of the flattened weight
        (``channels_last`` for 2-D and 3-D kernels)."""
        nd = len(self.kernel_size)
        w = self.weight.to(dtype).view(self.out_features, *self.kernel_size,
                                       self.group_features)
        return w.permute(0, nd + 1, *range(1, nd + 1))

    def forward(self, x):
        cd = promote(self.compute_dtype, x, self.weight)
        pads = self.pads(x.shape[1:-1])
        x = x.to(cd)
        if all(lo == hi for lo, hi in pads):
            conv_pad = tuple(lo for lo, _ in pads)
        else:
            x, conv_pad = pad_last(x, pads), 0
        y = _CONV[len(self.kernel_size)](
            channels_first(x), self.torch_weight(cd),
            None if self.bias is None else self.bias.to(cd),
            stride=self.strides, padding=conv_pad, dilation=self.dilation,
            groups=self.groups)
        return channels_last(y)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` over the last axis of
    ``x``; ``forward(x, train)`` (module docstring). The normalisation is
    ``F.batch_norm`` on a channels-first view; in training it is handed
    scratch running buffers with ``momentum=1.0``, which it fills with the
    batch's mean and unbiased variance in fp32, and the flax update takes
    the biased variance ``unbiased * (n - 1) / n`` from them."""

    def __init__(self, features: int, momentum: float = 0.99,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = int(features)
        self.momentum, self.eps = float(momentum), float(eps)
        self.weight = nn.Parameter(torch.ones(self.features))
        self.bias = nn.Parameter(torch.zeros(self.features))
        self.register_buffer("mean", torch.zeros(self.features))
        self.register_buffer("var", torch.ones(self.features))
        self.compute_dtype = dtype

    def forward(self, x, train: bool = False):
        out = promote(self.compute_dtype, x, self.weight)
        xc = channels_first(x)
        if not train:
            y = F.batch_norm(xc, self.mean, self.var, self.weight,
                             self.bias, training=False, eps=self.eps)
            return channels_last(y).to(out)
        mean = torch.zeros_like(self.mean)
        unbiased = torch.zeros_like(self.var)
        y = F.batch_norm(xc, mean, unbiased, self.weight, self.bias,
                         training=True, momentum=1.0, eps=self.eps)
        n = x.numel() // self.features
        m = self.momentum
        with torch.no_grad():
            # in place, two launches a buffer: ra = m * ra + (1 - m) * batch
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(unbiased, alpha=(1 - m) * (n - 1) / n)
        return channels_last(y).to(out)
