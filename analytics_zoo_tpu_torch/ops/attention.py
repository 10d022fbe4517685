"""Scaled dot-product attention and the attention module.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``:

- ``dot_product_attention`` — the flash path (``ops/flash_attention.py``)
  when asked for or when auto-select picks it, and only without a mask;
  otherwise the plain einsum chain ``_reference_attention``. On CUDA the
  flash path launches the forward kernel with its own tile and, under
  autograd, the dq and dk/dv backward kernels (there is no autotuner
  yet, so no verdict: the port's autotuner will choose among kernels,
  never the plain chain). On the CPU it runs ``blockwise_attention``, as
  the JAX package does off the TPU, differentiated by autograd.
- ``AttentionModule`` — head projections, attention, output projection,
  with the JAX parameter names: ``query`` / ``key`` / ``value`` hold
  ``weight [h*d, in]`` and ``bias [h*d]`` (the flax ``[in, h, d]`` kernel
  and ``[h, d]`` bias, flattened and transposed by ``convert.py``), and
  ``out`` holds ``weight [in, h*d]``. Self-attention computes the three
  projections as one packed matmul.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.common.flax_compat import Dense, promote


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          use_flash: Optional[bool] = None):
    """q, k, v: [batch, seq, heads, head_dim] -> [batch, seq, heads,
    head_dim]. ``use_flash=None`` auto-selects (``_flash_ok``); True takes
    the flash path whenever there is no mask; False pins the einsum
    chain."""
    if use_flash is None:
        use_flash = _flash_ok(q, k, mask)
    if use_flash and mask is None:
        if q.device.type == "cuda":
            from analytics_zoo_tpu_torch.ops.flash_attention import (
                flash_attention,
            )
            return flash_attention(q, k, v, causal=causal)
        from analytics_zoo_tpu_torch.ops.flash_attention import (
            blockwise_attention,
        )
        return blockwise_attention(q, k, v, causal=causal)
    return _reference_attention(q, k, v, mask=mask, causal=causal)


def _flash_ok(q, k, mask) -> bool:
    """The flash path only without a mask, on CUDA, and (with no autotuner
    verdict to consult) only where the full [b, h, sq, sk] fp32 score
    matrix would pass 2 GiB."""
    if mask is not None or q.device.type != "cuda":
        return False
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    return 4 * b * h * sq * sk > (1 << 31)


def _reference_attention(q, k, v, mask=None, causal: bool = False,
                         return_probs: bool = False):
    d = q.shape[-1]
    root = torch.tensor(np.float32(math.sqrt(d)), dtype=q.dtype,
                        device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root
    lowest = torch.finfo(scores.dtype).min
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones((sq, sk), dtype=torch.bool,
                           device=q.device).tril(sk - sq)
        scores = torch.where(cmask, scores, lowest)
    if mask is not None:
        scores = torch.where(torch.as_tensor(mask, device=q.device).bool(),
                             scores, lowest)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return (out, probs) if return_probs else out


class AttentionModule(nn.Module):
    """Projection + attention + output projection.

    ``q_features`` / ``kv_features``: input widths of the query and
    key/value sides (``kv_features`` defaults to ``q_features``).
    ``dtype``: computation dtype (parameters stay fp32). ``self_attention``
    forces the packed-QKV path on (True) or off (False); None packs when
    ``kv_in is None or kv_in is q_in``. ``use_flash`` goes to
    ``dot_product_attention``."""

    def __init__(self, num_heads: int, head_dim: int, q_features: int,
                 kv_features: Optional[int] = None, dropout: float = 0.0,
                 causal: bool = False, dtype: Optional[torch.dtype] = None,
                 self_attention: Optional[bool] = None,
                 use_flash: Optional[bool] = None):
        super().__init__()
        h, d = int(num_heads), int(head_dim)
        kv_features = q_features if kv_features is None else kv_features
        self.num_heads, self.head_dim = h, d
        self.dropout, self.causal, self.dtype = dropout, causal, dtype
        self.self_attention = self_attention
        self.use_flash = use_flash
        self.query = Dense(q_features, h * d, dtype=dtype)
        self.key = Dense(kv_features, h * d, dtype=dtype)
        self.value = Dense(kv_features, h * d, dtype=dtype)
        self.out = Dense(h * d, q_features, dtype=dtype)
        # the flax layout (DenseGeneral): [in, h, d] projections and an
        # [h, d, out] output, which a checkpoint holds (convert.py)
        for proj, fan_in in ((self.query, q_features),
                             (self.key, kv_features),
                             (self.value, kv_features)):
            proj.flax_kernel_shape = (fan_in, h, d)
            proj.flax_bias_shape = (h, d)
        self.out.flax_kernel_shape = (h, d, q_features)

    def forward(self, q_in, kv_in=None, mask=None, train: bool = False):
        self_attn = (self.self_attention if self.self_attention is not None
                     else kv_in is None or kv_in is q_in)
        kv_in = q_in if kv_in is None else kv_in
        h, d = self.num_heads, self.head_dim
        if self_attn:
            # one packed (in -> 3*h*d) matmul instead of three; q, k and v
            # are strided views of its output, which the kernel reads as is
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight])
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias])
            cd = promote(self.dtype, q_in, w)
            qkv = F.linear(q_in.to(cd), w.to(cd), b.to(cd))
            q, k, v = qkv.unflatten(-1, (3, h, d)).unbind(-3)
        else:
            q = self.query(q_in).unflatten(-1, (h, d))
            k = self.key(kv_in).unflatten(-1, (h, d))
            v = self.value(kv_in).unflatten(-1, (h, d))
        out = dot_product_attention(q, k, v, mask=mask, causal=self.causal,
                                    use_flash=self.use_flash)
        out = self.out(out.flatten(-2))
        if self.dropout > 0:
            out = F.dropout(out, self.dropout, training=train)
        return out
