"""Scaled dot-product attention and the attention module.

Counterpart of ``analytics_zoo_tpu/ops/attention.py``:

- ``dot_product_attention`` — the flash path (``ops/flash_attention.py``)
  when asked for or when auto-select picks it, and only without a mask;
  otherwise the plain einsum chain ``_reference_attention``. On CUDA the
  flash path launches the forward kernel with its own tile and, under
  autograd, the dq and dk/dv backward kernels. ``use_flash=None`` reads
  the autotuner's verdict for the shape first (``ops/autotune.py``), as
  JAX's ``_flash_ok`` does: the flash kernel where it won its
  measurement, the einsum chain where it lost (JAX's own non-flash
  route, never the kernel's plain version); without a verdict the 2 GiB
  heuristic below. On the CPU it runs ``blockwise_attention`` for the
  flash path, as the JAX package does off the TPU, differentiated by
  autograd, and ``use_flash=None`` takes the einsum chain.
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
from analytics_zoo_tpu_torch.ops import autotune


def dot_product_attention(q, k, v, mask=None, causal: bool = False,
                          use_flash: Optional[bool] = None):
    """q, k, v: [batch, seq, heads, head_dim] -> [batch, seq, heads,
    head_dim]. ``use_flash=None`` auto-selects (``_flash_ok``: a persisted
    verdict first, then the heuristic); True takes the flash path whenever
    there is no mask (on the card the kernel, whatever a verdict says);
    False pins the einsum chain."""
    if use_flash is None:
        use_flash = _flash_ok(q, k, mask)
    if use_flash and mask is None:
        from analytics_zoo_tpu_torch.ops import flash_attention as fa
        # while a step's products are counted the CPU takes the flash
        # Function too, so the count does not depend on the route
        if q.device.type == "cuda" or fa.counting():
            return fa.flash_attention(q, k, v, causal=causal)
        return fa.blockwise_attention(q, k, v, causal=causal)
    return _reference_attention(q, k, v, mask=mask, causal=causal)


def _flash_ok(q, k, mask) -> bool:
    """The flash path only without a mask and on CUDA. A verdict for the
    shape decides (``autotune.attention_decision``: in ``sync`` mode a
    miss is measured on the spot unless a CUDA graph is being captured,
    otherwise queued for the warm-up workers); without one, only where
    the full [b, h, sq, sk] fp32 score matrix would pass 2 GiB. A kernel
    that raised while measured raises here (``autotune.AutotuneFault``)."""
    if mask is not None or q.device.type != "cuda":
        return False
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rec = autotune.attention_decision(b, sq, sk, h, d, q.dtype, False,
                                      concrete=not autotune._capturing())
    if rec is not None:
        return autotune.use_kernel(rec)
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

    def sharded_params(self, shards) -> set:
        """Under a strategy, Megatron's layout: ``query`` / ``key`` /
        ``value`` split by heads (their output rows) and ``out`` by its
        input columns over one axis; the attention then runs on this
        rank's heads and ``out``'s partial products are summed with one
        all_reduce. Otherwise every shard here is gathered."""
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        proj = ["query.weight", "key.weight", "value.weight"]
        axis = tp.covers(shards, proj, 0)
        if axis is None or tp.covers(shards, ["out.weight"], 1, axis) is None \
                or "out.bias" in shards:
            return set()
        biases = [f"{n}.bias" for n in ("query", "key", "value")]
        return set(proj) | {"out.weight"} | {
            b for b in biases if tp.covers(shards, [b], 0, axis)}

    def _heads(self):
        """The heads this rank computes: all of them, or its block under
        Megatron's layout."""
        from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
        shard = tp.shard_of(self.query.weight)
        if shard is None:
            return self.num_heads, None
        axis = tp.split_axis(shard, 0)
        return self.num_heads // shard.mesh.shape[axis], shard

    def forward(self, q_in, kv_in=None, mask=None, train: bool = False):
        self_attn = (self.self_attention if self.self_attention is not None
                     else kv_in is None or kv_in is q_in)
        kv_in = q_in if kv_in is None else kv_in
        d = self.head_dim
        h, shard = self._heads()
        projs = (self.query, self.key, self.value)
        if shard is not None:
            from analytics_zoo_tpu_torch.parallel import tensor_parallel as tp
            axis = tp.split_axis(shard, 0)
            biases = [tp.local_bias(p.bias, shard, shard.mesh, axis)
                      for p in projs]
        else:
            biases = [p.bias for p in projs]
        if self_attn:
            # one packed (in -> 3*h*d) matmul instead of three; q, k and v
            # are strided views of its output, which the kernel reads as is
            w = torch.cat([p.weight for p in projs])
            b = torch.cat(biases)
            cd = promote(self.dtype, q_in, w)
            qkv = F.linear(q_in.to(cd), w.to(cd), b.to(cd))
            q, k, v = qkv.unflatten(-1, (3, h, d)).unbind(-3)
        elif shard is not None:
            outs = []
            for p, b, x in zip(projs, biases, (q_in, kv_in, kv_in)):
                cd = promote(self.dtype, x, p.weight)
                outs.append(F.linear(x.to(cd), p.weight.to(cd),
                                     b.to(cd)).unflatten(-1, (h, d)))
            q, k, v = outs
        else:
            q = self.query(q_in).unflatten(-1, (h, d))
            k = self.key(kv_in).unflatten(-1, (h, d))
            v = self.value(kv_in).unflatten(-1, (h, d))
        out = dot_product_attention(q, k, v, mask=mask, causal=self.causal,
                                    use_flash=self.use_flash)
        if shard is not None:
            out = tp.row_linear(out.flatten(-2), self.out.weight,
                                self.out.bias, self.dtype)
        else:
            out = self.out(out.flatten(-2))
        if self.dropout > 0:
            out = F.dropout(out, self.dropout, training=train)
        return out
