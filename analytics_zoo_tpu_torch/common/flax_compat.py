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
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from analytics_zoo_tpu_torch.ops.embedding_bag import embedding_lookup


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
        cd = promote(self.compute_dtype, x, self.weight)
        return F.linear(x.to(cd), self.weight.to(cd),
                        None if self.bias is None else self.bias.to(cd))


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
        return embedding_lookup(self.embedding, ids)
