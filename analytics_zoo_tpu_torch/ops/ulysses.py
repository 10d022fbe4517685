"""Ulysses attention: all-to-all sequence parallelism over ``seq``.

Counterpart of ``analytics_zoo_tpu/ops/ulysses.py`` (the DeepSpeed-Ulysses
recipe). Activations arrive sequence-split, ``[b, s/p, h, d]`` a rank;
one ``all_to_all`` (``collectives.all_to_all``, JAX's tiled
``all_to_all``) reshards them to head-split ``[b, s, h/p, d]``, so each
rank runs attention over the whole sequence on its own heads: the flash
kernel (B3, and B4/B5 in the backward) when ``use_flash`` holds, else
JAX's ``_attention`` chain; a second ``all_to_all`` brings the output
back to sequence blocks. The head count and the sequence must divide
over the axis.

``ulysses_attention(q, k, v, mesh=...)`` takes JAX's arguments: each
rank passes its rows with the whole sequence (a batch sharded over
``batch_axis`` already gives each rank its rows), takes its sequence
block, and the output blocks are all-gathered along the sequence, so
every rank of the axis returns the whole output.
``ulysses_attention_local`` takes and returns the rank's sequence block.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib


def _attention(q, k, v, causal: bool):
    """JAX's ``_attention``: einsum scores in q's dtype, a float32
    softmax, the probabilities back in q's dtype."""
    d = q.shape[-1]
    root = torch.tensor(np.float32(math.sqrt(d)), dtype=q.dtype,
                        device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / root
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = torch.where(mask, s, torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check(mesh, axis: str, s: int, h: int) -> int:
    p = mesh_lib.mesh_axis_size(mesh, axis)
    if p < 2:
        raise ValueError(f"mesh has no usable {axis!r} axis: {mesh.shape}")
    if s % p or h % p:
        raise ValueError(f"seq {s} and heads {h} must divide the {axis!r} "
                         f"axis size {p}")
    return p


def ulysses_attention_local(q, k, v, *, mesh=None, causal: bool = False,
                            axis: str = mesh_lib.SEQ_AXIS,
                            use_flash: Optional[bool] = None):
    """q, k, v: this rank's sequence block ``[b, s/p, h, d]`` -> its block
    of the output."""
    if mesh is None:
        mesh = mesh_lib.get_default_mesh()
    p = _check(mesh, axis, q.shape[1] * mesh_lib.mesh_axis_size(mesh, axis),
               q.shape[2])
    if use_flash is None:
        from analytics_zoo_tpu_torch.ops.flash_attention import (
            default_use_flash,
        )
        use_flash = default_use_flash(q.shape[1] * p, q.shape[-1])
    # [b, s/p, h, d] -> [b, s, h/p, d]: heads split over the ranks, the
    # sequence blocks laid end to end
    qh, kh, vh = (collectives.all_to_all(t, mesh, axis, 2, 1)
                  for t in (q, k, v))
    if use_flash:
        from analytics_zoo_tpu_torch.ops.flash_attention import (
            flash_attention,
        )
        out = flash_attention(qh, kh, vh, causal)
    else:
        out = _attention(qh, kh, vh, causal)
    return collectives.all_to_all(out, mesh, axis, 1, 2)


def ulysses_attention(q, k, v, *, mesh=None, causal: bool = False,
                      axis: str = mesh_lib.SEQ_AXIS,
                      batch_axis: Optional[str] = None,
                      use_flash: Optional[bool] = None):
    """q, k, v: ``[b, s, h, d]``, this rank's rows with the whole sequence
    (``s`` and ``h`` divisible by the axis size) -> the same shape (the
    module docstring). ``use_flash=None`` takes the flash kernel where
    ``default_use_flash(s, d)`` holds."""
    if mesh is None:
        mesh = mesh_lib.get_default_mesh()
    p = _check(mesh, axis, q.shape[1], q.shape[2])
    s_loc = q.shape[1] // p
    start = mesh.coord(axis) * s_loc
    local = [t.narrow(1, start, s_loc) for t in (q, k, v)]
    out = ulysses_attention_local(*local, mesh=mesh, causal=causal,
                                  axis=axis, use_flash=use_flash)
    return collectives.all_gather(out, mesh, axis, 1)
