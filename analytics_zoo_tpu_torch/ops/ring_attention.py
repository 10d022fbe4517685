"""Ring attention: sequence parallelism over the ``seq`` mesh axis.

Counterpart of ``analytics_zoo_tpu/ops/ring_attention.py``. Each rank
holds one block of the sequence of q, k and v; the k/v blocks travel
around the ring (``collectives.ring_shift``, one ``batch_isend_irecv`` a
step, JAX's ``ppermute``), so after ``p`` steps every query block has
seen every key block, with O(s/p) memory a rank.

- The plain ring (``_ring_attention_local``, JAX's): an online softmax
  over each resident block in float32, causal masks from the blocks'
  global positions.
- The flash ring (``_ring_flash_local``, JAX's): each resident block goes
  through the flash kernel with its lse (``flash_attention_with_lse``:
  B3 on the card, its plain version on the CPU), and the partial
  softmaxes merge by their lse in float32. Past blocks run unmasked, the
  diagonal block causal, and a future block (its source index above the
  rank's) makes no launch: the rank knows the source, so it is a Python
  skip, and merging JAX's "dead" block would change nothing. The
  gradients of q, k and v come from the flash backward kernels (B4, B5)
  with the lse's cotangent, and back around the ring by the reverse
  shift (the skipped blocks join the graph with zero gradients, so
  every rank runs every shift's backward). B3 launches a rank: ``p``
  unmasked, ``rank + 1`` causal.

The port's flash launcher has one tile a head dim (``kernel_tile``) and
raises on another, so ``flash_block`` only sets ``default_use_flash``'s
threshold, as JAX's auto-selection reads it; no tile is passed. The
kernel returns its lse as ``[b*h, s]``, viewed as JAX's ``(b, h, s)``.

``ring_attention(q, k, v, mesh, ...)`` takes JAX's arguments. Each rank
passes its rows (its block of a batch sharded over ``batch_axis`` is
already its own) with the whole sequence; the rank takes its sequence
block, runs the ring, and the output blocks are all-gathered along the
sequence, so every rank of the axis returns the whole output.
``ring_attention_local`` takes the rank's sequence block and returns its
block of the output.
"""

from __future__ import annotations

from typing import Optional

import torch

from analytics_zoo_tpu_torch.parallel import collectives
from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``tensors`` in its graph: their gradients
    are zeros. A causal rank skips the blocks from its future, but every
    rank must still run the backward of every shift (a shift's backward
    is a send and a receive that pair up across the ranks)."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.like))


def _ring_flash_local(q, k, v, *, mesh, axis_name: str, causal: bool):
    from analytics_zoo_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse,
    )
    p = mesh_lib.mesh_axis_size(mesh, axis_name)
    my = mesh.coord(axis_name)
    b, s_loc, h, d = q.shape
    num = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    den = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    unused = []
    for i in range(p):
        src = (my - i) % p
        if causal and src > my:
            unused += [k_cur, v_cur]
        else:
            o_i, lse_i = flash_attention_with_lse(
                q, k_cur, v_cur, causal=causal and src == my)
            o_i = o_i.float().permute(0, 2, 1, 3)
            lse_i = lse_i.reshape(b, h, s_loc)
            m_new = torch.maximum(m, lse_i)
            c_old = torch.exp(m - m_new)
            c_new = torch.exp(lse_i - m_new)
            num = num * c_old[..., None] + o_i * c_new[..., None]
            den = den * c_old + c_new
            m = m_new
        if i < p - 1:
            k_cur = collectives.ring_shift(k_cur, mesh, axis_name)
            v_cur = collectives.ring_shift(v_cur, mesh, axis_name)
    out = num / torch.clamp(den, min=1e-37)[..., None]
    if unused and torch.is_grad_enabled():
        out = _Tie.apply(out, *unused)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _ring_attention_local(q, k, v, *, mesh, axis_name: str, causal: bool):
    p = mesh_lib.mesh_axis_size(mesh, axis_name)
    my = mesh.coord(axis_name)
    b, s_loc, h, d = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    qf = q.float()
    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    pos = torch.arange(s_loc, device=q.device)
    for i in range(p):
        # the global index of the key block resident here
        src = (my - i) % p
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * \
            scale.to(q.device)
        if causal:
            allowed = (src * s_loc + pos)[None, :] <= (my * s_loc + pos)[:, None]
            s = torch.where(allowed[None, None], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", pr,
                                               v_cur.float())
        m = m_new
        if i < p - 1:
            k_cur = collectives.ring_shift(k_cur, mesh, axis_name)
            v_cur = collectives.ring_shift(v_cur, mesh, axis_name)
    out = o / torch.clamp(l, min=1e-37)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _mesh_of(mesh, axis_name: str):
    if mesh is None:
        mesh = mesh_lib.get_default_mesh()
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.shape}")
    return mesh


def _flash(use_flash: Optional[bool], s_loc: int, head_dim: int,
           flash_block: int) -> bool:
    if use_flash is not None:
        return bool(use_flash)
    from analytics_zoo_tpu_torch.ops.flash_attention import default_use_flash
    return default_use_flash(s_loc, head_dim, flash_block)


def ring_attention_local(q, k, v, mesh=None,
                         axis_name: str = mesh_lib.SEQ_AXIS,
                         causal: bool = False,
                         use_flash: Optional[bool] = None,
                         flash_block: int = 128):
    """q, k, v: this rank's sequence block ``[b, s / p, h, d]`` (rank
    ``i`` of ``axis_name`` holds positions ``[i s/p, (i+1) s/p)``) ->
    its block of the output."""
    mesh = _mesh_of(mesh, axis_name)
    fn = _ring_flash_local if _flash(use_flash, q.shape[1], q.shape[-1],
                                     flash_block) else _ring_attention_local
    return fn(q, k, v, mesh=mesh, axis_name=axis_name, causal=causal)


def ring_attention(q, k, v, mesh=None, axis_name: str = mesh_lib.SEQ_AXIS,
                   causal: bool = False, batch_axis: Optional[str] = None,
                   use_flash: Optional[bool] = None,
                   flash_block: int = 128):
    """q, k, v: ``[batch, seq, heads, dim]``, this rank's rows with the
    whole sequence -> the same shape (the module docstring).
    ``batch_axis`` is JAX's (the batch's own sharding): a rank's rows are
    already its block. ``use_flash=None`` takes the flash ring where
    ``default_use_flash(seq / p, dim, flash_block)`` holds (a CUDA device
    and a local block of at least ``flash_block``)."""
    mesh = _mesh_of(mesh, axis_name)
    p = mesh_lib.mesh_axis_size(mesh, axis_name)
    if q.shape[1] % p:
        raise ValueError(f"seq len {q.shape[1]} must divide over "
                         f"{axis_name}={p}")
    s_loc = q.shape[1] // p
    start = mesh.coord(axis_name) * s_loc
    local = [t.narrow(1, start, s_loc) for t in (q, k, v)]
    out = ring_attention_local(*local, mesh=mesh, axis_name=axis_name,
                               causal=causal, use_flash=use_flash,
                               flash_block=flash_block)
    return collectives.all_gather(out, mesh, axis_name, 1)
