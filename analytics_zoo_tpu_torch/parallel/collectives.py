"""The collectives over a mesh axis: the port's only caller of
``torch.distributed``'s data movement.

JAX lets XLA insert its collectives from the shardings; the port calls
them itself, each on the subgroup of one mesh axis
(``DeviceMesh.axis_group``):

- ``all_reduce`` (sum), ``all_gather`` and ``reduce_scatter`` along a
  dim, ``all_to_all`` (split one dim over the ranks, concatenate another,
  JAX's ``all_to_all(..., tiled=True)``) and ``ring_shift`` (one
  ``batch_isend_irecv`` to the next rank of the axis, JAX's ``ppermute``
  around the ring). Each is an autograd Function whose backward is the
  adjoint of its forward: all_reduce's is all_reduce, all_gather's is
  reduce_scatter (and back), all_to_all's is the reverse all_to_all and
  ring_shift's the reverse shift. So a program in which every rank runs
  its part of one computation differentiates to the gradient of the sum
  of what the ranks return (learn/estimator.py scales each rank's loss
  so that this sum is the global loss).
- ``all_reduce_(tensor, mesh, axes)``: an in-place sum over several axes,
  outside autograd (the gradients' reduction).
- On an axis of one rank every call returns its input.

**gloo and CUDA tensors.** NCCL carries every call directly. gloo
carries CPU tensors directly, and on CUDA tensors the ops of
``GLOO_CUDA_DIRECT``: ``dev/gloo_cuda_probe.py`` ran each op once on
CUDA tensors over a gloo group (torch 2.11, H100) and found every op but
the ring's send/recv carried bitwise, 2-4.5x faster than staging them
(gloo's send/recv hand the card's pointer to the host's socket: "Bad
address"). The ring shift is staged through pinned host buffers: the
input copied to the host, the op run there, the result copied back. The
table decides, by backend and op: nothing is tried and caught.
``staging_table()`` gives the table as this process's backend uses
it.

``stats`` counts each op's calls and host seconds (the collectives'
share of a step: every gloo call, staged or not, returns when its data
has arrived).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Sequence

import torch

#: ops gloo carries on CUDA tensors itself (dev/gloo_cuda_probe.py); the
#: rest are staged through the host on a gloo group
GLOO_CUDA_DIRECT = frozenset({"all_reduce", "broadcast", "all_gather",
                              "reduce_scatter", "all_to_all"})
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "ring_shift", "broadcast")

#: op -> [calls, host seconds]
stats: Dict[str, list] = defaultdict(lambda: [0, 0.0])
_stats_lock = threading.Lock()


def reset_stats() -> None:
    with _stats_lock:
        stats.clear()


def stats_seconds() -> float:
    with _stats_lock:
        return float(sum(s for _, s in stats.values()))


def _note(op: str, t0: float) -> None:
    with _stats_lock:
        rec = stats[op]
        rec[0] += 1
        rec[1] += time.perf_counter() - t0


def _backend(group) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(group)).lower()


def staged(op: str, tensor: torch.Tensor, group) -> bool:
    """True when ``op`` on ``tensor`` over ``group`` goes through the
    host: a CUDA tensor on a gloo group, for an op gloo does not carry on
    the card."""
    return tensor.device.type == "cuda" and _backend(group) == "gloo" \
        and op not in GLOO_CUDA_DIRECT


def staging_table(group=None) -> Dict[str, str]:
    """``{op: "direct" | "staged"}`` for CUDA tensors on ``group`` (the
    default group without one)."""
    import torch.distributed as dist
    backend = _backend(group if group is not None else dist.group.WORLD)
    return {op: ("staged" if backend == "gloo" and op not in
                 GLOO_CUDA_DIRECT else "direct") for op in OPS}


def _run(op: str, group, fn, *tensors):
    """``fn(*tensors)`` where the op runs: on the tensors, or on host
    copies whose results go back to the first tensor's device."""
    if not staged(op, tensors[0], group):
        return fn(*tensors)
    device = tensors[0].device
    host = [t.detach().to("cpu").pin_memory() for t in tensors]
    out = fn(*host)
    return out.to(device, non_blocking=False)


def _group(mesh, axis):
    return None if mesh is None else mesh.axis_group(axis)


def _size(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


# ------------------------------------------------------------ raw ops

def _all_reduce_raw(t: torch.Tensor, group, op: str = "sum"
                    ) -> torch.Tensor:
    import torch.distributed as dist
    t0 = time.perf_counter()
    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

    def fn(x):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=reduce_op, group=group)
        return x
    out = _run("all_reduce", group, fn, t)
    _note("all_reduce", t0)
    return out


def _all_gather_raw(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    p = _size(group)
    t0 = time.perf_counter()

    def fn(x):
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((p * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = _run("all_gather", group, fn, t).movedim(0, dim)
    _note("all_gather", t0)
    return out.contiguous()


def _reduce_scatter_raw(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    p = _size(group)
    if t.shape[dim] % p:
        raise ValueError(f"reduce_scatter: dim {dim} of size {t.shape[dim]} "
                         f"does not divide over {p} ranks")
    t0 = time.perf_counter()

    def fn(x):
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // p,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    out = _run("reduce_scatter", group, fn, t).movedim(0, dim)
    _note("reduce_scatter", t0)
    return out.contiguous()


def _all_to_all_raw(t: torch.Tensor, group, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    import torch.distributed as dist
    p = _size(group)
    if t.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{t.shape[split_dim]} does not divide over {p} "
                         "ranks")
    t0 = time.perf_counter()
    chunk = t.shape[split_dim] // p
    # [p, ..., chunk, ...]: the chunk for rank j first
    x = t.unflatten(split_dim, (p, chunk)).movedim(split_dim, 0)

    def fn(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    got = _run("all_to_all", group, fn, x)
    # got[j]: rank j's block, the other dims as t's with split_dim cut to
    # a chunk; the sources go along concat_dim, source major
    out = got.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)
    _note("all_to_all", t0)
    return out.contiguous()


def _ring_shift_raw(t: torch.Tensor, mesh, axis: str, shift: int
                    ) -> torch.Tensor:
    import torch.distributed as dist
    group = _group(mesh, axis)
    ranks = mesh.axis_ranks(axis)
    p = len(ranks)
    me = ranks.index(mesh.rank)
    dst, src = ranks[(me + shift) % p], ranks[(me - shift) % p]
    t0 = time.perf_counter()

    def fn(x):
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, dst, group=group),
               dist.P2POp(dist.irecv, out, src, group=group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out
    out = _run("ring_shift", group, fn, t)
    _note("ring_shift", t0)
    return out


# ------------------------------------------------------ autograd ops

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce_raw(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_raw(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_raw(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_raw(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all_raw(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all_raw(g, ctx.group, concat_dim, split_dim), None,
                None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ring_shift_raw(t, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift_raw(g, ctx.mesh, ctx.axis, -ctx.shift), None, \
            None, None


def all_reduce(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``t`` over ``axis``'s ranks, on each of them."""
    group = _group(mesh, axis)
    return t if group is None else _AllReduce.apply(t, group)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in axis order."""
    group = _group(mesh, axis)
    return t if group is None else _AllGather.apply(t, group, dim % t.ndim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int = 0
                   ) -> torch.Tensor:
    """The sum of ``t`` over ``axis``'s ranks, split along ``dim``: rank
    ``i`` of the axis keeps block ``i``."""
    group = _group(mesh, axis)
    return t if group is None else _ReduceScatter.apply(t, group,
                                                        dim % t.ndim)


def all_to_all(t: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's ``all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    block ``j`` of ``split_dim`` goes to rank ``j``; the blocks received
    are laid along ``concat_dim`` in source order."""
    group = _group(mesh, axis)
    if group is None:
        return t
    return _AllToAll.apply(t, group, split_dim % t.ndim, concat_dim % t.ndim)


def ring_shift(t: torch.Tensor, mesh, axis: str, shift: int = 1
               ) -> torch.Tensor:
    """``t`` of the rank ``shift`` places back along ``axis`` (each rank
    sends its own ``shift`` places on, around the ring)."""
    if _group(mesh, axis) is None:
        return t
    return _RingShift.apply(t, mesh, axis, int(shift))


def gather_axes(t: torch.Tensor, mesh, axes: Sequence[str], dim: int
                ) -> torch.Tensor:
    """``all_gather`` over several axes sharding one dim (the first axis
    major, as in a JAX spec's tuple): the last axis first."""
    for ax in reversed(tuple(axes)):
        t = all_gather(t, mesh, ax, dim)
    return t


def all_reduce_(t: torch.Tensor, mesh, axes: Sequence[str],
                op: str = "sum") -> torch.Tensor:
    """In place, outside autograd: the sum (or ``op="max"``, the largest)
    of ``t`` over ``axes``."""
    for ax in axes:
        group = _group(mesh, ax)
        if group is None:
            continue
        with torch.no_grad():
            t.copy_(_all_reduce_raw(t, group, op))
    return t


def barrier() -> None:
    """Every rank of the process group waits for the others."""
    import torch.distributed as dist
    dist.barrier()


def broadcast_(t: torch.Tensor, mesh, axis: str, src_index: int = 0
               ) -> torch.Tensor:
    """In place: rank ``src_index`` of ``axis``'s row to every rank of
    it."""
    import torch.distributed as dist
    group = _group(mesh, axis)
    if group is None:
        return t
    src = mesh.axis_ranks(axis)[src_index]
    t0 = time.perf_counter()

    def fn(x):
        x = x.contiguous().clone()
        dist.broadcast(x, src, group=group)
        return x
    with torch.no_grad():
        t.copy_(_run("broadcast", group, fn, t))
    _note("broadcast", t0)
    return t
