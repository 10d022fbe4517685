"""Embedding lookups for the recsys path, in PyTorch and CUDA, forward and
backward.

Counterpart of ``analytics_zoo_tpu/ops/embedding_bag.py``:

- ``embedding_lookup`` — one table, ``table[ids]`` with ``jnp.take``'s
  rule for ids out of range (plain PyTorch, differentiable as it is).
- ``fused_embedding_lookup`` — N tables, one id column per table
  (``ids[b, t]`` indexes table ``t``), rows combined per ``concat`` /
  ``sum`` / ``mean`` / ``mul``. Its CUDA kernel replaces the Pallas
  ``_fused_lookup_kernel``.
- ``embedding_bag`` — one table, a ``[batch, bag]`` id matrix with per-bag
  lengths, sum- or mean-pooled over the valid prefix. Its CUDA kernel
  replaces the Pallas ``_bag_kernel``.
- ``embedding_bag_ragged`` — offsets-form bags, plain PyTorch (the JAX
  function is plain ``segment_sum``).

Both kernels sit behind a ``torch.autograd.Function`` when a gradient is
wanted (grad mode on and a table that requires grad); otherwise the public
function checks its arguments once and calls the launcher itself, which
makes one launch: no autograd, no device guard (the C entry point takes
the device index and the raw stream and switches device only when the
calling thread's differs), the lookup's argument block taken from a small
cache keyed by the tables' storage and shapes, and for the bag no lengths
tensor and no clamp on the host (the kernel reads a null lengths pointer
as full bags and clamps each id it reads). Their backward is
JAX's plain scatter-add (``_fused_bwd`` / ``_bag_bwd``): each gradient
table starts at zero and takes one update per looked-up position. On CUDA
that is one scatter kernel of two passes (``csrc/embedding_bag.cu``),
deterministic: a stable sort of the positions by row, then a fixed
two-level sum per row that depends on the inputs alone. A run of at most
``RUN_CHUNK`` updates is added in position order; a longer run (a
padding id) is cut into chunks of ``RUN_CHUNK`` that warps sum in
parallel, and a second pass adds the chunk sums in chunk order. A CUDA
tensor launches the kernels or raises;
the plain versions (``_fused_ref``, ``_bag_ref``, ``_fused_bwd_ref``,
``_bag_bwd_ref``) run only for tensors on the CPU, and accumulate in the
kernels' order and precision, so the two agree bitwise.

``use_kernel`` (JAX's) follows the port's rule (ROADMAP C26): the tensors'
device picks the route; True on a CPU tensor and False on a CUDA tensor
raise. ``tune_fused_lookup`` and ``tune_bag`` time each kernel against its
plain version on the card and persist JAX's record
(``ops/autotune.py``): a measurement, never a route.

Ids: the fused lookup follows ``jnp.take`` (ids in ``[-V, V)`` index the
table, negative ones wrapping, any other id gives a NaN row) and its
backward follows ``.at[ids].add`` (negative ids wrap, ids outside
``[-V, V)`` scatter nowhere). The bag clamps its ids into ``[0, V-1]``,
as the JAX dispatcher does: the CPU route clamps before the plain version,
the kernel as it reads each id, and the backward's keys (``_bag_keys``)
from the saved ids. Neither kernel reads outside a table.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common import profiling
from analytics_zoo_tpu_torch.ops import _build

_COMBINES = ("concat", "sum", "mean", "mul")
_COMBINE_CODE = {"concat": 0, "sum": 1, "mean": 2, "mul": 3}
MAX_TABLES = 8
#: argument blocks of the fused lookup kept at once (``_fused_args``)
ARGS_CACHE_SIZE = 64
#: updates a row's run takes before the scatter sums it in two levels:
#: chunks of RUN_CHUNK positions, then the chunk sums (SCATTER_RUN_CHUNK in
#: csrc/embedding_bag.cu)
RUN_CHUNK = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: launches of each CUDA kernel (the plain versions never count)
launches = _build.launch_counter("fused_embedding_lookup")
bag_launches = _build.launch_counter("embedding_bag")
scatter_launches = _build.launch_counter("embedding_scatter_add")

# scatter kernel modes (csrc/embedding_bag.cu): how one position's update
# is made from the output gradient
_SCATTER_COPY, _SCATTER_MUL = 0, 1            # combine
_SCALE_NONE, _SCALE_RECIP, _SCALE_LENGTH = 0, 1, 2   # scale


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the plain versions: fp32, or float64 for
    float64 tables (which only the CPU's plain versions take, for
    gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def _recip(n: int, acc: torch.dtype) -> float:
    """``1 / n`` rounded once to the accumulation dtype, as the JAX
    reference writes the mean (``jnp.float32(1.0 / n)``)."""
    return float(np.float32(1.0 / n)) if acc == torch.float32 else 1.0 / n


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: negative ids in ``[-V, 0)`` wrap,
    ids outside ``[-V, V)`` give a row of NaN."""
    vocab = table.shape[0]
    ids = ids.to(torch.int64)
    valid = (ids >= -vocab) & (ids < vocab)
    rows = table.index_select(0, (ids % vocab).reshape(-1))
    rows = rows.reshape(*ids.shape, table.shape[1])
    nan = torch.full((), float("nan"), dtype=table.dtype, device=table.device)
    return torch.where(valid.unsqueeze(-1), rows, nan)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain single-table gather, ``table[ids]`` under ``jnp.take``'s
    rule, kept as a named op so layers route every lookup through one
    module."""
    return _take(table, ids)


# ------------------------------------------------------------- references

def _fused_ref(tables: Sequence[torch.Tensor], ids: torch.Tensor,
               combine: str) -> torch.Tensor:
    """Plain fused lookup, accumulation order mirroring the kernel: rows
    combine left to right in fp32 (except concat, which never
    accumulates), result in the tables' dtype."""
    rows = [_take(t, ids[:, i]) for i, t in enumerate(tables)]
    if combine == "concat":
        return torch.cat(rows, dim=-1)
    acc_dtype = _acc_dtype(tables[0].dtype)
    acc = rows[0].to(acc_dtype)
    for row in rows[1:]:
        if combine == "mul":
            acc = acc * row.to(acc_dtype)
        else:
            acc = acc + row.to(acc_dtype)
    if combine == "mean":
        # the fp32 reciprocal rounded once, as the JAX reference writes it
        acc = acc * _recip(len(rows), acc_dtype)
    return acc.to(tables[0].dtype)


def _bag_ref(table: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
             mean: bool) -> torch.Tensor:
    """Plain bag pooling, JAX's ``_bag_ref``: positions accumulate
    l = 0..L-1 in fp32, a masked slot adds exactly 0.0 (the kernel skips
    it: the sum starts at +0.0, so the bits are the same), ``mean``
    divides by ``max(len, 1)``. ``ids`` must be in range (clamped)."""
    batch, bag = ids.shape
    acc_dtype = _acc_dtype(table.dtype)
    acc = torch.zeros((batch, table.shape[1]), dtype=acc_dtype,
                      device=table.device)
    for pos in range(bag):
        rows = table.index_select(0, ids[:, pos].long()).to(acc_dtype)
        acc = acc + torch.where((pos < lengths)[:, None], rows, 0.0)
    if mean:
        acc = acc / torch.clamp(lengths, min=1).to(acc_dtype)[:, None]
    return acc.to(table.dtype)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         offsets: torch.Tensor, mode: str = "sum"
                         ) -> torch.Tensor:
    """Offsets-form bags (torch ``EmbeddingBag`` convention): bag ``b``
    owns ``flat_ids[offsets[b]:offsets[b+1]]``. Plain PyTorch, as JAX's is
    plain ``segment_sum``: rows gathered under ``jnp.take``'s rule and
    summed per bag in fp32, empty bags give zeros, ``mean`` divides by
    ``max(count, 1)``. Ids past the last offset count in no bag."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    flat_ids = torch.as_tensor(flat_ids, device=table.device)
    offsets = torch.as_tensor(offsets, device=table.device).to(torch.int64)
    n_bags = int(offsets.shape[0]) - 1
    acc_dtype = _acc_dtype(table.dtype)
    # searchsorted(offsets[1:], i, side="right"), as the JAX function
    seg = torch.searchsorted(offsets[1:].contiguous(),
                             torch.arange(flat_ids.shape[0],
                                          device=table.device), right=True)
    rows = _take(table, flat_ids).to(acc_dtype)
    keep = seg < n_bags   # segment_sum drops ids of no bag
    pooled = torch.zeros((n_bags, table.shape[1]), dtype=acc_dtype,
                         device=table.device)
    pooled.index_add_(0, seg[keep], rows[keep])
    if mode == "mean":
        counts = (offsets[1:] - offsets[:-1]).to(acc_dtype)
        pooled = pooled / torch.clamp(counts, min=1.0)[:, None]
    return pooled.to(table.dtype)


# ---------------------------------------------- backward plain versions

def _fused_keys(col: torch.Tensor, vocab: int) -> torch.Tensor:
    """The row each id of one fused-lookup column scatters into:
    ``.at[ids].add``'s rule, negative ids wrap and ids outside
    ``[-V, V)`` get ``vocab`` (dropped)."""
    col = col.to(torch.int64)
    valid = (col >= -vocab) & (col < vocab)
    return torch.where(valid, torch.remainder(col, vocab),
                       vocab).to(torch.int32)


def _bag_keys(ids: torch.Tensor, lengths: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """The row each bag slot scatters into, flattened in (batch, slot)
    order: the id clamped into ``[0, V-1]`` (the forward read that row);
    masked slots get ``vocab`` (dropped: JAX adds +0.0 there, which leaves
    every bit of a sum that started at +0.0 as it was)."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    live = pos[None, :] < lengths[:, None]
    return torch.where(live, torch.clamp(ids, 0, vocab - 1),
                       vocab).to(torch.int32).reshape(-1)


def _scatter_ref(vocab: int, keys: torch.Tensor, updates: torch.Tensor,
                 bag: int = 1) -> torch.Tensor:
    """Zeros ``[vocab, d]`` in the updates' dtype, plus update
    ``updates[p // bag]`` at row ``keys[p]`` for every position ``p``
    whose key is below ``vocab``, each add rounded to the dtype (JAX's
    scatter-add into a zero table), in the kernel's fixed two-level order:

    - a row's run of n <= RUN_CHUNK updates is added in position order,
      starting from zero;
    - a longer run is cut into chunks of RUN_CHUNK from its start, each
      chunk summed in position order from zero, then the chunk sums added
      in chunk order from zero.

    The order depends on the inputs alone. Deterministic on any device:
    positions are stably sorted by row; round r adds the r-th update of
    every chunk (at most RUN_CHUNK rounds), then round k adds the k-th
    chunk sum of every row (at most ceil(n / RUN_CHUNK) rounds), and no
    chunk or row appears twice in a round."""
    out = torch.zeros((vocab, updates.shape[1]), dtype=updates.dtype,
                      device=updates.device)
    pos = torch.nonzero(keys < vocab).reshape(-1)
    if pos.numel() == 0:
        return out
    rows, order = torch.sort(keys[pos].to(torch.int64), stable=True)
    pos = pos[order]
    idx = torch.arange(rows.numel(), device=rows.device)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    in_chunk = rank % RUN_CHUNK
    # level 1: chunk sums, kept at the sorted index of each chunk's start
    partial = torch.zeros((rows.numel(), updates.shape[1]),
                          dtype=updates.dtype, device=updates.device)
    for sel in _rounds(in_chunk):
        head = idx[sel] - in_chunk[sel]
        partial[head] = partial[head] + updates[pos[sel] // bag]
    # level 2: each row's chunk sums in chunk order (one for a short run)
    heads = torch.nonzero(in_chunk == 0).reshape(-1)
    for sel in _rounds(rank[heads] // RUN_CHUNK):
        head = heads[sel]
        out[rows[head]] = out[rows[head]] + partial[head]
    return out


def _rounds(r: torch.Tensor):
    """Indices into ``r`` grouped by value, smallest value first, in
    index order within a group."""
    by_round = torch.argsort(r, stable=True)
    lo = 0
    for hi in torch.bincount(r).cumsum(0).tolist():
        if hi > lo:
            yield by_round[lo:hi]
        lo = hi


def _fused_updates(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   g: torch.Tensor, combine: str, i: int) -> torch.Tensor:
    """Table ``i``'s update per batch row, as JAX's ``_fused_bwd`` makes
    it (``mean`` as autodiff of ``_fused_ref``: ``g · fl(1/n)``)."""
    t = tables[i]
    if combine == "concat":
        off = sum(int(s.shape[1]) for s in tables[:i])
        return g[:, off:off + t.shape[1]].to(t.dtype)
    acc_dtype = _acc_dtype(t.dtype)
    u = g.to(acc_dtype)
    if combine == "mean":
        u = u * _recip(len(tables), acc_dtype)
    elif combine == "mul":
        for j, other in enumerate(tables):
            if j != i:
                u = u * _take(other, ids[:, j]).to(acc_dtype)
    return u.to(t.dtype)


def _fused_bwd_ref(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   g: torch.Tensor, combine: str,
                   needs: Optional[Sequence[bool]] = None
                   ) -> Tuple[Optional[torch.Tensor], ...]:
    """Plain backward of the fused lookup: each table's gradient, a
    scatter-add of its updates into a zero table in batch order (None
    where ``needs`` says it is not wanted)."""
    grads = []
    for i, t in enumerate(tables):
        if needs is not None and not needs[i]:
            grads.append(None)
            continue
        grads.append(_scatter_ref(int(t.shape[0]),
                                  _fused_keys(ids[:, i], int(t.shape[0])),
                                  _fused_updates(tables, ids, g, combine, i)))
    return tuple(grads)


def _bag_updates(g: torch.Tensor, lengths: torch.Tensor, dtype: torch.dtype,
                 mean: bool) -> torch.Tensor:
    """Each bag's update, JAX's ``_bag_bwd``: ``g`` in fp32, divided by
    ``max(len, 1)`` for ``mean``, in the table's dtype."""
    acc_dtype = _acc_dtype(dtype)
    u = g.to(acc_dtype)
    if mean:
        u = u / torch.clamp(lengths, min=1).to(acc_dtype)[:, None]
    return u.to(dtype)


def _bag_bwd_ref(vocab: int, dtype: torch.dtype, ids: torch.Tensor,
                 lengths: torch.Tensor, g: torch.Tensor,
                 mean: bool) -> torch.Tensor:
    """Plain backward of the bag: the table's gradient, its updates
    scattered in (batch, slot) order, masked slots skipped."""
    return _scatter_ref(vocab, _bag_keys(ids, lengths, vocab),
                        _bag_updates(g, lengths, dtype, mean),
                        bag=int(ids.shape[1]))


# ----------------------------------------------------------------- kernels

class _FusedArgs(ctypes.Structure):
    """By-value argument block of ``zoo_fused_lookup`` (``FusedArgs`` in
    csrc/embedding_bag.cu)."""
    _fields_ = [("table", ctypes.c_void_p * MAX_TABLES),
                ("vocab", ctypes.c_longlong * MAX_TABLES),
                ("dim", ctypes.c_int * MAX_TABLES),
                ("offset", ctypes.c_int * MAX_TABLES),
                ("n_tables", ctypes.c_int),
                ("d_out", ctypes.c_int),
                ("combine", ctypes.c_int),
                ("is_bf16", ctypes.c_int),
                ("inv_n", ctypes.c_float)]


class _ScatterArgs(ctypes.Structure):
    """By-value argument block of ``zoo_embedding_scatter_add``
    (``ScatterArgs`` in csrc/embedding_bag.cu)."""
    _fields_ = [("table", ctypes.c_void_p * MAX_TABLES),
                ("vocab", ctypes.c_longlong * MAX_TABLES),
                ("ids", ctypes.c_void_p),
                ("lengths", ctypes.c_void_p),
                ("n_tables", ctypes.c_int),
                ("target", ctypes.c_int),
                ("bag", ctypes.c_int),
                ("g_stride", ctypes.c_int),
                ("g_offset", ctypes.c_int),
                ("dim", ctypes.c_int),
                ("inv_n", ctypes.c_float)]


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("embedding_bag")
        lib.zoo_fused_lookup.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_FusedArgs), ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.zoo_fused_lookup.restype = ctypes.c_int
        lib.zoo_embedding_bag.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        lib.zoo_embedding_bag.restype = ctypes.c_int
        lib.zoo_embedding_scatter_add.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.POINTER(_ScatterArgs), ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.zoo_embedding_scatter_add.restype = ctypes.c_int
        lib.zoo_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.zoo_empty_launch.restype = ctypes.c_int
        lib.zoo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zoo_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.zoo_cuda_error_string(err).decode())


def _check_kernel_tables(tables: Sequence[torch.Tensor], what: str) -> None:
    dtype = tables[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what} kernel takes float32/bfloat16 tables, got "
                        f"{dtype}")
    if len(tables) > MAX_TABLES:
        raise ValueError(f"{what} kernel takes at most {MAX_TABLES} tables, "
                         f"got {len(tables)}")
    for t in tables:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous tables")


_args_cache: Dict[tuple, _FusedArgs] = {}
_args_lock = threading.Lock()


def _fused_args(tables: Sequence[torch.Tensor], combine: str) -> _FusedArgs:
    """The lookup's argument block for these tables and ``combine``, built
    once and kept. The key holds everything the block holds (each table's
    address, rows and width, the dtype and the combine), so a table freed
    and reallocated at the same address with the same shape gets an equal
    block. At most ARGS_CACHE_SIZE blocks are kept: past it the oldest
    goes. Lookups are lock-free; inserts take a lock, so serving threads
    may call at once. A block is never written after it is cached."""
    key = (combine, tables[0].dtype,
           *[(t.data_ptr(), t.shape) for t in tables])
    args = _args_cache.get(key)
    if args is not None:
        return args
    args = _FusedArgs()
    args.n_tables = len(tables)
    off = 0
    for i, t in enumerate(tables):
        args.table[i] = t.data_ptr()
        args.vocab[i] = int(t.shape[0])
        args.dim[i] = int(t.shape[1])
        args.offset[i] = off
        off += int(t.shape[1])
    args.d_out = off if combine == "concat" else int(tables[0].shape[1])
    args.combine = _COMBINE_CODE[combine]
    args.is_bf16 = int(tables[0].dtype == torch.bfloat16)
    args.inv_n = _recip(len(tables), torch.float32)
    with _args_lock:
        while len(_args_cache) >= ARGS_CACHE_SIZE:
            _args_cache.pop(next(iter(_args_cache)))
        _args_cache[key] = args
    return args


def _fused_cuda(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                combine: str) -> torch.Tensor:
    """Launch the fused lookup kernel on the tables' device and its current
    stream: ``ids`` int32 ``[batch, n_tables]``, contiguous, on that device
    (the public function makes them so)."""
    _check_kernel_tables(tables, "fused lookup")
    args = _fused_args(tables, combine)
    out = tables[0].new_empty((ids.shape[0], args.d_out))
    if out.numel() == 0:
        return out
    index = tables[0].get_device()
    lib = _lib()
    err = lib.zoo_fused_lookup(ids.data_ptr(), ctypes.byref(args),
                               out.data_ptr(), out.shape[0], index,
                               _build.raw_stream(index))
    _check_launch(lib, err, "fused lookup")
    launches.add()
    return out


def _bag_cuda(table: torch.Tensor, ids: torch.Tensor,
              lengths: Optional[torch.Tensor], mean: bool) -> torch.Tensor:
    """Launch the bag kernel on the table's device and its current stream:
    ``ids`` int32 ``[batch, bag]``, contiguous, on that device, as they
    come (the kernel clamps each id it reads into ``[0, V-1]``);
    ``lengths`` int32 ``[batch]``, contiguous, or None for full bags."""
    if table.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"embedding bag kernel takes float32/bfloat16 "
                        f"tables, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("embedding bag kernel needs contiguous tables")
    batch, bag = ids.shape
    out = table.new_empty((batch, table.shape[1]))
    if out.numel() == 0:
        return out
    index = table.get_device()
    lib = _lib()
    err = lib.zoo_embedding_bag(
        ids.data_ptr(), None if lengths is None else lengths.data_ptr(),
        table.data_ptr(), table.shape[0], table.shape[1], batch, bag, mean,
        table.dtype == torch.bfloat16, out.data_ptr(), index,
        _build.raw_stream(index))
    _check_launch(lib, err, "embedding bag")
    bag_launches.add()
    return out


def _scatter_launch(out: torch.Tensor, sorted_keys: torch.Tensor,
                    perm: torch.Tensor, g: torch.Tensor, args: _ScatterArgs,
                    combine: int, scale: int) -> torch.Tensor:
    """One launch of the scatter kernel (its two passes, one count) into
    ``out`` (zero-filled ``[vocab, dim]``): ``sorted_keys`` int32 and
    ``perm`` int64 from a stable sort of the positions' rows. The chunk
    sums of long runs go through a scratch ``[n_pos, dim]`` of the table's
    dtype."""
    n_pos = int(sorted_keys.numel())
    if n_pos == 0 or out.shape[1] == 0:
        return out
    args.dim = int(out.shape[1])
    partial = torch.empty((n_pos, args.dim), dtype=out.dtype,
                          device=out.device)
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.zoo_embedding_scatter_add(
            sorted_keys.data_ptr(), perm.data_ptr(), n_pos, g.data_ptr(),
            ctypes.byref(args), out.data_ptr(), int(out.shape[0]), combine,
            scale, int(out.dtype == torch.bfloat16), partial.data_ptr(),
            stream)
    _check_launch(lib, err, "embedding scatter-add")
    scatter_launches.add()
    return out


def _fused_scatter_plan(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                        g: torch.Tensor, combine: str, i: int):
    """(keys, args, combine code, scale code) of table ``i``'s gradient;
    ``ids`` int32 and ``g`` contiguous in the tables' dtype, both kept
    alive by the caller while ``args`` points at them."""
    args = _ScatterArgs()
    args.n_tables = len(tables)
    for j, s in enumerate(tables):
        args.table[j] = s.data_ptr()
        args.vocab[j] = int(s.shape[0])
    args.ids = ids.data_ptr()
    args.target = i
    args.bag = 1
    args.g_stride = int(g.shape[1])
    args.g_offset = sum(int(s.shape[1]) for s in tables[:i]) \
        if combine == "concat" else 0
    args.inv_n = _recip(len(tables), torch.float32)
    keys = _fused_keys(ids[:, i], int(tables[i].shape[0]))
    return (keys, args, _SCATTER_MUL if combine == "mul" else _SCATTER_COPY,
            _SCALE_RECIP if combine == "mean" else _SCALE_NONE)


def _bag_scatter_plan(vocab: int, ids: torch.Tensor, lengths: torch.Tensor,
                      g: torch.Tensor, mean: bool):
    """(keys, args, combine code, scale code) of the bag's gradient;
    ``lengths`` int32 and ``g`` contiguous, kept alive by the caller."""
    args = _ScatterArgs()
    args.lengths = lengths.data_ptr()
    args.bag = int(ids.shape[1])
    args.g_stride = int(g.shape[1])
    return (_bag_keys(ids, lengths, vocab), args, _SCATTER_COPY,
            _SCALE_LENGTH if mean else _SCALE_NONE)


def _scatter_cuda(vocab: int, dim: int, dtype: torch.dtype, g: torch.Tensor,
                  plan) -> torch.Tensor:
    """One gradient table: the positions stably sorted by row (a library
    sort), a zero table, one scatter launch."""
    keys, args, combine, scale = plan
    out = torch.zeros((vocab, dim), dtype=dtype, device=g.device)
    sorted_keys, perm = torch.sort(keys, stable=True)
    return _scatter_launch(out, sorted_keys, perm, g, args, combine, scale)


def _fused_bwd_cuda(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                    g: torch.Tensor, combine: str,
                    needs: Optional[Sequence[bool]] = None
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """The fused lookup's backward on the card: one scatter launch per
    table that needs its gradient."""
    _check_kernel_tables(tables, "embedding scatter-add")
    g = g.to(tables[0].dtype).contiguous()
    ids = ids.to(torch.int32).contiguous()
    return tuple(
        None if needs is not None and not needs[i] else
        _scatter_cuda(int(t.shape[0]), int(t.shape[1]), t.dtype, g,
                      _fused_scatter_plan(tables, ids, g, combine, i))
        for i, t in enumerate(tables))


def _bag_bwd_cuda(vocab: int, dtype: torch.dtype, ids: torch.Tensor,
                  lengths: torch.Tensor, g: torch.Tensor,
                  mean: bool) -> torch.Tensor:
    """The bag's backward on the card: one scatter launch."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"embedding scatter-add kernel takes float32/"
                        f"bfloat16 tables, got {dtype}")
    g = g.to(dtype).contiguous()
    lengths = lengths.contiguous()
    return _scatter_cuda(vocab, int(g.shape[1]), dtype, g,
                         _bag_scatter_plan(vocab, ids, lengths, g, mean))


# -------------------------------------------------------------- forwards

def _fused_forward(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   combine: str) -> torch.Tensor:
    """The lookup without autograd: the plain version for tables on the
    CPU, the kernel for any other (the public function admits only CUDA
    besides the CPU)."""
    if tables[0].is_cpu:
        return _fused_ref(tables, ids, combine)
    return _fused_cuda(tables, ids, combine)


def _bag_forward(table: torch.Tensor, ids: torch.Tensor,
                 lengths: Optional[torch.Tensor], mean: bool) -> torch.Tensor:
    """The bag without autograd, from int32 ids as they come. On the CPU in
    JAX's order: the ids clamped into ``[0, V-1]`` (the Pallas kernel's
    index_map fetches every slot's row before the mask applies), full
    lengths for None, then the plain version. Off the CPU the kernel, which
    clamps each id it reads and takes None as full bags."""
    if not table.is_cpu:
        return _bag_cuda(table, ids, lengths, mean)
    if lengths is None:
        lengths = torch.full((ids.shape[0],), ids.shape[1],
                             dtype=torch.int32)
    return _bag_ref(table, torch.clamp(ids, 0, table.shape[0] - 1), lengths,
                    mean)


# ------------------------------------------------------- autograd Functions

def _fused_flops(combine: str, batch: int, widths: Sequence[int],
                 needs: Optional[Sequence[bool]] = None) -> int:
    """The fused lookup's count while a step is counted
    (``profiling.counted``): forward (``needs`` None) the combine's
    elementwise ops on ``[batch, width]``; backward the scatter-add's
    updates into each table that needs a gradient, with ``mul``'s
    products of the other rows and ``mean``'s scale."""
    t, w = len(widths), batch * int(widths[0])
    if needs is None:
        if combine == "concat":
            return 0
        return (t - 1) * w + (w if combine == "mean" else 0)
    extra = {"mean": w, "mul": (t - 1) * w}.get(combine, 0)
    return sum(batch * int(d) + extra for d, n in zip(widths, needs) if n)


def _bag_flops(mean: bool, ids: torch.Tensor, width: int) -> int:
    """The bag's count a pass: its adds over every slot, ``mean``'s
    division a bag."""
    b, n = int(ids.shape[0]), int(ids.shape[1])
    return b * n * width + (b * width if mean else 0)


class _FusedLookup(torch.autograd.Function):
    """The fused lookup with its scatter-add backward: kernels on CUDA,
    plain versions on the CPU."""

    @staticmethod
    def forward(ctx, combine: str, ids: torch.Tensor, *tables: torch.Tensor):
        ctx.combine = combine
        ctx.save_for_backward(ids, *tables)
        widths = [t.shape[1] for t in tables]
        with profiling.counted(lambda: _fused_flops(
                combine, ids.shape[0], widths)):
            return _fused_forward(tables, ids, combine)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ids, *tables = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        bwd = _fused_bwd_cuda if g.is_cuda else _fused_bwd_ref
        widths = [t.shape[1] for t in tables]
        with profiling.counted(lambda: _fused_flops(
                ctx.combine, ids.shape[0], widths, needs)):
            return (None, None, *bwd(tables, ids, g, ctx.combine, needs))


class _Bag(torch.autograd.Function):
    """The bag with its scatter-add backward: kernels on CUDA, plain
    versions on the CPU. Saves the ids as they come; the backward's keys
    clamp them (``_bag_keys``)."""

    @staticmethod
    def forward(ctx, mean: bool, table: torch.Tensor, ids: torch.Tensor,
                lengths: Optional[torch.Tensor]):
        ctx.mean = mean
        ctx.vocab = int(table.shape[0])
        ctx.dtype = table.dtype
        ctx.save_for_backward(ids, lengths)
        with profiling.counted(lambda: _bag_flops(mean, ids,
                                                  table.shape[1])):
            return _bag_forward(table, ids, lengths, mean)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        ids, lengths = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        with profiling.counted(lambda: _bag_flops(ctx.mean, ids,
                                                  g.shape[1])):
            if lengths is None:
                lengths = torch.full((ids.shape[0],), ids.shape[1],
                                     dtype=torch.int32, device=ids.device)
            bwd = _bag_bwd_cuda if g.is_cuda else _bag_bwd_ref
            return (None, bwd(ctx.vocab, ctx.dtype, ids, lengths, g,
                              ctx.mean), None, None)


# ------------------------------------------------------------- dispatchers

def _on_kernel_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {dev}")


def fused_embedding_lookup(tables: Sequence[torch.Tensor],
                           ids: Union[torch.Tensor, np.ndarray],
                           combine: str = "concat",
                           use_kernel: Optional[bool] = None,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> torch.Tensor:
    """N-table fused lookup: ``ids[b, t]`` indexes ``tables[t]``; rows
    combine via ``concat`` (mixed widths ok) / ``sum`` / ``mean`` / ``mul``
    (equal widths). Ids are cast to int32 by truncation, as
    ``astype(int32)`` does. ``device`` defaults to the tables' device and,
    when given, must be it; ids move there. CPU tensors run the plain
    version, CUDA tensors the kernel; gradients reach the tables through
    the scatter-add backward. Without a gradient to keep (grad mode off, or
    no table that requires grad) the call skips autograd: int32 ids on the
    tables' device make it one kernel launch. ``use_kernel``: see the
    module's note."""
    if combine not in _COMBINES:
        raise ValueError(f"unknown combine {combine!r}; one of {_COMBINES}")
    tables = tuple(tables)
    if not tables:
        raise ValueError("fused lookup needs at least one table")
    first = tables[0]
    dev = first.device
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"tables live on {dev}, not {want}")
    dtype = first.dtype
    for t in tables:
        if t.ndim != 2 or t.dtype != dtype or (t is not first
                                               and t.device != dev):
            raise ValueError("tables must be 2-D, of one dtype, on one "
                             "device")
    if combine != "concat":
        width = first.shape[1]
        for t in tables:
            if t.shape[1] != width:
                raise ValueError(f"combine={combine!r} needs equal widths, "
                                 f"got {[int(t.shape[1]) for t in tables]}")
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(ids)
    if ids.ndim != 2 or ids.shape[1] != len(tables):
        raise ValueError(f"ids {tuple(ids.shape)} vs {len(tables)} tables")
    _on_kernel_device(dev, "fused lookup")
    _build.check_use_kernel(dev, use_kernel, "fused lookup")
    if ids.dtype != torch.int32 or ids.device != dev:
        ids = ids.to(device=dev, dtype=torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return _FusedLookup.apply(combine, ids, *tables)
    return _fused_forward(tables, ids, combine)


def embedding_bag(table: torch.Tensor, ids: Union[torch.Tensor, np.ndarray],
                  lengths: Union[torch.Tensor, np.ndarray, None] = None,
                  mode: str = "sum", use_kernel: Optional[bool] = None
                  ) -> torch.Tensor:
    """Pooled multi-hot lookup: ``ids`` ``[batch, bag]`` rows of ``table``
    summed (or averaged) per bag. ``lengths`` ``[batch]`` marks the valid
    prefix of each bag (None: all valid); empty bags give exact zeros
    (``mean`` included). Ids are cast to int32 by truncation and clamped
    into ``[0, V-1]``; slots past the valid length are never read. The
    result has the table's dtype. CPU tensors run the plain version, CUDA
    tensors the kernel; the gradient reaches the table through the
    scatter-add backward. Without a gradient to keep (grad mode off, or a
    table that does not require grad) the call skips autograd: int32 ids
    on the table's device and no lengths make it one kernel launch.
    ``use_kernel``: see the module's note."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D, got {tuple(table.shape)}")
    if table.shape[0] == 0:
        raise ValueError("embedding bag over an empty table")
    dev = table.device
    _on_kernel_device(dev, "embedding bag")
    _build.check_use_kernel(dev, use_kernel, "embedding bag")
    if not isinstance(ids, torch.Tensor) or ids.device != dev:
        ids = torch.as_tensor(ids, device=dev)
    if ids.ndim != 2:
        raise ValueError(f"ids must be [batch, bag], got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        ids = ids.to(torch.int32)
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if lengths is not None:
        if not isinstance(lengths, torch.Tensor) or lengths.device != dev:
            lengths = torch.as_tensor(lengths, device=dev)
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        if lengths.shape != (ids.shape[0],):
            raise ValueError(f"lengths {tuple(lengths.shape)} vs batch "
                             f"{ids.shape[0]}")
        if not lengths.is_contiguous():
            lengths = lengths.contiguous()
    mean = mode == "mean"
    if torch.is_grad_enabled() and table.requires_grad:
        return _Bag.apply(mean, table, ids, lengths)
    return _bag_forward(table, ids, lengths, mean)


# ------------------------------------------------------------ autotuning

def _shapes_key(kind: str, shapes, extra: str, dtype) -> str:
    """JAX's key for a lookup or bag signature, under the port's platform
    tag."""
    from analytics_zoo_tpu_torch.ops import autotune
    dims = "+".join(f"{v}x{d}" for v, d in shapes)
    return (f"embedding_bag|{autotune._platform()}|{kind}|{extra}"
            f"|{dims}|{autotune.dtype_name(dtype)}")


def _card_only(fn):
    """A tuning candidate that launches a kernel: on a CPU tensor it
    raises, as JAX's Pallas candidates fail off the TPU."""
    def run(*args):
        if not args[-1].is_cuda:
            raise RuntimeError("the kernel runs only on a card")
        return fn(*args)
    return run


def tune_fused_lookup(table_shapes: Sequence[Tuple[int, int]], batch: int,
                      combine: str = "concat", dtype=torch.float32,
                      iters: Optional[int] = None) -> dict:
    """Time the fused lookup kernel against its plain version on seeded
    tables and ids at one signature, on the card, and persist JAX's
    record. The public function launches the kernel on a CUDA tensor
    whatever the verdict says."""
    from analytics_zoo_tpu_torch.ops import autotune
    dev = torch.device("cuda" if autotune.kernels_available() else "cpu")
    gen = torch.Generator().manual_seed(0)
    tables = tuple(torch.randn((v, d), generator=gen).to(dev, dtype)
                   for v, d in table_shapes)
    ids = torch.stack([torch.randint(0, v, (batch,), generator=gen)
                       for v, _ in table_shapes], 1).to(dev, torch.int32)
    return autotune.get_tuner().tune(
        "embedding_bag",
        _shapes_key("fused", table_shapes, f"{combine}.b{batch}", dtype),
        {"cuda": _card_only(lambda ts, ii: _fused_cuda(ts, ii, combine))},
        lambda ts, ii: _fused_ref(ts, ii, combine),
        (tables, ids), iters=iters)


def tune_bag(vocab: int, dim: int, batch: int, bag: int,
             mode: str = "sum", dtype=torch.float32,
             iters: Optional[int] = None) -> dict:
    """The bag kernel against its plain version, as ``tune_fused_lookup``,
    on seeded ids in range and lengths in ``[0, bag]``."""
    from analytics_zoo_tpu_torch.ops import autotune
    dev = torch.device("cuda" if autotune.kernels_available() else "cpu")
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((vocab, dim), generator=gen).to(dev, dtype)
    ids = torch.randint(0, vocab, (batch, bag), generator=gen)
    lengths = torch.randint(0, bag + 1, (batch,), generator=gen)
    mean = mode == "mean"
    return autotune.get_tuner().tune(
        "embedding_bag",
        _shapes_key("bag", [(vocab, dim)], f"{mode}.b{batch}l{bag}", dtype),
        {"cuda": _card_only(lambda t, n, i: _bag_cuda(t, i, n, mean))},
        lambda t, n, i: _bag_ref(t, i, n, mean),
        (table, lengths.to(dev, torch.int32), ids.to(dev, torch.int32)),
        iters=iters)
