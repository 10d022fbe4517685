"""Fused embedding lookup for the recsys path, in PyTorch and CUDA.

Counterpart of ``analytics_zoo_tpu/ops/embedding_bag.py``:

- ``embedding_lookup`` — one table, ``table[ids]`` with ``jnp.take``'s
  rule for ids out of range.
- ``fused_embedding_lookup`` — N tables, one id column per table
  (``ids[b, t]`` indexes table ``t``), rows combined per ``concat`` /
  ``sum`` / ``mean`` / ``mul``. On a CUDA tensor it launches the kernel
  of ``csrc/embedding_bag.cu`` (which replaces the Pallas
  ``_fused_lookup_kernel``) or raises; the plain version ``_fused_ref``
  runs only for tensors on the CPU. There is no autotuner here.

The plain version accumulates in the kernel's order and precision, so the
two agree bitwise. Ids follow ``jnp.take`` (the JAX reference's gather):
ids in ``[-V, V)`` index the table, negative ones wrapping, and any other
id gives a NaN row. The kernel does the same and never reads outside a
table. Training (the backward scatter-add) and the multi-hot
``embedding_bag`` are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.ops import _build

_COMBINES = ("concat", "sum", "mean", "mul")
_COMBINE_CODE = {"concat": 0, "sum": 1, "mean": 2, "mul": 3}
MAX_TABLES = 8
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: launches of the CUDA kernel (the plain version never counts)
launches = _build.launch_counter("fused_embedding_lookup")


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


# ------------------------------------------------------------- reference

def _fused_ref(tables: Sequence[torch.Tensor], ids: torch.Tensor,
               combine: str) -> torch.Tensor:
    """Plain fused lookup, accumulation order mirroring the kernel: rows
    combine left to right in fp32 (except concat, which never
    accumulates), result in the tables' dtype."""
    rows = [_take(t, ids[:, i]) for i, t in enumerate(tables)]
    if combine == "concat":
        return torch.cat(rows, dim=-1)
    acc = rows[0].to(torch.float32)
    for row in rows[1:]:
        if combine == "mul":
            acc = acc * row.to(torch.float32)
        else:
            acc = acc + row.to(torch.float32)
    if combine == "mean":
        # the fp32 reciprocal rounded once, as the JAX reference writes it
        acc = acc * float(np.float32(1.0 / len(rows)))
    return acc.to(tables[0].dtype)


# ----------------------------------------------------------------- kernel

class _FusedArgs(ctypes.Structure):
    """By-value argument block of ``zoo_fused_lookup`` (``FusedArgs`` in
    csrc/embedding_bag.cu)."""
    _fields_ = [("table", ctypes.c_void_p * MAX_TABLES),
                ("vocab", ctypes.c_longlong * MAX_TABLES),
                ("dim", ctypes.c_int * MAX_TABLES),
                ("offset", ctypes.c_int * MAX_TABLES),
                ("n_tables", ctypes.c_int),
                ("d_out", ctypes.c_int)]


_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("embedding_bag")
        lib.zoo_fused_lookup.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_FusedArgs), ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        lib.zoo_fused_lookup.restype = ctypes.c_int
        lib.zoo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.zoo_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _fused_cuda(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                combine: str) -> torch.Tensor:
    """Launch the CUDA kernel on the tensors' device and current stream."""
    dev = tables[0].device
    dtype = tables[0].dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused lookup kernel takes float32/bfloat16 "
                        f"tables, got {dtype}")
    if len(tables) > MAX_TABLES:
        raise ValueError(f"fused lookup kernel takes at most {MAX_TABLES} "
                         f"tables, got {len(tables)}")
    for t in tables:
        if not t.is_contiguous():
            raise ValueError("fused lookup kernel needs contiguous tables")
    dims = [int(t.shape[1]) for t in tables]
    d_out = sum(dims) if combine == "concat" else dims[0]
    batch = int(ids.shape[0])
    ids = ids.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((batch, d_out), dtype=dtype, device=dev)
    if batch == 0 or d_out == 0:
        return out
    args = _FusedArgs()
    args.n_tables = len(tables)
    args.d_out = d_out
    off = 0
    for i, t in enumerate(tables):
        args.table[i] = t.data_ptr()
        args.vocab[i] = int(t.shape[0])
        args.dim[i] = dims[i]
        args.offset[i] = off
        off += dims[i]
    inv_n = float(np.float32(1.0 / len(tables)))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zoo_fused_lookup(
            ids.data_ptr(), ctypes.byref(args), out.data_ptr(), batch,
            _COMBINE_CODE[combine], int(dtype == torch.bfloat16), inv_n,
            stream)
    if err != 0:
        raise RuntimeError("fused lookup kernel launch failed: "
                           + lib.zoo_cuda_error_string(err).decode())
    launches.add()
    return out


# ------------------------------------------------------------- dispatcher

def fused_embedding_lookup(tables: Sequence[torch.Tensor],
                           ids: Union[torch.Tensor, np.ndarray],
                           combine: str = "concat",
                           device: Optional[Union[str, torch.device]] = None
                           ) -> torch.Tensor:
    """N-table fused lookup: ``ids[b, t]`` indexes ``tables[t]``; rows
    combine via ``concat`` (mixed widths ok) / ``sum`` / ``mean`` / ``mul``
    (equal widths). Ids are cast to int32 by truncation, as
    ``astype(int32)`` does. ``device`` defaults to the tables' device and,
    when given, must be it; ids move there. CPU tensors run the plain
    version, CUDA tensors the kernel."""
    if combine not in _COMBINES:
        raise ValueError(f"unknown combine {combine!r}; one of {_COMBINES}")
    tables = tuple(tables)
    if not tables:
        raise ValueError("fused lookup needs at least one table")
    dev = tables[0].device
    want = None if device is None else torch.device(device)
    if want is not None and (want.type != dev.type or want.index not in (
            None, dev.index)):
        raise ValueError(f"tables live on {dev}, not {want}")
    for t in tables:
        if t.ndim != 2 or t.device != dev or t.dtype != tables[0].dtype:
            raise ValueError("tables must be 2-D, of one dtype, on one "
                             "device")
    if combine != "concat" and len({int(t.shape[1]) for t in tables}) != 1:
        raise ValueError(f"combine={combine!r} needs equal widths, got "
                         f"{[int(t.shape[1]) for t in tables]}")
    ids = torch.as_tensor(ids)
    if ids.ndim != 2 or ids.shape[1] != len(tables):
        raise ValueError(f"ids {tuple(ids.shape)} vs {len(tables)} tables")
    if dev.type == "cpu":
        return _fused_ref(tables, ids.to(torch.int32), combine)
    if dev.type == "cuda":
        return _fused_cuda(tables, ids, combine)
    raise ValueError(f"no fused lookup for device {dev}")
