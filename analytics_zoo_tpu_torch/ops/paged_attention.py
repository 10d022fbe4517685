"""Paged decode kernels: read K/V straight from the shared page pool.

Counterpart of ``analytics_zoo_tpu/ops/paged_attention.py``. The step-level
decode scheduler (inference/decode_scheduler.py) keeps every live
sequence's context in fixed-size pages of one pool; these functions read
that pool through a per-sequence page table.

- ``paged_gather`` — ``[n_pages, page_size, dim]`` pool + ``[batch,
  width]`` page table + ``[batch]`` lengths → ``[batch, out_len, dim]``
  float32 step buffer with exact zeros at positions >= length. On a CUDA
  tensor it launches ``paged_gather_kernel`` of ``csrc/paged_attention.cu``
  (which replaces the Pallas ``_gather_kernel``) or raises; the plain
  version ``_gather_ref_core`` runs only for tensors on the CPU. The two
  are bitwise equal, and equal to JAX's ``_gather_ref_core``.
- ``paged_attention`` — single-token decode attention of ``q`` over paged
  K/V: ``paged_attention_kernel`` (replaces ``_attn_kernel``) on CUDA,
  ``paged_attention_ref`` (JAX's two-pass dense softmax) on the CPU; the
  two agree within fp32 rounding of the online softmax.

Pools are float32, or int8 with one float32 scale per page
(``ZOO_KV_DTYPE=int8``, inference/quantize.py); both dequantize as
``x.float() * scale[page]``. Table entries are clamped into ``[0,
n_pages)`` as JAX clamps them. There is no autotuner yet (ROADMAP A9):
the tensors' device picks the route, and ``use_kernel=`` and the tuning
keys wait for it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from analytics_zoo_tpu_torch.ops import _build

NEG_INF = -1e30
_POOL_DTYPES = (torch.float32, torch.int8)
MAX_ATTN_DIM = 1024

#: launches of the CUDA kernels (the plain versions never count)
gather_launches = _build.launch_counter("paged_gather")
attention_launches = _build.launch_counter("paged_attention")


def _scales_or_ones(scales, n_pages: int, device) -> torch.Tensor:
    if scales is None:
        return torch.ones((n_pages,), dtype=torch.float32, device=device)
    return torch.as_tensor(scales).to(device=device, dtype=torch.float32)


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.int32)


# ------------------------------------------------------------- reference

def _gather_ref_core(pool: torch.Tensor, table: torch.Tensor,
                     lengths: torch.Tensor, scales: torch.Tensor,
                     quantized: bool) -> torch.Tensor:
    """Plain gather, JAX's ``_gather_ref_core`` step for step: take pages
    (``table`` already clamped), widen to float32, dequantize (int8 only),
    zero the causal tail. Output ``[batch, width*page_size, dim]``."""
    batch, width = table.shape
    ps = pool.shape[1]
    idx = table.long()
    rows = pool[idx].to(torch.float32)                    # [b, w, ps, d]
    if quantized:
        rows = rows * scales[idx][:, :, None, None]
    rows = rows.reshape(batch, width * ps, -1)
    pos = torch.arange(width * ps, device=pool.device)
    live = pos[None, :] < lengths.to(torch.int64)[:, None]
    return torch.where(live[:, :, None], rows,
                       torch.zeros((), device=pool.device))


def paged_attention_ref(q, k_pool, v_pool, table, lengths, *,
                        k_scales=None, v_scales=None, softmax_scale=None
                        ) -> torch.Tensor:
    """Reference (JAX's ``paged_attention_ref``): gather K/V pages
    (dequantizing per-page scales), mask positions >= length, fp32
    softmax in two passes, weighted sum over V."""
    q = torch.as_tensor(q).to(torch.float32)
    d = q.shape[-1]
    sc = torch.tensor(softmax_scale if softmax_scale is not None
                      else 1.0 / math.sqrt(d), dtype=torch.float32)
    k = paged_gather_ref(k_pool, table, lengths, scales=k_scales)
    v = paged_gather_ref(v_pool, table, lengths, scales=v_scales)
    s = torch.einsum("bd,bnd->bn", q, k) * sc.to(q.device)
    lengths = _index(lengths, q.device)
    live = torch.arange(s.shape[1], device=q.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=1, keepdim=True)
    w = torch.where(live, torch.exp(s - m), torch.zeros((), device=q.device))
    denom = w.sum(dim=1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones((), device=q.device), denom)
    out = torch.einsum("bn,bnd->bd", w, v)
    return out / denom


# ---------------------------------------------------------------- kernels

_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zoo_paged_gather.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.zoo_paged_gather.restype = i32
        lib.zoo_paged_attention.argtypes = (
            [ptr] * 8 + [i32] * 5 + [ctypes.c_float, i32, ptr])
        lib.zoo_paged_attention.restype = i32
        lib.zoo_cuda_error_string.argtypes = [i32]
        lib.zoo_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check_pool(name: str, pool: torch.Tensor) -> None:
    if pool.dtype not in _POOL_DTYPES:
        raise TypeError(
            f"paged kernels take float32 or int8 {name}s, got {pool.dtype} "
            "(other KV dtypes wait for ROADMAP A8)")
    if pool.ndim != 3 or not pool.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [n_pages, page_size,"
                         f" dim] tensor, got {tuple(pool.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().zoo_cuda_error_string(err).decode())


def _gather_cuda(pool, table, lengths, scales, out_len: int):
    """Launch ``paged_gather_kernel`` on the pool's device and current
    stream."""
    _check_pool("pool", pool)
    dev = pool.device
    batch, width = table.shape
    n_pages, ps, dim = (int(s) for s in pool.shape)
    out = torch.empty((batch, out_len, dim), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.zoo_paged_gather(
            pool.data_ptr(), scales.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), batch, width, ps, dim,
            n_pages, out_len, int(pool.dtype == torch.int8),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged gather")
    gather_launches.add()
    return out


def _attention_cuda(q, k_pool, v_pool, table, lengths, k_scales, v_scales,
                    softmax_scale: float):
    """Launch ``paged_attention_kernel`` on the pools' device and current
    stream."""
    _check_pool("k_pool", k_pool)
    _check_pool("v_pool", v_pool)
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError("k_pool and v_pool must share shape and dtype")
    dev = k_pool.device
    batch, width = table.shape
    n_pages, ps, dim = (int(s) for s in k_pool.shape)
    if dim > MAX_ATTN_DIM:
        raise ValueError(f"paged attention kernel takes dim <= "
                         f"{MAX_ATTN_DIM}, got {dim}")
    out = torch.empty((batch, dim), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.zoo_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), batch, width, ps, dim,
            n_pages, float(softmax_scale), int(k_pool.dtype == torch.int8),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "paged attention")
    attention_launches.add()
    return out


# ------------------------------------------------------------ dispatchers

def paged_gather(pool, table, lengths, scales=None,
                 out_len: Optional[int] = None) -> torch.Tensor:
    """Assemble the wide decode step buffer straight from the page pool.

    ``pool`` ``[n_pages, page_size, dim]`` (float32, or int8 with per-page
    ``scales``), ``table`` ``[batch, width]`` int32 page ids, ``lengths``
    ``[batch]`` int32 → ``[batch, out_len, dim]`` float32 with exact zeros
    at positions >= length. ``out_len`` defaults to ``width*page_size``
    and may only shrink it. ``table`` and ``lengths`` move to the pool's
    device; a CPU pool runs the plain version, a CUDA pool the kernel."""
    pool = torch.as_tensor(pool)
    dev = pool.device
    table = _index(table, dev)
    lengths = _index(lengths, dev)
    if table.ndim != 2 or lengths.shape != (table.shape[0],):
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match")
    n_pages, ps = int(pool.shape[0]), int(pool.shape[1])
    full = int(table.shape[1]) * ps
    out_len = full if out_len is None else int(out_len)
    if not 0 <= out_len <= full:
        raise ValueError(f"out_len {out_len} outside [0, {full}]")
    if dev.type == "cuda":
        scales = _scales_or_ones(scales, n_pages, dev)
        return _gather_cuda(pool, table.contiguous(), lengths.contiguous(),
                            scales.contiguous(), out_len)
    if dev.type != "cpu":
        raise ValueError(f"no paged gather for device {dev}")
    return paged_gather_ref(pool, table, lengths, scales, out_len)


def paged_gather_ref(pool, table, lengths, scales=None,
                     out_len: Optional[int] = None) -> torch.Tensor:
    """The plain version on the pool's device, whatever it is (what
    ``chip_smoke.py`` holds the kernel against)."""
    pool = torch.as_tensor(pool)
    dev = pool.device
    n_pages = int(pool.shape[0])
    table = _index(table, dev).clamp(0, n_pages - 1)
    out = _gather_ref_core(pool, table, _index(lengths, dev),
                           _scales_or_ones(scales, n_pages, dev),
                           pool.dtype == torch.int8)
    return out if out_len is None else out[:, :int(out_len), :]


def paged_attention(q, k_pool, v_pool, table, lengths, *, k_scales=None,
                    v_scales=None, softmax_scale=None) -> torch.Tensor:
    """Single-token decode attention against paged K/V.

    ``q`` ``[batch, dim]``; ``k_pool``/``v_pool`` ``[n_pages, page_size,
    dim]`` (float32, or int8 with per-page ``k_scales``/``v_scales``);
    ``table`` ``[batch, width]`` page ids; ``lengths`` ``[batch]`` live
    context lengths → ``[batch, dim]`` float32. Masked positions get exact
    zero weight and a row of length 0 gives zeros. A CPU pool runs the
    plain version, a CUDA pool the kernel."""
    k_pool, v_pool = torch.as_tensor(k_pool), torch.as_tensor(v_pool)
    dev = k_pool.device
    q = torch.as_tensor(q).to(device=dev, dtype=torch.float32)
    table = _index(table, dev)
    lengths = _index(lengths, dev)
    n_pages, d = int(k_pool.shape[0]), int(k_pool.shape[2])
    if table.ndim != 2 or lengths.shape != (table.shape[0],) \
            or q.shape != (table.shape[0], d):
        raise ValueError(f"q {tuple(q.shape)} / table {tuple(table.shape)} "
                         f"/ lengths {tuple(lengths.shape)} do not match a "
                         f"pool of dim {d}")
    quantized = k_pool.dtype == torch.int8
    k_scales = _scales_or_ones(k_scales, n_pages, dev)
    v_scales = _scales_or_ones(v_scales, n_pages, dev)
    sc = float(softmax_scale if softmax_scale is not None
               else 1.0 / math.sqrt(d))
    if dev.type == "cuda":
        return _attention_cuda(q.contiguous(), k_pool, v_pool,
                               table.contiguous(), lengths.contiguous(),
                               k_scales.contiguous(), v_scales.contiguous(),
                               sc)
    if dev.type != "cpu":
        raise ValueError(f"no paged attention for device {dev}")
    return paged_attention_ref(
        q, k_pool, v_pool, table, lengths,
        k_scales=k_scales if quantized else None,
        v_scales=v_scales if quantized else None, softmax_scale=sc)
