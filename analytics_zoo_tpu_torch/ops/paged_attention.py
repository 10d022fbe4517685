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
  K/V: on CUDA ``paged_attention_kernel`` (replaces ``_attn_kernel``), which
  cuts each row's page slots into splits read by blocks of their own, then,
  for more than one split, ``paged_attention_combine_kernel``, which folds
  the splits' partials in split order; ``paged_attention_ref`` (JAX's
  two-pass dense softmax in float32) on the CPU. The kernel is held to the
  same softmax in float64 (``paged_attention_ref(..., dtype=
  torch.float64)``) within JAX's limit. ``_attention_plan`` picks the
  splits from the shapes and the card's SM count, never from the lengths:
  one split where a block reaches a whole row in one round.

Both public calls on tensors that are already int32, contiguous and on the
pool's device check their arguments once and make one ctypes call
(positional arguments, as ``ops/embedding_bag.py``'s): no
device guard (the C entry points take the device index and the raw stream
and switch device only when the calling thread's differs), no ``Stream``
object, and no scales tensor for float32 pools (the kernels read a null
scales pointer as scale 1). A gather is one launch; an attention one
launch with one split and two with more (``attention_launches`` and
``attention_combine_launches`` count them).

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
from typing import Dict, Optional, Tuple

import torch

from analytics_zoo_tpu_torch.ops import _build

NEG_INF = -1e30
_POOL_DTYPES = (torch.float32, torch.int8)
MAX_ATTN_DIM = 1024
#: the most splits of one row (ATTN_MAX_SPLITS in csrc/paged_attention.cu)
MAX_SPLITS = 1024
#: blocks the attention's split plan aims for, in multiples of the SM count
SPLIT_WAVES = 8
#: threads of a split kernel's block and K/V vectors a lane loads before it
#: folds them (ATTN_THREADS, ATTN_ROWS_AHEAD in csrc/paged_attention.cu)
ATTN_THREADS = 128
ATTN_ROWS_AHEAD = 4

#: launches of the CUDA kernels (the plain versions never count)
gather_launches = _build.launch_counter("paged_gather")
attention_launches = _build.launch_counter("paged_attention")
attention_combine_launches = _build.launch_counter("paged_attention_combine")


def _scales_or_ones(scales, n_pages: int, device) -> torch.Tensor:
    if scales is None:
        return torch.ones((n_pages,), dtype=torch.float32, device=device)
    return torch.as_tensor(scales).to(device=device, dtype=torch.float32)


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous ``dtype`` tensor on ``device``; a tensor that
    already is one comes back as it is."""
    if type(x) is torch.Tensor and x.dtype is dtype and x.device == device:
        return x if x.is_contiguous() else x.contiguous()
    return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()


def _on_kernel_device(dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {dev}")


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


def _scores_ref(q, k_pool, v_pool, table, lengths, k_scales, v_scales,
                softmax_scale, dtype=torch.float32):
    """The plain attention's shared first steps, in ``dtype``: the masked
    scores ``[batch, n]`` (NEG_INF past each length), the live mask and
    the gathered V. K and V are the gather's float32 values (dequantized
    in float32 as JAX dequantizes them), widened to ``dtype``; the scale
    is the float32 softmax scale."""
    q = torch.as_tensor(q).to(torch.float32)
    d = q.shape[-1]
    sc = torch.tensor(softmax_scale if softmax_scale is not None
                      else 1.0 / math.sqrt(d), dtype=torch.float32)
    k = paged_gather_ref(k_pool, table, lengths, scales=k_scales)
    v = paged_gather_ref(v_pool, table, lengths, scales=v_scales)
    s = torch.einsum("bd,bnd->bn", q.to(dtype), k.to(dtype)) \
        * sc.to(device=q.device, dtype=dtype)
    lengths = _on(lengths, torch.int32, q.device)
    live = torch.arange(s.shape[1], device=q.device)[None, :] \
        < lengths.to(torch.int64)[:, None]
    s = torch.where(live, s, torch.full((), NEG_INF, device=q.device,
                                        dtype=dtype))
    return s, live, v.to(dtype)


def paged_attention_ref(q, k_pool, v_pool, table, lengths, *,
                        k_scales=None, v_scales=None, softmax_scale=None,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Reference (JAX's ``paged_attention_ref``): gather K/V pages
    (dequantizing per-page scales), mask positions >= length, softmax in
    two passes, weighted sum over V. ``dtype`` float32 computes what JAX
    computes (the CPU route); float64 computes the same softmax of the
    same float32 inputs nearly exactly (what the kernel is held to on the
    card: its own float32 sums and JAX's both sit within the limit of it).
    The output is float32."""
    s, live, v = _scores_ref(q, k_pool, v_pool, table, lengths, k_scales,
                             v_scales, softmax_scale, dtype)
    zero = torch.zeros((), device=s.device, dtype=dtype)
    m = s.amax(dim=1, keepdim=True)
    w = torch.where(live, torch.exp(s - m), zero)
    denom = w.sum(dim=1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones((), device=s.device,
                                                 dtype=dtype), denom)
    out = torch.einsum("bn,bnd->bd", w, v)
    return (out / denom).to(torch.float32)


def _combine_splits_ref(parts: torch.Tensor) -> torch.Tensor:
    """The combine kernel's arithmetic in plain PyTorch: fold ``parts``
    ``[batch, splits, dim + 2]`` in split order, ``m* = max m_s``, ``out =
    sum acc_s e^(m_s - m*) / sum l_s e^(m_s - m*)``, a denominator of 0
    read as 1 (a row of length 0 gives zeros), in float64 from the float32
    partials and rounded once to float32 (the same function, free of the
    kernel's rounding points). For tests and for ``chip_smoke.py``'s check
    of the combine on the partials that ``_attention_cuda(..., work=)``
    keeps; nothing on the main path calls it."""
    parts = parts.double()
    m, l, acc = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m - m.amax(dim=1, keepdim=True))
    den = torch.zeros_like(l[:, 0])
    num = torch.zeros_like(acc[:, 0])
    for s in range(parts.shape[1]):
        den = den + l[:, s] * w[:, s]
        num = num + acc[:, s] * w[:, s, None]
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den[:, None]).float()


# ---------------------------------------------------------------- kernels

_lib_handle: Optional[ctypes.CDLL] = None
_sm_counts: Dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.zoo_paged_gather.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.zoo_paged_gather.restype = i32
        lib.zoo_paged_attention.argtypes = [ptr] * 9 + [i32] * 9 + [
            ptr, ctypes.c_float]
        lib.zoo_paged_attention.restype = i32
        lib.zoo_cuda_error_string.argtypes = [i32]
        lib.zoo_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _sm_count(index: int) -> int:
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _block_reach(dim: int, quantized: bool) -> int:
    """The positions one block of the split kernel takes in a round: its
    warps, times the positions a warp takes at once (32 lanes over a group
    of lanes a position), times the rounds' rows a group loads ahead, as
    the kernel picks them for an aligned pool of row width ``dim``."""
    vec = 16 if quantized and dim % 16 == 0 else 4 if dim % 4 == 0 else 1
    nv = dim // vec
    group = min(32, 1 << (nv - 1).bit_length())
    ahead = max(1, ATTN_ROWS_AHEAD // -(-nv // group))
    return ATTN_THREADS // 32 * (32 // group) * ahead


def _attention_plan(batch: int, width: int, page_size: int, dim: int,
                    quantized: bool, n_sm: int) -> Tuple[int, int]:
    """``(splits, pages_per_split)`` of the split kernel for ``batch`` rows
    of ``width`` page slots of ``page_size`` positions (row width ``dim``,
    int8 or not) on a card of ``n_sm`` SMs, from the shapes alone (the
    lengths live on the device; reading them would wait for it). One split
    (one launch, no combine) where one block reaches a whole row in one
    round (``_block_reach``), where the batch alone fills
    ``SPLIT_WAVES * n_sm`` blocks or where a row has one slot. Otherwise it
    aims at that many blocks, gives every split at least one slot and at
    most ``MAX_SPLITS`` splits a row, and cuts the slots into equal runs:
    split ``s`` owns ``[s*P, min((s+1)*P, width))``, every slot in exactly
    one."""
    if width * page_size <= _block_reach(dim, quantized):
        return 1, width
    want = -(-SPLIT_WAVES * n_sm // max(batch, 1))
    per = -(-width // max(1, min(want, width, MAX_SPLITS)))
    return -(-width // per), per


def _check_pool(name: str, pool: torch.Tensor) -> None:
    if pool.dtype not in _POOL_DTYPES:
        raise TypeError(
            f"paged kernels take float32 or int8 {name}s, got {pool.dtype} "
            "(the JAX package's KV_DTYPES limit)")
    if pool.ndim != 3 or not pool.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [n_pages, page_size,"
                         f" dim] tensor, got {tuple(pool.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().zoo_cuda_error_string(err).decode())


def _gather_cuda(pool, table, lengths, scales, out_len: int):
    """Launch ``paged_gather_kernel`` on the pool's device and its current
    stream: ``table`` and ``lengths`` int32, contiguous, on that device;
    ``scales`` float32 ``[n_pages]`` on it or None (scale 1; read only for
    int8)."""
    _check_pool("pool", pool)
    batch, width = table.shape
    n_pages, ps, dim = pool.shape
    out = pool.new_empty((batch, out_len, dim), dtype=torch.float32)
    if out.numel() == 0:
        return out
    index = pool.get_device()
    _raise_on(_lib().zoo_paged_gather(
        pool.data_ptr(), None if scales is None else scales.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), batch, width,
        ps, dim, n_pages, out_len, pool.dtype is torch.int8, index,
        _build.raw_stream(index)), "paged gather")
    gather_launches.add()
    return out


def _attention_cuda(q, k_pool, v_pool, table, lengths, k_scales, v_scales,
                    softmax_scale: float, splits: Optional[int] = None,
                    work: Optional[torch.Tensor] = None):
    """Launch the split kernel, and the combine for more than one split,
    on the pools' device and its current stream: ``q`` float32 and
    ``table`` / ``lengths`` int32, contiguous, on that device; the scales
    float32 ``[n_pages]`` on it or None. ``splits`` None takes
    ``_attention_plan``'s; a number is cut into equal runs as the plan
    cuts (tests, checks and design variants). ``work``, a float32
    ``[batch, splits, dim + 2]`` tensor, takes the partials in place of a
    fresh one, so a caller can read them afterwards (and hold the combine
    against ``_combine_splits_ref`` of them)."""
    _check_pool("k_pool", k_pool)
    _check_pool("v_pool", v_pool)
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError("k_pool and v_pool must share shape and dtype")
    batch, width = table.shape
    n_pages, ps, dim = k_pool.shape
    if dim > MAX_ATTN_DIM:
        raise ValueError(f"paged attention kernel takes dim <= "
                         f"{MAX_ATTN_DIM}, got {dim}")
    out = q.new_empty((batch, dim))
    if batch == 0:
        return out
    index = k_pool.get_device()
    quantized = k_pool.dtype is torch.int8
    if splits is None:
        splits, per = _attention_plan(batch, width, ps, dim, quantized,
                                      _sm_count(index))
    else:
        per = -(-width // max(1, min(int(splits), width, MAX_SPLITS)))
        splits = -(-width // per)
    if splits > 1 and work is None:
        work = q.new_empty((batch, splits, dim + 2))
    elif work is not None and (work.shape != (batch, splits, dim + 2)
                               or work.dtype != torch.float32
                               or not work.is_contiguous()):
        raise ValueError(f"work must be a contiguous float32 "
                         f"[{batch}, {splits}, {dim + 2}] tensor")
    _raise_on(_lib().zoo_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scales is None else k_scales.data_ptr(),
        None if v_scales is None else v_scales.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if splits == 1 else work.data_ptr(), batch, width, ps, dim,
        n_pages, quantized, splits, per, index, _build.raw_stream(index),
        softmax_scale), "paged attention")
    attention_launches.add()
    if splits > 1:
        attention_combine_launches.add()
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
    device; a CPU pool runs the plain version, a CUDA pool the kernel
    (one launch)."""
    if not isinstance(pool, torch.Tensor):
        pool = torch.as_tensor(pool)
    dev = pool.device
    _on_kernel_device(dev, "paged gather")
    table = _on(table, torch.int32, dev)
    lengths = _on(lengths, torch.int32, dev)
    shape = table.shape
    if len(shape) != 2 or lengths.shape != shape[:1]:
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match")
    full = shape[1] * pool.shape[1]
    out_len = full if out_len is None else int(out_len)
    if not 0 <= out_len <= full:
        raise ValueError(f"out_len {out_len} outside [0, {full}]")
    if dev.type == "cpu":
        return paged_gather_ref(pool, table, lengths, scales, out_len)
    if pool.dtype != torch.int8 or scales is None:
        scales = None
    else:
        scales = _on(scales, torch.float32, dev)
    return _gather_cuda(pool, table, lengths, scales, out_len)


def paged_gather_ref(pool, table, lengths, scales=None,
                     out_len: Optional[int] = None) -> torch.Tensor:
    """The plain version on the pool's device, whatever it is (what
    ``chip_smoke.py`` holds the kernel against)."""
    pool = torch.as_tensor(pool)
    dev = pool.device
    n_pages = int(pool.shape[0])
    table = _on(table, torch.int32, dev).clamp(0, n_pages - 1)
    out = _gather_ref_core(pool, table, _on(lengths, torch.int32, dev),
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
    plain version, a CUDA pool the kernels (one launch, or two where the
    plan splits the rows)."""
    if not isinstance(k_pool, torch.Tensor):
        k_pool = torch.as_tensor(k_pool)
    if not isinstance(v_pool, torch.Tensor):
        v_pool = torch.as_tensor(v_pool)
    dev = k_pool.device
    _on_kernel_device(dev, "paged attention")
    q = _on(q, torch.float32, dev)
    table = _on(table, torch.int32, dev)
    lengths = _on(lengths, torch.int32, dev)
    d = k_pool.shape[2]
    shape = table.shape
    if len(shape) != 2 or lengths.shape != shape[:1] \
            or q.shape != (shape[0], d):
        raise ValueError(f"q {tuple(q.shape)} / table {tuple(table.shape)} "
                         f"/ lengths {tuple(lengths.shape)} do not match a "
                         f"pool of dim {d}")
    sc = float(softmax_scale if softmax_scale is not None
               else 1.0 / math.sqrt(d))
    quantized = k_pool.dtype == torch.int8
    if dev.type == "cpu":
        n_pages = k_pool.shape[0]
        return paged_attention_ref(
            q, k_pool, v_pool, table, lengths,
            k_scales=_scales_or_ones(k_scales, n_pages, dev)
            if quantized else None,
            v_scales=_scales_or_ones(v_scales, n_pages, dev)
            if quantized else None, softmax_scale=sc)
    if quantized:
        k_scales = None if k_scales is None else _on(k_scales, torch.float32,
                                                     dev)
        v_scales = None if v_scales is None else _on(v_scales, torch.float32,
                                                     dev)
    else:
        k_scales = v_scales = None
    return _attention_cuda(q, k_pool, v_pool, table, lengths, k_scales,
                           v_scales, sc)
