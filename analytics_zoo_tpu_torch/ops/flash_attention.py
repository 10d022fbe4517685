"""Flash attention, forward and backward, in PyTorch and CUDA.

Counterpart of ``analytics_zoo_tpu/ops/flash_attention.py``:

- ``blockwise_attention`` — chunked online-softmax attention in plain
  PyTorch, the path the JAX package takes off the TPU. It mirrors the JAX
  function op for op, down to its scale in q's dtype (bf16 rounds the
  scores there).
- ``flash_attention`` / ``flash_attention_with_lse`` — on a CUDA tensor
  they launch the kernels of ``csrc/flash_attention.cu`` (the forward,
  which replaces the Pallas ``_flash_fwd_kernel``) and, under autograd,
  ``csrc/flash_attention_bwd.cu`` (dq and dk/dv, which replace
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``), or raise; for
  tensors on the CPU they run the plain versions ``_flash_fwd_ref`` and
  ``_flash_bwd_ref``. When an input requires grad the call goes through a
  ``torch.autograd.Function`` whose forward saves q, k, v, the output and
  the lse; the lse output of ``flash_attention_with_lse`` is
  differentiable (its cotangent ``glse`` folds into the softmax term).
- ``default_use_flash`` — the auto-select the sequence-parallel
  compositions use, with the CUDA device where the JAX code asks for the
  TPU.
- ``counting_flops`` — while a step's products are counted
  (``common/profiling.step_flops``), the forward and the backward run as
  the operators ``zoo_torch::flash_fwd`` / ``zoo_torch::flash_bwd``, whose
  bodies (kernel launches or plain versions, as always) the counter does
  not see and whose registered counts are the einsum chain's: its
  products and its elementwise work on the scores.

All take the public layout ``[b, s, h, d]``; the lse is ``[b*h, sq]``
fp32. The kernels read q, k, v (and the output's cotangent) through their
strides (the head dim must be contiguous), so the slices of a packed QKV
projection need no copy. The kernels copy rows in 16-byte pieces: a
tensor whose rows do not start on 16 bytes is first copied, on the card,
into a contiguous one with rows zero-padded to 16 bytes. In bf16 the
forward and both backward kernels run their products on the tensor cores
(``mma.sync``, fp32 accumulation); in fp32 they stay on CUDA cores,
register-tiled. Masked keys follow the Pallas kernel: scores of
-1e30, bottom-right causal with offset ``sk - sq``, and keys past ``sk``
masked in the ragged tail. A row that sees no key at all gives zeros and
zero gradients (see the sources' notes).
"""

from __future__ import annotations

import ctypes
import math
import threading
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from analytics_zoo_tpu_torch.ops import _build

NEG_INF = -1e30
#: largest head dim the kernel takes
MAX_HEAD_DIM = 128
#: keys per tile of the kernel (kBK in csrc/flash_attention.cu)
BLOCK_K = 64
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: launches of the CUDA kernels (the plain versions never count)
launches = _build.launch_counter("flash_attention_fwd")
launches_bwd_dq = _build.launch_counter("flash_attention_bwd_dq")
launches_bwd_dkv = _build.launch_counter("flash_attention_bwd_dkv")


def kernel_tile(head_dim: int) -> Tuple[int, int]:
    """The forward kernel's (query rows, keys) tile at ``head_dim``: 128 x
    64 up to d 64, 64 x 64 up to d 128 (``launch_bf16`` / ``launch_f32``
    in csrc/flash_attention.cu). It is the one tile the launcher offers,
    so the autotuner's only candidate."""
    return (128, BLOCK_K) if head_dim <= 64 else (64, BLOCK_K)


def _check_tile(head_dim: int, block_q: Optional[int],
                block_k: Optional[int]) -> None:
    bq, bk = kernel_tile(head_dim)
    if (block_q or bq, block_k or bk) != (bq, bk):
        raise ValueError(f"the flash kernel's tile at head dim {head_dim} is "
                         f"{bq}x{bk}; block_q={block_q}, block_k={block_k} "
                         f"asks for another")


def ceil_to(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------- blockwise

def blockwise_attention(q, k, v, causal: bool = False, block_k: int = 128,
                        return_lse: bool = False):
    """q, k, v: [b, s, h, d] -> [b, s, h, d]; O(s*block_k) memory.
    ``return_lse``: also return the per-row logsumexp as [b*h, s] fp32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    block_k = min(block_k, sk)
    nk = (sk + block_k - 1) // block_k
    pad = nk * block_k - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    # 1 / sqrt(d) in q's dtype: sqrt in fp32, cast, then the reciprocal
    root = torch.tensor(np.float32(np.sqrt(d)), dtype=q.dtype,
                        device=q.device)
    scale = 1.0 / root
    q_pos = torch.arange(sq, device=q.device)
    causal_off = sk - sq
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for kb in range(nk):
        k_blk = k[:, kb * block_k:(kb + 1) * block_k]
        v_blk = v[:, kb * block_k:(kb + 1) * block_k]
        s = (torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale).float()
        k_pos = kb * block_k + torch.arange(block_k, device=q.device)
        valid = k_pos < sk
        if causal:
            valid = valid[None, :] & (k_pos[None, :]
                                      <= q_pos[:, None] + causal_off)
            s = torch.where(valid[None, None], s, NEG_INF)
        else:
            s = torch.where(valid[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        m = m_new
    l_fin = torch.clamp(l, min=1e-37)
    out = (o / l_fin[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_fin)).reshape(b * h, sq)
    return out


def default_use_flash(seq: int, head_dim: int, block: int = 128) -> bool:
    """Auto-select for the sequence-parallel compositions (ring /
    Ulysses): the kernel when a CUDA device is present, the sequence fills
    at least one block and the head dim fits the kernel."""
    return (torch.cuda.is_available() and seq >= block
            and head_dim <= MAX_HEAD_DIM)


# ---------------------------------------------------------- plain version

def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes [b, s, h, d] q, k and v")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit [b, s, h, d]")
    if k.shape[1] == 0:
        raise ValueError("flash attention needs at least one key")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must live on one device")


def _flash_fwd_ref(q, k, v, causal: bool = False, return_lse: bool = False,
                   block_k: int = BLOCK_K):
    """The kernel's arithmetic in plain PyTorch, over the same key tiles
    of ``block_k`` (the Pallas kernel's are 128): fp32 scores of the
    widened inputs times an fp32 scale, masked scores of -1e30 with p = 0,
    an online softmax whose p is rounded to v's dtype at the running
    maximum before P.V, fp32 sums, the sum floored at 1e-37, output in q's
    dtype. Only the order of the fp32 sums (on the tensor cores in bf16)
    and the last bits of exp differ from the kernel's; in bf16 either can
    round a p to its other neighbour (see chip_smoke.py's bf16 limit)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm_scale = float(np.float32(1.0 / math.sqrt(d)))
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    q_pos = torch.arange(sq, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        k_blk, v_blk = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = torch.matmul(qf, k_blk.transpose(-1, -2)) * sm_scale
        masked = None
        if causal:
            k_pos = k0 + torch.arange(k_blk.shape[2], device=q.device)
            masked = k_pos[None, :] > q_pos[:, None] + (sk - sq)
            s = torch.where(masked, NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        if masked is not None:
            p = torch.where(masked, 0.0, p)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.matmul(p.to(v.dtype).float(), v_blk)
        m = m_new
    l_fin = torch.clamp(l, min=1e-37)
    out = (o / l_fin[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_fin)).reshape(b * h, sq)
    return out


def _row_delta(o, do) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in fp32 as [b*h, sq], from O in its stored
    dtype; both backward versions take it from here, as the JAX package
    computes it outside its kernels."""
    b, sq, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, sq)


def _p_ds(q, k, v, lse, do, delta, causal: bool, glse):
    """The tiles' shared math over the whole score matrix: (p, ds) as fp32
    [b, h, sq, sk], with q, k and dO widened and laid out [b, h, s, d]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sm_scale = float(np.float32(1.0 / math.sqrt(d)))
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse.float().reshape(b, h, sq, 1))
    if causal:
        q_pos = torch.arange(sq, device=q.device)
        k_pos = torch.arange(sk, device=q.device)
        masked = k_pos[None, :] > q_pos[:, None] + (sk - sq)
        p = torch.where(masked, 0.0, p)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    g = 0.0 if glse is None else glse.float().reshape(b, h, sq, 1)
    ds = p * (dp - delta.reshape(b, h, sq, 1) + g) * sm_scale
    return p, ds, qf, kf, dof


def _bshd(t, dtype):
    """[b, h, s, d] fp32 -> contiguous [b, s, h, d] in ``dtype``."""
    return t.permute(0, 2, 1, 3).contiguous().to(dtype)


def _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool = False,
                      glse=None):
    """The dq kernel's arithmetic in plain PyTorch (see _flash_bwd_ref)."""
    _, ds, _, kf, _ = _p_ds(q, k, v, lse, do, delta, causal, glse)
    return _bshd(torch.matmul(ds.to(q.dtype).float(), kf), q.dtype)


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool = False,
                       glse=None):
    """The dk/dv kernel's arithmetic in plain PyTorch: (dk, dv)."""
    p, ds, qf, _, dof = _p_ds(q, k, v, lse, do, delta, causal, glse)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qf)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    return _bshd(dk, q.dtype), _bshd(dv, q.dtype)


def _flash_bwd_ref(q, k, v, o, lse, do, causal: bool = False, glse=None):
    """Both backward kernels' arithmetic in plain PyTorch: (dq, dk, dv).

    fp32 scores of the widened inputs times an fp32 scale; p = exp(s -
    lse) from the forward's lse, and p = 0 for a masked key (a row that
    sees no key gets dq = 0 and adds nothing to dk or dv); dp = dO·Vᵀ in
    fp32; ds = p·(dp − Δ + glse)·scale; dq = round(ds)·K, dv =
    round(p)ᵀ·dO, dk = round(ds)ᵀ·Q with round() to the inputs' dtype and
    fp32 sums; outputs in the inputs' dtype. p comes from the saved lse,
    not a running maximum, so the kernels' tiles change nothing but the
    order of the fp32 sums, and this version takes one pass."""
    do = do.to(q.dtype)
    args = (q, k, v, do, lse, _row_delta(o, do), causal, glse)
    return (_flash_bwd_dq_ref(*args), *_flash_bwd_dkv_ref(*args))


# ----------------------------------------------------------------- kernel

_lib_handle: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the forward's C entry points on a loaded library."""
    lib.zoo_flash_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.zoo_flash_fwd.restype = ctypes.c_int
    lib.zoo_flash_error_string.argtypes = [ctypes.c_int]
    lib.zoo_flash_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        _lib_handle = _bind(_build.load("flash_attention"))
    return _lib_handle


def _rows_aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` [b, s, h, d] as the kernel reads it: every row of the head dim
    dense and starting on 16 bytes (the kernel copies rows in 16-byte
    pieces with cp.async). A tensor that is not (a pointer, a stride of a
    dimension longer than 1 or d not a multiple of 16 bytes) is copied on
    its device into a contiguous tensor whose rows are zero-padded to 16
    bytes; the kernel reads the first d columns of it and zeros after."""
    vec = 16 // t.element_size()
    # unrolled: this runs for every tensor of every launch, on the host
    (n0, n1, n2, d), (s0, s1, s2, s3) = t.shape, t.stride()
    if (s3 == 1 and d % vec == 0 and t.data_ptr() % 16 == 0
            and (s0 % vec == 0 or n0 == 1) and (s1 % vec == 0 or n1 == 1)
            and (s2 % vec == 0 or n2 == 1)):
        return t
    out = torch.zeros((*t.shape[:3], ceil_to(d, vec)), dtype=t.dtype,
                      device=t.device)
    out[..., :d] = t
    return out


def _flash_fwd_cuda(q, k, v, causal: bool, return_lse: bool):
    """Launch the CUDA kernel on the tensors' device and current stream.
    q, k and v are read through their strides, without a copy, when their
    rows start on 16 bytes (the packed QKV projection's slices do);
    otherwise ``_rows_aligned`` copies them first. There is no other
    route."""
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash attention kernel takes float32/bfloat16, "
                        f"got {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    dev = q.device
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b * h * sq == 0:
        return (out, lse) if return_lse else out
    sm_scale = float(np.float32(1.0 / math.sqrt(d)))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zoo_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), sm_scale, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.zoo_flash_error_string(err).decode())
    launches.add()
    return (out, lse) if return_lse else out


_bwd_lib_handle: Optional[ctypes.CDLL] = None


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the backward's C entry points on a loaded library."""
    common = ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
              + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p])
    lib.zoo_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + common
    lib.zoo_flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 9 + common
    lib.zoo_flash_bwd_dq.restype = ctypes.c_int
    lib.zoo_flash_bwd_dkv.restype = ctypes.c_int
    lib.zoo_flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.zoo_flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    global _bwd_lib_handle
    if _bwd_lib_handle is None:
        _bwd_lib_handle = _bind_bwd(_build.load("flash_attention_bwd"))
    return _bwd_lib_handle


def _bwd_launch(name, counter, q, k, v, do, lse, delta, causal, glse,
                outs):
    """Launch backward kernel ``name`` writing ``outs`` (contiguous, q's
    dtype) on the tensors' device and current stream. q, k, v and dO are
    read through their strides when their rows start on 16 bytes;
    otherwise ``_rows_aligned`` copies them first."""
    b, sq, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for what, t in (("lse", lse), ("delta", delta), ("glse", glse)):
        if t is not None and tuple(t.shape) != (b * h, sq):
            raise ValueError(f"{what} {tuple(t.shape)} is not [b*h, sq] = "
                             f"{(b * h, sq)}")
    if b * h * sq == 0:
        return
    q, k, v, do = (_rows_aligned(t) for t in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    glse = None if glse is None else glse.float().contiguous()
    sm_scale = float(np.float32(1.0 / math.sqrt(d)))
    lib = _bwd_lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if glse is None else glse.data_ptr(),
            *(t.data_ptr() for t in outs), b, h, sq, k.shape[1], d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            do.stride(0), do.stride(1), do.stride(2),
            int(causal), sm_scale, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed "
                           f"({name}): "
                           + lib.zoo_flash_bwd_error_string(err).decode())
    counter.add()


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, glse=None):
    """Launch the dq kernel: dq [b, sq, h, d], contiguous, q's dtype."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("zoo_flash_bwd_dq", launches_bwd_dq, q, k, v, do, lse,
                delta, causal, glse, [dq])
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, glse=None):
    """Launch the dk/dv kernel: (dk, dv) [b, sk, h, d], contiguous. The
    kernel writes every key row; with no query rows it does not run, and
    the gradients are zeros."""
    alloc = torch.zeros if q.shape[1] == 0 else torch.empty
    dk = alloc(k.shape, dtype=q.dtype, device=q.device)
    dv = alloc(k.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("zoo_flash_bwd_dkv", launches_bwd_dkv, q, k, v, do, lse,
                delta, causal, glse, [dk, dv])
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal: bool, glse=None):
    """Both backward kernels: (dq, dk, dv), contiguous, in q's dtype."""
    do = do.to(q.dtype)
    delta = _row_delta(o, do)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, glse)
    return (dq, *_flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, glse))


# ------------------------------------------------------------- dispatcher

def _fwd_impl(q, k, v, causal: bool, return_lse: bool):
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, causal, return_lse)
    return _flash_fwd_cuda(q, k, v, causal, return_lse)


def _bwd_impl(q, k, v, o, lse, do, causal: bool, glse=None):
    bwd = _flash_bwd_ref if q.device.type == "cpu" else _flash_bwd_cuda
    return bwd(q, k, v, o, lse, do, causal, glse)


# ------------------------------------------------------ counted operators

#: > 0 while ``counting_flops`` is open (a process-wide depth: a CUDA
#: backward runs on autograd's device thread, not the counting one)
_counting = 0
_count_lock = threading.Lock()
_count_ops = None


def _chain_elementwise(q, k, causal: bool, backward: bool) -> int:
    """The einsum chain's elementwise flops on its ``[b, h, sq, sk]``
    scores (``common/profiling.py``'s rates): the scale's division, the
    causal mask's select, the softmax (4 forward, 5 backward) and, off
    fp32, the casts to fp32 and back."""
    b, sq, h, _ = q.shape
    n = b * h * sq * k.shape[1]
    per = (5 if backward else 4) + 1 + int(bool(causal)) + (
        2 if q.dtype != torch.float32 else 0)
    return n * per


def _fwd_flops(q, k, v, causal, out_val=None, **kwargs) -> int:
    """QK^T and PV as the einsum chain computes them (the full square),
    and the chain's elementwise work on the scores."""
    b, sq, h, d = q.shape
    return 4 * b * h * sq * k.shape[1] * d + _chain_elementwise(
        q, k, causal, False)


def _bwd_flops(q, k, v, o, lse, do, causal, *args, out_val=None,
               **kwargs) -> int:
    """dV, dP, dQ and dK, each the size of a forward product (the
    kernels' recompute of S is not model work), and the chain's
    backward elementwise work on the scores."""
    b, sq, h, d = q.shape
    return 8 * b * h * sq * k.shape[1] * d + _chain_elementwise(
        q, k, causal, True)


_fwd_flops._get_raw = _bwd_flops._get_raw = True


def _counted_ops():
    """The two counted operators, defined at first use."""
    global _count_ops
    with _count_lock:
        if _count_ops is None:
            from torch.library import custom_op
            fwd = custom_op(
                "zoo_torch::flash_fwd",
                lambda q, k, v, causal: _fwd_impl(q, k, v, causal, True),
                mutates_args=(),
                schema="(Tensor q, Tensor k, Tensor v, bool causal) "
                       "-> (Tensor, Tensor)")
            bwd = custom_op(
                "zoo_torch::flash_bwd", _bwd_impl, mutates_args=(),
                schema="(Tensor q, Tensor k, Tensor v, Tensor o, "
                       "Tensor lse, Tensor do, bool causal, Tensor? glse)"
                       " -> (Tensor, Tensor, Tensor)")
            _count_ops = (fwd, bwd)
    return _count_ops


@contextmanager
def counting_flops():
    """Route flash attention through the counted operators while the
    block runs; yields ``{operator: count formula}`` for
    ``FlopCounterMode(custom_mapping=...)``."""
    global _counting
    _counted_ops()
    with _count_lock:
        _counting += 1
    try:
        yield {torch.ops.zoo_torch.flash_fwd: _fwd_flops,
               torch.ops.zoo_torch.flash_bwd: _bwd_flops}
    finally:
        with _count_lock:
            _counting -= 1


def counting() -> bool:
    """True while ``counting_flops`` is open."""
    return _counting > 0


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the lse saved, and both backward kernels.
    With ``return_lse`` the lse is a second, differentiable output."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, return_lse: bool):
        if _counting:
            out, lse = torch.ops.zoo_torch.flash_fwd(q, k, v, causal)
        else:
            out, lse = _fwd_impl(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return (out, lse) if return_lse else out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out, g_lse=None):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        if _counting:
            dq, dk, dv = torch.ops.zoo_torch.flash_bwd(
                q, k, v, out, lse, g_out, ctx.causal, g_lse)
        else:
            dq, dk, dv = _bwd_impl(q, k, v, out, lse, g_out, ctx.causal,
                                   g_lse)
        return dq, dk, dv, None, None


def _flash(q, k, v, causal: bool, return_lse: bool):
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    if _counting or (torch.is_grad_enabled()
                     and any(t.requires_grad for t in (q, k, v))):
        return _FlashAttention.apply(q, k, v, causal, return_lse)
    return _fwd_impl(q, k, v, causal, return_lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Attention of q [b, sq, h, d] over k, v [b, sk, h, d] -> [b, sq, h, d]
    in q's dtype. CUDA tensors launch the kernels (key tiles of
    BLOCK_K), CPU tensors run the plain versions; differentiable in q, k
    and v. ``block_q`` / ``block_k`` take JAX's calls: the kernel has one
    tile per head dim (``kernel_tile``), and any other tile raises."""
    _check_tile(q.shape[-1], block_q, block_k)
    return _flash(q, k, v, causal, False)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ``flash_attention`` but also returns the per-row logsumexp
    ([b*h, sq] fp32), what ring attention merges its partial softmaxes
    with; both outputs are differentiable. ``block_q`` / ``block_k`` as
    in ``flash_attention``."""
    _check_tile(q.shape[-1], block_q, block_k)
    return _flash(q, k, v, causal, True)
