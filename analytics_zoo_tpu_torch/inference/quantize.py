"""int8 storage of the decode KV page pool (``ZOO_KV_DTYPE=int8``).

Counterpart of the KV part of ``analytics_zoo_tpu/inference/quantize.py``
(its lines 290-342), in numpy on the host as there: one float32 symmetric
scale per page sits beside the pool; the paged kernels
(ops/paged_attention.py) dequantize with the same ``q.float() * scale``
expression the host read path uses, so both see identical bits. Storage
drops 4x per page against float32. Weight int8 waits for ROADMAP A7.
"""

from __future__ import annotations

import os

import numpy as np

KV_DTYPES = ("float32", "int8")


def resolve_kv_dtype(kv_dtype=None) -> np.dtype:
    """Storage dtype for the decode KV page pool: the explicit argument
    when given, else the ``ZOO_KV_DTYPE`` env knob (``float32`` default;
    ``int8`` stores pages quantized under per-page symmetric scales)."""
    if kv_dtype is None:
        kv_dtype = os.environ.get("ZOO_KV_DTYPE", "").strip().lower() \
            or "float32"
    if isinstance(kv_dtype, str):
        kv_dtype = {"fp32": "float32", "f32": "float32"}.get(
            kv_dtype, kv_dtype)
    dt = np.dtype(kv_dtype)
    if dt not in (np.dtype(np.float32), np.dtype(np.int8)):
        raise ValueError(
            f"ZOO_KV_DTYPE must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return dt


def page_scale(amax: float) -> np.float32:
    """Symmetric per-page scale for a page whose running max |x| is
    ``amax`` (zero-amax pages get scale 1.0 so all-zero pages stay exact)."""
    return np.float32(amax / 127.0) if amax > 0.0 else np.float32(1.0)


def quantize_rows(rows, scale) -> np.ndarray:
    """Float rows → int8 under one shared (per-page) scale."""
    return np.clip(np.round(np.asarray(rows, np.float32)
                            / np.float32(scale)),
                   -127, 127).astype(np.int8)


def dequantize_rows(q, scale) -> np.ndarray:
    """int8 rows → float32 as ``q * scale`` — the expression the paged
    kernels fuse, so the host read path and the kernels agree bitwise."""
    return np.asarray(q).astype(np.float32) * np.float32(scale)


def requantize_rows(q, old_scale, new_scale) -> np.ndarray:
    """Rescale already-quantized rows after a later append raised the
    page's amax (so its scale grew). The round trip costs at most half a
    step of the final scale."""
    return quantize_rows(dequantize_rows(q, old_scale), new_scale)
