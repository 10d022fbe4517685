"""3D image (volume) preprocessing transformers.

The port's copy of ``analytics_zoo_tpu/feature/image3d/transforms.py``
(host numpy, the same code, so the same bits on the same inputs and the
same ``random.seed``): a rebuild of the reference's image3d pipeline
(ref ``zoo/src/main/scala/com/intel/analytics/zoo/feature/image3d/`` —
Cropper.scala, Rotation.scala, Affine.scala, Warp.scala — and the python
mirror ``pyzoo/zoo/feature/image3d/transformation.py``: Crop3D,
RandomCrop3D, CenterCrop3D, Rotate3D, AffineTransform3D; exercised by the
reference's ``apps/image-augmentation-3d`` notebook).

Volumes are channels-last numpy arrays ``[D, H, W]`` or ``[D, H, W, C]``.
Transforms share the 2D pipeline's contract (``ImagePreprocessing``:
pure callables on an ImageFeature dict, composable with ``>``), run
host-side during ETL, and resample with trilinear interpolation mapping
destination→source (the reference's Affine.scala convention:
``dst(z,y,x) = src(f(z), f(y), f(x))``).
"""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.feature.image.transforms import (
    ChainedPreprocessing, ImagePreprocessing,
)

__all__ = [
    "ImagePreprocessing3D", "Crop3D", "RandomCrop3D", "CenterCrop3D",
    "AffineTransform3D", "Rotate3D", "Warp3D", "rotation_matrix",
]


class ImagePreprocessing3D(ImagePreprocessing):
    """Marker base for volume transforms (ref transformation.py
    ImagePreprocessing3D)."""


def _vol(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.ndim not in (3, 4):
        raise ValueError(f"3D transform expects [D,H,W] or [D,H,W,C] "
                         f"volume, got shape {a.shape}")
    return a


class Crop3D(ImagePreprocessing3D):
    """Crop a patch at ``start`` = [z, y, x] of size ``patch_size`` =
    [depth, height, width] (ref Crop3D / Cropper.scala)."""

    def __init__(self, start: Sequence[int], patch_size: Sequence[int]):
        self.start = tuple(int(s) for s in start)
        self.patch = tuple(int(p) for p in patch_size)

    def apply_image(self, img):
        v = _vol(img)
        z, y, x = self.start
        d, h, w = self.patch
        if z + d > v.shape[0] or y + h > v.shape[1] or x + w > v.shape[2]:
            raise ValueError(f"crop {self.start}+{self.patch} exceeds "
                             f"volume {v.shape[:3]}")
        return v[z:z + d, y:y + h, x:x + w]


class RandomCrop3D(ImagePreprocessing3D):
    """Random ``crop_depth x crop_height x crop_width`` patch
    (ref RandomCrop3D)."""

    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.patch = (int(crop_depth), int(crop_height), int(crop_width))

    def apply_image(self, img):
        v = _vol(img)
        d, h, w = self.patch
        z = random.randint(0, v.shape[0] - d)
        y = random.randint(0, v.shape[1] - h)
        x = random.randint(0, v.shape[2] - w)
        return v[z:z + d, y:y + h, x:x + w]


class CenterCrop3D(ImagePreprocessing3D):
    """Center ``crop_depth x crop_height x crop_width`` patch
    (ref CenterCrop3D)."""

    def __init__(self, crop_depth: int, crop_height: int, crop_width: int):
        self.patch = (int(crop_depth), int(crop_height), int(crop_width))

    def apply_image(self, img):
        v = _vol(img)
        d, h, w = self.patch
        z = (v.shape[0] - d) // 2
        y = (v.shape[1] - h) // 2
        x = (v.shape[2] - w) // 2
        return v[z:z + d, y:y + h, x:x + w]


class AffineTransform3D(ImagePreprocessing3D):
    """Affine resampling with destination→source mapping
    (ref AffineTransform3D / Affine.scala):
    ``src_coord = mat @ (dst_coord - center) + center + translation``,
    trilinear interpolation; off-volume samples either clamp to the edge
    (``clamp_mode="clamp"``) or read ``pad_val`` (``clamp_mode="padding"``).
    """

    def __init__(self, affine_mat: np.ndarray,
                 translation: Optional[np.ndarray] = None,
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.mat = np.asarray(affine_mat, np.float64).reshape(3, 3)
        self.translation = (np.zeros(3) if translation is None
                            else np.asarray(translation, np.float64))
        if clamp_mode not in ("clamp", "padding"):
            raise ValueError("clamp_mode must be 'clamp' or 'padding'")
        if clamp_mode == "clamp" and pad_val != 0.0:
            raise ValueError("pad_val is only meaningful with "
                             "clamp_mode='padding'")
        self.clamp_mode = clamp_mode
        self.pad_val = float(pad_val)

    def apply_image(self, img):
        v = _vol(img).astype(np.float32)
        squeeze = v.ndim == 3
        if squeeze:
            v = v[..., None]
        D, H, W, C = v.shape
        center = (np.array([D, H, W], np.float64) - 1.0) / 2.0
        zz, yy, xx = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                                 indexing="ij")
        dst = np.stack([zz, yy, xx], -1).reshape(-1, 3).astype(np.float64)
        src = (dst - center) @ self.mat.T + center + self.translation

        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(np.float32)
        out = np.zeros((dst.shape[0], C), np.float32)
        limits = np.array([D, H, W]) - 1

        def gather(corner):
            idx = lo + corner
            if self.clamp_mode == "clamp":
                cidx = np.clip(idx, 0, limits)
                return v[cidx[:, 0], cidx[:, 1], cidx[:, 2]]
            inside = ((idx >= 0) & (idx <= limits)).all(axis=1)
            cidx = np.clip(idx, 0, limits)
            vals = v[cidx[:, 0], cidx[:, 1], cidx[:, 2]]
            return np.where(inside[:, None], vals, self.pad_val)

        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    wz = frac[:, 0] if dz else 1.0 - frac[:, 0]
                    wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
                    wx = frac[:, 2] if dx else 1.0 - frac[:, 2]
                    out += (wz * wy * wx)[:, None] * gather((dz, dy, dx))
        out = out.reshape(D, H, W, C)
        return out[..., 0] if squeeze else out


class Warp3D(ImagePreprocessing3D):
    """Warp a volume by a dense flow field (ref WarpTransformer /
    Warp.scala): ``flow_field`` has shape ``(3, D, H, W)`` holding per-voxel
    source coordinates — absolute when ``offset=False``, destination-
    relative displacements when ``offset=True`` — sampled trilinearly with
    the same clamp/padding semantics as AffineTransform3D."""

    def __init__(self, flow_field: np.ndarray, offset: bool = True,
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        self.flow = np.asarray(flow_field, np.float64)
        if self.flow.ndim != 4 or self.flow.shape[0] != 3:
            raise ValueError(f"flow_field must be (3, D, H, W), got "
                             f"{self.flow.shape}")
        if clamp_mode not in ("clamp", "padding"):
            raise ValueError("clamp_mode must be 'clamp' or 'padding'")
        self.offset = bool(offset)
        self.clamp_mode = clamp_mode
        self.pad_val = float(pad_val)

    def apply_image(self, img):
        v = _vol(img).astype(np.float32)
        squeeze = v.ndim == 3
        if squeeze:
            v = v[..., None]
        D, H, W, C = v.shape
        fd, fh, fw = self.flow.shape[1:]
        src = self.flow.reshape(3, -1).T.copy()         # [N, 3] (z, y, x)
        if self.offset:
            zz, yy, xx = np.meshgrid(np.arange(fd), np.arange(fh),
                                     np.arange(fw), indexing="ij")
            src += np.stack([zz, yy, xx], -1).reshape(-1, 3)

        limits = np.array([D, H, W]) - 1
        off_vol = ((src < 0) | (src > limits)).any(axis=1)
        src = np.clip(src, 0, limits)
        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(np.float32)
        out = np.zeros((src.shape[0], C), np.float32)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    idx = np.minimum(lo + (dz, dy, dx), limits)
                    wz = frac[:, 0] if dz else 1.0 - frac[:, 0]
                    wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
                    wx = frac[:, 2] if dx else 1.0 - frac[:, 2]
                    out += (wz * wy * wx)[:, None] * \
                        v[idx[:, 0], idx[:, 1], idx[:, 2]]
        if self.clamp_mode == "padding":
            out = np.where(off_vol[:, None], self.pad_val, out)
        out = out.reshape(fd, fh, fw, C)
        return out[..., 0] if squeeze else out


def rotation_matrix(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Destination→source matrix over (z, y, x) coordinates that rotates
    the volume CONTENT counterclockwise by yaw (about z), pitch (about y)
    and roll (about x) — ref Rotation.scala angle convention. Because the
    resampler maps dst→src, each in-plane block is the inverse rotation
    ``[[c, s], [-s, c]]``."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    # coordinate order (z, y, x): yaw mixes (y, x), pitch (z, x), roll (z, y)
    rz = np.array([[1, 0, 0], [0, cz, sz], [0, -sz, cz]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[cx, sx, 0], [-sx, cx, 0], [0, 0, 1]])
    return rz @ ry @ rx


class Rotate3D(AffineTransform3D):
    """Rotate a volume by [yaw, pitch, roll] radians (ref Rotate3D)."""

    def __init__(self, rotation_angles: Sequence[float],
                 clamp_mode: str = "clamp", pad_val: float = 0.0):
        yaw, pitch, roll = (float(a) for a in rotation_angles)
        super().__init__(rotation_matrix(yaw, pitch, roll),
                         clamp_mode=clamp_mode, pad_val=pad_val)
