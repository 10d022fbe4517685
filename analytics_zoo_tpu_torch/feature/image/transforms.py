"""Image preprocessing transformers, host-side numpy.

The port's own copy of ``analytics_zoo_tpu/feature/image/transforms.py``
(ref ``zoo/src/main/scala/com/intel/analytics/zoo/feature/image/`` and
``pyzoo/zoo/feature/image/imagePreprocessing.py``), the same code and so
the same bits:

- images are channels-last float32/uint8 numpy arrays (HWC); every
  transform is a pure callable on an ``ImageFeature`` dict, and pipelines
  compose with ``ChainedPreprocessing``. They run on the host, per shard,
  so the card only sees fixed-shape batches.
- the random transforms draw from Python's ``random`` module, as JAX's
  do, so the same ``random.seed`` gives the same crops, flips and jitters.
- resampling is ``jax.image.resize``'s bilinear rule (half-pixel centres)
  written in numpy.
- decoding encoded bytes needs PIL, imported where it is used
  (:func:`decode_rgb`); without it a decode raises ``ImportError`` naming
  PIL. The rest needs numpy alone.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ImagePreprocessing", "ChainedPreprocessing", "ImageResize",
    "ImageAspectScale", "ImageRandomAspectScale", "ImageCenterCrop",
    "ImageRandomCrop", "ImageFixedCrop", "ImageHFlip", "ImageRandomFlip",
    "ImageChannelNormalize", "ImagePixelNormalizer",
    "ImageChannelScaledNormalizer", "ImageBrightness", "ImageContrast",
    "ImageSaturation", "ImageHue", "ImageColorJitter", "ImageExpand",
    "ImageFiller", "ImageRandomPreprocessing", "ImageBytesToArray",
    "ImageSetToSample", "ImageMatToTensor", "ImageMirror",
    "ImageChannelOrder", "PerImageNormalize", "decode_rgb",
]


def _to_float(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32)
    return np.asarray(img, dtype=np.float32)


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-numpy bilinear resize (align_corners=False, like jax.image)."""
    img = _to_float(img)
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img
    ys = (np.arange(out_h) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


class ImagePreprocessing:
    """Base transformer: a pure function ImageFeature -> ImageFeature.

    Ref ``pyzoo/zoo/feature/image/imagePreprocessing.py`` ImagePreprocessing
    (py4j wrapper there; a real host-side function here)."""

    def transform(self, feature: dict) -> dict:
        img = feature["image"]
        feature = dict(feature)
        feature["image"] = self.apply_image(img)
        return feature

    def apply_image(self, img: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, feature: dict) -> dict:
        return self.transform(feature)

    # ref feature/common.py Preprocessing `->` chaining
    def __gt__(self, other: "ImagePreprocessing") -> "ChainedPreprocessing":
        return ChainedPreprocessing([self, other])


class ChainedPreprocessing(ImagePreprocessing):
    """Compose transformers left-to-right (ref ChainedPreprocessing,
    ``pyzoo/zoo/feature/common.py``)."""

    def __init__(self, transformers: Sequence[ImagePreprocessing]):
        self.transformers = list(transformers)

    def transform(self, feature: dict) -> dict:
        for t in self.transformers:
            feature = t.transform(feature)
        return feature


def decode_rgb(data: bytes) -> np.ndarray:
    """Encoded image bytes (JPEG, PNG, ...) as an HWC uint8 RGB array.
    Raises ``ImportError`` naming PIL where PIL is not installed."""
    import io
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding an encoded image needs PIL (Pillow), which is not "
            f"installed here: {e}") from e
    img = Image.open(io.BytesIO(data)).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


class ImageBytesToArray(ImagePreprocessing):
    """Decode encoded image bytes (``feature['bytes']``) to an HWC uint8
    array (ref ImageBytesToMat); needs PIL."""

    def __init__(self, byte_key: str = "bytes"):
        self.byte_key = byte_key

    def transform(self, feature: dict) -> dict:
        feature = dict(feature)
        feature["image"] = decode_rgb(feature[self.byte_key])
        return feature


class ImageResize(ImagePreprocessing):
    """Resize to (resize_h, resize_w) (ref ImageResize.scala)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.resize_h, self.resize_w = resize_h, resize_w

    def apply_image(self, img):
        return _bilinear_resize(img, self.resize_h, self.resize_w)


class ImageAspectScale(ImagePreprocessing):
    """Scale the short edge to ``min_size`` keeping aspect ratio, cap the
    long edge at ``max_size`` (ref ImageAspectScale.scala)."""

    def __init__(self, min_size: int, max_size: int = 1000,
                 scale_multiple_of: int = 1):
        self.min_size, self.max_size = min_size, max_size
        self.scale_multiple_of = scale_multiple_of

    def apply_image(self, img):
        h, w = img.shape[:2]
        short, long = min(h, w), max(h, w)
        scale = self.min_size / short
        if long * scale > self.max_size:
            scale = self.max_size / long
        out_h, out_w = int(round(h * scale)), int(round(w * scale))
        m = self.scale_multiple_of
        if m > 1:
            out_h, out_w = (out_h + m - 1) // m * m, (out_w + m - 1) // m * m
        return _bilinear_resize(img, max(out_h, 1), max(out_w, 1))


class ImageRandomAspectScale(ImageAspectScale):
    """Pick the short-edge target randomly from ``scales``
    (ref ImageRandomAspectScale.scala)."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000):
        super().__init__(scales[0], max_size)
        self.scales = list(scales)

    def apply_image(self, img):
        return ImageAspectScale(
            random.choice(self.scales), self.max_size,
            self.scale_multiple_of).apply_image(img)


class ImageCenterCrop(ImagePreprocessing):
    """Center crop to (crop_h, crop_w) (ref ImageCenterCrop.scala)."""

    def __init__(self, crop_h: int, crop_w: int):
        self.crop_h, self.crop_w = crop_h, crop_w

    def apply_image(self, img):
        h, w = img.shape[:2]
        y0 = max((h - self.crop_h) // 2, 0)
        x0 = max((w - self.crop_w) // 2, 0)
        return img[y0:y0 + self.crop_h, x0:x0 + self.crop_w]


class ImageRandomCrop(ImagePreprocessing):
    """Uniform random crop (ref ImageRandomCrop.scala)."""

    def __init__(self, crop_h: int, crop_w: int):
        self.crop_h, self.crop_w = crop_h, crop_w

    def apply_image(self, img):
        h, w = img.shape[:2]
        y0 = random.randint(0, max(h - self.crop_h, 0))
        x0 = random.randint(0, max(w - self.crop_w, 0))
        return img[y0:y0 + self.crop_h, x0:x0 + self.crop_w]


class ImageFixedCrop(ImagePreprocessing):
    """Crop a fixed box; normalized=True means fractional coords
    (ref ImageFixedCrop.scala)."""

    def __init__(self, x1, y1, x2, y2, normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def apply_image(self, img):
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = int(x1 * w), int(x2 * w)
            y1, y2 = int(y1 * h), int(y2 * h)
        return img[int(y1):int(y2), int(x1):int(x2)]


class ImageHFlip(ImagePreprocessing):
    """Horizontal flip (ref ImageHFlip.scala)."""

    def apply_image(self, img):
        return img[:, ::-1]


class ImageRandomFlip(ImagePreprocessing):
    """Flip with probability p."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def apply_image(self, img):
        return img[:, ::-1] if random.random() < self.p else img


class ImageChannelNormalize(ImagePreprocessing):
    """(x - mean) / std per channel (ref ImageChannelNormalize.scala)."""

    def __init__(self, mean_r, mean_g, mean_b, std_r=1.0, std_g=1.0, std_b=1.0):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)

    def apply_image(self, img):
        return (_to_float(img) - self.mean) / self.std


class ImagePixelNormalizer(ImagePreprocessing):
    """Subtract a per-pixel mean image (ref ImagePixelNormalizer.scala)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def apply_image(self, img):
        return _to_float(img) - self.means


class ImageChannelScaledNormalizer(ImagePreprocessing):
    """(x - mean) * scale (ref ImageChannelScaledNormalizer.scala)."""

    def __init__(self, mean_r, mean_g, mean_b, scale: float):
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.scale = scale

    def apply_image(self, img):
        return (_to_float(img) - self.mean) * self.scale


class ImageBrightness(ImagePreprocessing):
    """Add a uniform delta in [delta_low, delta_high]
    (ref ImageBrightness.scala)."""

    def __init__(self, delta_low: float = -32.0, delta_high: float = 32.0):
        self.low, self.high = delta_low, delta_high

    def apply_image(self, img):
        return _to_float(img) + random.uniform(self.low, self.high)


class ImageContrast(ImagePreprocessing):
    """Scale contrast by a uniform factor (ref ImageContrast.scala)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.low, self.high = delta_low, delta_high

    def apply_image(self, img):
        return _to_float(img) * random.uniform(self.low, self.high)


class ImageSaturation(ImagePreprocessing):
    """Scale saturation: blend with per-pixel luma (ref ImageSaturation.scala,
    HSV-S channel scaling; implemented as luma blend which is the same to
    first order and stays vectorized)."""

    def __init__(self, delta_low: float = 0.5, delta_high: float = 1.5):
        self.low, self.high = delta_low, delta_high

    def apply_image(self, img):
        img = _to_float(img)
        f = random.uniform(self.low, self.high)
        luma = img @ np.array([0.299, 0.587, 0.114], np.float32)
        return img * f + (1.0 - f) * luma[..., None]


class ImageHue(ImagePreprocessing):
    """Rotate hue by a uniform angle in degrees (ref ImageHue.scala).

    Uses the YIQ rotation matrix trick so it stays a single matmul."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0):
        self.low, self.high = delta_low, delta_high

    def apply_image(self, img):
        img = _to_float(img)
        theta = np.deg2rad(random.uniform(self.low, self.high))
        c, s = np.cos(theta), np.sin(theta)
        # RGB->YIQ, rotate IQ, back. Precomposed constants.
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.322],
                          [0.211, -0.523, 0.312]], np.float32)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = (np.linalg.inv(t_yiq) @ rot @ t_yiq).astype(np.float32)
        return img @ m.T


class ImageColorJitter(ImagePreprocessing):
    """Random brightness/contrast/saturation in random order
    (ref ImageColorJitter.scala)."""

    def __init__(self, brightness_prob=0.5, brightness_delta=32.0,
                 contrast_prob=0.5, contrast_lower=0.5, contrast_upper=1.5,
                 saturation_prob=0.5, saturation_lower=0.5,
                 saturation_upper=1.5, hue_prob=0.5, hue_delta=18.0):
        self.ops = [
            (brightness_prob, ImageBrightness(-brightness_delta, brightness_delta)),
            (contrast_prob, ImageContrast(contrast_lower, contrast_upper)),
            (saturation_prob, ImageSaturation(saturation_lower, saturation_upper)),
            (hue_prob, ImageHue(-hue_delta, hue_delta)),
        ]

    def apply_image(self, img):
        ops = list(self.ops)
        random.shuffle(ops)
        for p, op in ops:
            if random.random() < p:
                img = op.apply_image(img)
        return img


class ImageExpand(ImagePreprocessing):
    """Place the image on a larger mean-filled canvas with a random expand
    ratio (ref ImageExpand.scala, used by SSD augmentation)."""

    def __init__(self, means_r=123, means_g=117, means_b=104,
                 min_expand_ratio=1.0, max_expand_ratio=4.0):
        self.mean = np.array([means_r, means_g, means_b], np.float32)
        self.min_ratio, self.max_ratio = min_expand_ratio, max_expand_ratio

    def apply_image(self, img):
        img = _to_float(img)
        ratio = random.uniform(self.min_ratio, self.max_ratio)
        h, w = img.shape[:2]
        out_h, out_w = int(h * ratio), int(w * ratio)
        y0 = random.randint(0, out_h - h)
        x0 = random.randint(0, out_w - w)
        canvas = np.broadcast_to(self.mean, (out_h, out_w, 3)).copy()
        canvas[y0:y0 + h, x0:x0 + w] = img
        return canvas


class ImageFiller(ImagePreprocessing):
    """Fill a (normalized) box with a constant value (ref ImageFiller.scala)."""

    def __init__(self, x1, y1, x2, y2, value: int = 255):
        self.box, self.value = (x1, y1, x2, y2), value

    def apply_image(self, img):
        img = np.array(img)
        h, w = img.shape[:2]
        x1, y1, x2, y2 = self.box
        img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return img


class ImageMirror(ImagePreprocessing):
    """Unconditional horizontal mirror (ref ImageMirror.scala — the always-on
    counterpart of ImageHFlip's random flip)."""

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])


class ImageChannelOrder(ImagePreprocessing):
    """Swap channel order, e.g. RGB<->BGR (ref ImageChannelOrder.scala)."""

    def apply_image(self, img):
        return np.ascontiguousarray(img[..., ::-1])


class PerImageNormalize(ImagePreprocessing):
    """Scale each image to [min, max] by its own range (ref
    pyzoo imagePreprocessing.py PerImageNormalize)."""

    def __init__(self, min_val: float = 0.0, max_val: float = 1.0):
        self.min_val, self.max_val = float(min_val), float(max_val)

    def apply_image(self, img):
        img = _to_float(img)
        lo, hi = float(img.min()), float(img.max())
        span = hi - lo
        if span == 0.0:
            return np.full_like(img, self.min_val)
        return (img - lo) / span * (self.max_val - self.min_val) + self.min_val


class ImageRandomPreprocessing(ImagePreprocessing):
    """Apply an inner transformer with probability p
    (ref ImageRandomPreprocessing.scala)."""

    def __init__(self, preprocessing: ImagePreprocessing, prob: float):
        self.inner, self.prob = preprocessing, prob

    def transform(self, feature):
        if random.random() < self.prob:
            return self.inner.transform(feature)
        return feature


class ImageMatToTensor(ImagePreprocessing):
    """Finalize to float32 HWC (channels-last; the reference's MatToTensor
    emits CHW for BigDL — TPU wants NHWC, so ``to_chw=False`` is default)."""

    def __init__(self, to_chw: bool = False):
        self.to_chw = to_chw

    def apply_image(self, img):
        img = _to_float(img)
        return np.transpose(img, (2, 0, 1)) if self.to_chw else img


class ImageSetToSample(ImagePreprocessing):
    """Pack image (+ optional label) into a training sample dict
    (ref ImageSetToSample.scala)."""

    def __init__(self, input_keys=("image",), target_keys: Optional[Tuple] = ("label",)):
        self.input_keys = tuple(input_keys)
        self.target_keys = tuple(target_keys) if target_keys else ()

    def transform(self, feature):
        feature = dict(feature)
        xs = [np.asarray(feature[k], np.float32) for k in self.input_keys]
        sample = {"x": xs[0] if len(xs) == 1 else xs}
        ys = [np.asarray(feature[k]) for k in self.target_keys if k in feature]
        if ys:
            sample["y"] = ys[0] if len(ys) == 1 else ys
        feature["sample"] = sample
        return feature


# ---- remaining reference spellings (ref imagePreprocessing.py) ----

# ref ImageBytesToMat: encoded image file bytes → image (our "Mat" is the
# HWC ndarray)
ImageBytesToMat = ImageBytesToArray


class ImagePixelBytesToMat(ImagePreprocessing):
    """Raw PIXEL bytes (not an encoded file) → HWC uint8 array
    (ref ImagePixelBytesToMat). Needs the target shape — either already
    present as ``feature['shape']`` (h, w, c) or passed here."""

    def __init__(self, byte_key: str = "bytes",
                 shape: Optional[Tuple[int, int, int]] = None):
        self.byte_key = byte_key
        self.shape = tuple(shape) if shape is not None else None

    def transform(self, feature: dict) -> dict:
        feature = dict(feature)
        shape = self.shape or tuple(feature.get("shape", ()))
        if not shape:
            raise ValueError(
                "ImagePixelBytesToMat needs the pixel layout: pass "
                "shape=(h, w, c) or put it in feature['shape']")
        buf = np.frombuffer(feature[self.byte_key], dtype=np.uint8)
        feature["image"] = buf.reshape(shape).copy()
        return feature


class ImagePixelNormalize(ImagePreprocessing):
    """Pixel-level normalize, data(i) = data(i) - mean(i), with ``means``
    flat in H*W*C order (ref ImagePixelNormalize — same math as
    ImagePixelNormalizer, which takes the mean IMAGE instead)."""

    def __init__(self, means: Sequence[float]):
        self.means = np.asarray(means, np.float32)

    def apply_image(self, img):
        img = _to_float(img)
        return img - self.means.reshape(img.shape)


class ImageFeatureToTensor(ImagePreprocessing):
    """ImageFeature → bare image tensor (ref ImageFeatureToTensor: the
    JVM Sample plumbing collapses to returning the float array)."""

    def transform(self, feature: dict):
        return _to_float(feature["image"])


class ImageFeatureToSample(ImagePreprocessing):
    """ImageFeature → ``{"x": image, "y": label?}`` sample dict
    (ref ImageFeatureToSample; equivalent to ImageSetToSample but
    returning the sample itself)."""

    def __init__(self, input_keys=("image",), target_keys=("label",)):
        self._pack = ImageSetToSample(input_keys, target_keys)

    def transform(self, feature: dict):
        return self._pack.transform(feature)["sample"]


class RowToImageFeature(ImagePreprocessing):
    """Tabular row (dict / pandas Series with image bytes) → ImageFeature
    dict (ref RowToImageFeature converts a Spark Row; the pandas-sharded
    data layer's rows land here)."""

    def __init__(self, bytes_col: str = "image", uri_col: str = "uri",
                 label_col: Optional[str] = "label"):
        self.bytes_col, self.uri_col, self.label_col = \
            bytes_col, uri_col, label_col

    def transform(self, row) -> dict:
        get = row.get if hasattr(row, "get") else row.__getitem__
        data = get(self.bytes_col)
        if data is None:
            raise KeyError(
                f"RowToImageFeature: row has no {self.bytes_col!r} column "
                f"(available: {list(row.keys()) if hasattr(row, 'keys') else '?'})")
        feature = {"bytes": data}
        try:
            uri = get(self.uri_col)
            if uri is not None:
                feature["uri"] = uri
        except (KeyError, IndexError):
            pass
        if self.label_col is not None:
            try:
                label = get(self.label_col)
                if label is not None:
                    feature["label"] = label
            except (KeyError, IndexError):
                pass
        return feature


__all__ += ["ImageBytesToMat", "ImagePixelBytesToMat", "ImagePixelNormalize",
            "ImageFeatureToTensor", "ImageFeatureToSample",
            "RowToImageFeature"]
