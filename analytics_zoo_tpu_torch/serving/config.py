"""Serving config — the reference's ``config.yaml`` surface (ref
zoo/.../serving/utils/ConfigParser.scala:27 and
scripts/cluster-serving/config.yaml: the model path, the broker's host
and port, the batch size, the record encryption flag).

The port's own copy of ``analytics_zoo_tpu/serving/config.py``: parsed
with PyYAML when it is installed, otherwise with a reader of the
two-level ``section: / key: value`` shape the serving config uses, into
the same ``ServingConfig``. The ``preprocessing:`` section (a ``preset``
and ``source``, or ``resize`` / ``crop`` / ``mean`` / ``scale``) builds
the engine's image chain (``build_image_preprocess``).
``record_encrypted: true`` (the reference's PPML flag) makes
``build_cipher`` return the AES-GCM cipher pair of
``common/encryption.make_cipher``, keyed by the secret passed or
``ZOO_SERVING_SECRET``; ``python -m
analytics_zoo_tpu_torch.serving.start`` hands it to the engine and the
frontend. Without the ``cryptography`` package building it raises
``ImportError`` naming the package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


def _parse_scalar(s: str):
    s = s.strip().strip('"').strip("'")
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _mini_yaml(text: str) -> dict:
    root: dict = {}
    section = None
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indented = line[0] in " \t"
        key, colon, val = line.strip().partition(":")
        if not colon:
            continue
        if not indented:
            if val.strip():
                root[key] = _parse_scalar(val)
                section = None
            else:
                section = root.setdefault(key, {})
        elif section is not None:
            section[key] = _parse_scalar(val)
    return root


def load_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        return yaml.safe_load(text) or {}
    except ImportError:
        return _mini_yaml(text)


@dataclass
class ServingConfig:
    model_path: str = ""
    broker_host: str = "127.0.0.1"
    broker_port: int = 6399
    batch_size: int = 8
    record_encrypted: bool = False
    stream: str = "serving_stream"
    result_key: str = "result"
    # the engine's raw-image preprocessing (ref PreProcessing.scala): a
    # preset name, or explicit resize/crop/mean/scale
    image_preset: Optional[str] = None
    image_source: str = "imagenet"
    image_resize: Optional[int] = None
    image_crop: Optional[int] = None
    image_mean: Optional[tuple] = None
    image_scale: float = 1.0

    @classmethod
    def load(cls, path: str) -> "ServingConfig":
        raw = load_yaml(path)
        model = raw.get("model", {}) or {}
        data = raw.get("data", {}) or {}
        params = raw.get("params", {}) or {}
        pre = raw.get("preprocessing", {}) or {}
        src = (data.get("src") or
               f"{cls.broker_host}:{cls.broker_port}")
        host, _, port = str(src).partition(":")
        mean = pre.get("mean")
        if isinstance(mean, str):
            mean = tuple(float(v) for v in mean.split(","))
        cfg = cls(
            model_path=model.get("path", "") or "",
            broker_host=host or "127.0.0.1",
            broker_port=int(port or 6399),
            batch_size=int(params.get("batch_size", 8) or 8),
            record_encrypted=bool(data.get("record_encrypted", False)),
            stream=data.get("stream", "serving_stream") or "serving_stream",
            result_key=data.get("result_key", "result") or "result",
            image_preset=pre.get("preset") or None,
            image_source=pre.get("source", "imagenet") or "imagenet",
            image_resize=(int(pre["resize"]) if pre.get("resize")
                          else None),
            image_crop=int(pre["crop"]) if pre.get("crop") else None,
            image_mean=mean,
            image_scale=float(pre.get("scale", 1.0) or 1.0))
        return cfg

    def build_cipher(self, secret: Optional[str] = None):
        """The AES-GCM (encrypt, decrypt) pair for encrypted records, or
        None when ``record_encrypted`` is off. ``secret`` defaults to
        ``ZOO_SERVING_SECRET``, which must then be set."""
        if not self.record_encrypted:
            return None
        import os

        from analytics_zoo_tpu_torch.common.encryption import make_cipher
        secret = secret or os.environ.get("ZOO_SERVING_SECRET")
        if not secret:
            raise ValueError("record_encrypted: true needs a secret "
                             "(ZOO_SERVING_SECRET)")
        return make_cipher(secret)

    def build_image_preprocess(self):
        """The engine's raw-image chain from this config, or None when no
        ``preprocessing:`` section was given."""
        if self.image_preset:
            from analytics_zoo_tpu_torch.serving.engine import image_pipeline
            return image_pipeline(self.image_preset,
                                  source=self.image_source)
        if not (self.image_resize or self.image_crop or self.image_mean
                or self.image_scale != 1.0):
            return None
        from analytics_zoo_tpu_torch.feature.image import (
            ChainedPreprocessing, ImageCenterCrop,
            ImageChannelScaledNormalizer, ImageMatToTensor, ImageResize,
        )
        steps = []
        if self.image_resize:
            steps.append(ImageResize(self.image_resize, self.image_resize))
        if self.image_crop:
            steps.append(ImageCenterCrop(self.image_crop, self.image_crop))
        if self.image_mean or self.image_scale != 1.0:
            mean = self.image_mean or (0.0, 0.0, 0.0)
            steps.append(ImageChannelScaledNormalizer(
                *mean, self.image_scale))
        steps.append(ImageMatToTensor())
        from analytics_zoo_tpu_torch.serving.engine import ndarray_chain
        return ndarray_chain(ChainedPreprocessing(steps))
