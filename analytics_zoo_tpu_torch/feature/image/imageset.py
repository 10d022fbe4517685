"""ImageSet: a sharded collection of image features.

The port's own copy of ``analytics_zoo_tpu/feature/image/imageset.py``
(ref ``zoo/.../feature/image/ImageSet.scala`` and
``pyzoo/zoo/feature/image/imageset.py``): an ImageSet wraps the port's
``data/shard.HostXShards`` of ImageFeature dicts; ``transform`` maps an
``ImagePreprocessing`` over every feature on the host, and
``to_dataset`` assembles fixed-shape batches for the estimator.
``ImageSet.read`` decodes files with PIL (``transforms.decode_rgb``)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.data.shard import HostXShards
from analytics_zoo_tpu_torch.feature.image.transforms import (
    ChainedPreprocessing, ImageBytesToArray, ImagePreprocessing,
)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")


class ImageFeature(dict):
    """An image record: keys ``image`` (HWC ndarray), optional ``label``,
    ``uri``, ``bytes``, ``sample`` (ref ImageFeature.scala keys)."""

    @property
    def image(self):
        return self.get("image")

    @property
    def label(self):
        return self.get("label")


class ImageSet:
    """Sharded collection of ImageFeatures.

    ``ImageSet.read(path)`` mirrors ref ``ImageSet.read`` (local path or
    folder; ``with_label`` derives integer labels from subfolder names the
    way the reference's NNImageReader examples do)."""

    def __init__(self, shards: HostXShards):
        self.shards = shards

    # ---------- constructors ----------

    @classmethod
    def from_arrays(cls, images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None,
                    num_shards: Optional[int] = None) -> "ImageSet":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature(image=np.asarray(img))
            if labels is not None:
                f["label"] = labels[i]
            feats.append(f)
        return cls(HostXShards.from_records(feats, num_shards))

    @classmethod
    def read(cls, path: str, with_label: bool = False,
             num_shards: Optional[int] = None) -> "ImageSet":
        """Read images from a file or directory (recursively). With
        ``with_label``, immediate subdirectory names become class labels
        (sorted order → 0..C-1)."""
        paths: List[str] = []
        if os.path.isfile(path):
            paths = [path]
        else:
            for root, dirs, files in os.walk(path):
                dirs.sort()  # deterministic order across filesystems/hosts
                for fn in sorted(files):
                    if fn.lower().endswith(_IMG_EXTS):
                        paths.append(os.path.join(root, fn))
        label_map = {}
        if with_label:
            # class = first path component under the root; files sitting
            # directly in the root have no class and are skipped
            def cls_of(p):
                rel = os.path.relpath(p, path)
                return rel.split(os.sep)[0] if os.sep in rel else None
            paths = [p for p in paths if cls_of(p) is not None]
            classes = sorted({cls_of(p) for p in paths})
            label_map = {c: i for i, c in enumerate(classes)}
        feats = []
        decoder = ImageBytesToArray()
        for p in paths:
            with open(p, "rb") as fh:
                f = ImageFeature(bytes=fh.read(), uri=p)
            f = ImageFeature(decoder.transform(f))
            if with_label:
                f["label"] = label_map[cls_of(p)]
            feats.append(f)
        return cls(HostXShards.from_records(feats, num_shards))

    # ---------- pipeline ----------

    def transform(self, transformer: ImagePreprocessing) -> "ImageSet":
        """Apply a (possibly chained) transformer to every image feature."""
        def apply(shard):
            return [ImageFeature(transformer.transform(f)) for f in shard]
        return ImageSet(self.shards.transform_shard(apply))

    def __or__(self, transformer: ImagePreprocessing) -> "ImageSet":
        return self.transform(transformer)

    def get_image(self) -> List[np.ndarray]:
        return [f["image"] for f in self._features()]

    def get_label(self) -> List:
        return [f.get("label") for f in self._features()]

    def _features(self) -> List[ImageFeature]:
        out = []
        for shard in self.shards.collect():
            out.extend(shard)
        return out

    def to_dataset(self):
        """Assemble into {'x','y'} ndarray XShards consumable by
        Estimator.fit (all images must share one shape by now)."""
        def get_y(f):
            if "sample" in f:
                return f["sample"].get("y")
            return f.get("label")

        def pack(shard):
            xs = np.stack([np.asarray(f["sample"]["x"] if "sample" in f
                                      else f["image"], np.float32)
                           for f in shard])
            out = {"x": xs}
            if shard and get_y(shard[0]) is not None:
                out["y"] = np.stack([np.asarray(get_y(f)) for f in shard])
            return out
        return self.shards.transform_shard(pack)


def chained(*transformers: ImagePreprocessing) -> ChainedPreprocessing:
    return ChainedPreprocessing(list(transformers))
