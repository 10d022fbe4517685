"""SSDLite, SSD300-VGG and the ObjectDetector predict wrapper.

Counterpart of ``analytics_zoo_tpu/models/image/objectdetection/
object_detector.py`` (ref Scala ``models/image/objectdetection/``, the
SSD VGG graphs and ``ObjectDetector.scala``): the same keras graphs,
layer for layer, so the parameter and ``batch_stats`` trees carry JAX's
names and ``convert.py`` maps one onto the other. The loc/conf heads of
every source concatenate into one output ``[b, A, 4 + C + 1]`` computed
on the device; the anchor decode and NMS run on the host
(``bbox_util.detect_post_process``) over that small output.

A head's ``[b, h, w, A_cell * k]`` output is reshaped to ``[b, h * w *
A_cell, k]``: cells row-major, then the anchors of a cell, the order of
``bbox_util.ssd_pytorch_priors`` and ``generate_anchors``.

SSD300-VGG's conv4_3 L2Norm is :class:`L2Norm` under ``KerasLayerWrapper``
(flax leaf ``scale``, the port's ``weight``), JAX's arithmetic ``x /
sqrt(sum x^2 + 1e-10) * w``; ssd.pytorch's (and the twin's in
``migration_image``) adds the 1e-10 after the root, a difference the
two packages share.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry
from analytics_zoo_tpu_torch.models.image.objectdetection import bbox_util
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
    import MultiBoxLoss


class _SSDBase(ZooModel):
    """Shared SSD surface: the multibox loss, ground-truth encoding and
    the per-source loc/conf heads."""

    @property
    def n_anchors(self) -> int:
        return len(self.anchors)

    def _build_heads(self, sources, C1: int):
        heads: List = []
        for fm, ratios in zip(sources, self.ratios_per_layer):
            A = bbox_util.anchors_per_cell(ratios)
            loc = zl.Conv2D(A * 4, 3, 3, border_mode="same")(fm)
            conf = zl.Conv2D(A * C1, 3, 3, border_mode="same")(fm)
            loc = zl.Lambda(_reshape_head(4))(loc)       # [b, cells*A, 4]
            conf = zl.Lambda(_reshape_head(C1))(conf)    # [b, cells*A, C+1]
            heads.append(zl.merge([loc, conf], mode="concat",
                                  concat_axis=-1))
        return zl.merge(heads, mode="concat", concat_axis=1) \
            if len(heads) > 1 else heads[0]

    def loss(self, neg_pos_ratio: float = 3.0,
             loc_weight: float = 1.0) -> MultiBoxLoss:
        return MultiBoxLoss(self.class_num, neg_pos_ratio, loc_weight)

    def encode_ground_truth(self, gt_boxes_per_image, gt_labels_per_image
                            ) -> np.ndarray:
        """List of per-image (boxes [g,4], labels [g]) -> [b, A, 5]
        targets."""
        return np.stack([
            bbox_util.encode_targets(b, l, self.anchors)
            for b, l in zip(gt_boxes_per_image, gt_labels_per_image)])


@registry.register
class SSDLite(_SSDBase):
    """Small SSD over a strided separable-conv backbone; ``image_size``
    a multiple of 32, detection scales at strides 8/16/32."""

    def __init__(self, class_num: int, image_size: int = 128,
                 aspect_ratios: Sequence[float] = (1.0, 2.0, 0.5)):
        super().__init__()
        if image_size % 32 != 0:
            raise ValueError("image_size must be a multiple of 32")
        self.class_num = int(class_num)
        self.image_size = int(image_size)
        self.fm_sizes = [image_size // 8, image_size // 16, image_size // 32]
        ratios_in = list(aspect_ratios)
        self.ratios_per_layer = bbox_util.per_layer_ratios(
            ratios_in, len(self.fm_sizes))
        flat_input = not (ratios_in and isinstance(
            ratios_in[0], (list, tuple, np.ndarray)))
        self.aspect_ratios = self.ratios_per_layer[0] if flat_input \
            else [list(r) for r in self.ratios_per_layer]
        self.scales = [0.15, 0.35, 0.6, 0.85]
        self.anchors = bbox_util.generate_anchors(self.fm_sizes, self.scales,
                                                  self.ratios_per_layer)
        self.model = self.build_model()

    def build_model(self):
        C1 = self.class_num + 1
        inp = Input(shape=(self.image_size, self.image_size, 3))

        def conv_block(x, filters, stride):
            x = zl.SeparableConv2D(filters, 3, 3, subsample=(stride, stride),
                                   border_mode="same")(x)
            x = zl.BatchNormalization()(x)
            return zl.Activation("relu")(x)

        h = zl.Conv2D(16, 3, 3, subsample=(2, 2), activation="relu",
                      border_mode="same")(inp)            # /2
        h = conv_block(h, 32, 2)                          # /4
        f8 = conv_block(h, 64, 2)                         # /8
        f16 = conv_block(f8, 128, 2)                      # /16
        f32 = conv_block(f16, 128, 2)                     # /32
        out = self._build_heads((f8, f16, f32), C1)
        return Model(input=inp, output=out)

    def _config(self):
        return dict(class_num=self.class_num, image_size=self.image_size,
                    aspect_ratios=list(self.aspect_ratios))


def _reshape_head(last_dim):
    def fn(x):
        return x.reshape(x.shape[0], -1, last_dim)
    return fn


class L2Norm(nn.Module):
    """SSD's conv4_3 L2Norm (ParseNet): ``x / sqrt(sum_c x^2 + 1e-10) *
    w`` over the channel axis, ``w`` per channel from ``init_scale``.
    flax names ``w`` ``scale``; here it is ``weight`` (convert.py's rule
    for ``scale``)."""

    def __init__(self, channels: int, init_scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((int(channels),),
                                              float(init_scale)))

    def flax_tree_leaves(self):
        return {"scale": ("weight", tuple(self.weight.shape))}

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-10)
        return x / norm * self.weight.to(x.dtype)


def _l2norm_layer(channels: int, scale: float = 20.0):
    return zl.KerasLayerWrapper(L2Norm(channels, scale))


@registry.register
class SSD300VGG(_SSDBase):
    """SSD300 with a VGG-16 backbone in ssd.pytorch's layout: VGG convs
    through conv4_3 (pool3 ceil-mode), L2Norm(512, 20) on conv4_3, pool5
    3x3/s1/p1, the dilated conv6 (1024, rate 6, pad 6), conv7 1x1, the
    8-conv extras and 3x3 loc/conf heads over six sources with
    (4, 6, 6, 6, 4, 4) anchors a cell: 8732 anchors
    (``bbox_util.ssd_pytorch_priors``). Output ``[b, 8732, 4 + class_num
    + 1]``. ``migration_image.import_ssd300_from_torch`` loads an
    ssd.pytorch state dict."""

    def __init__(self, class_num: int):
        super().__init__()
        self.class_num = int(class_num)
        self.image_size = 300
        self.anchors = bbox_util.ssd_pytorch_priors()
        self.ratios_per_layer = [
            list(r) for r in
            bbox_util.ANCHOR_CONFIGS["ssd300_vgg"]["aspect_ratios"]]
        self.model = self.build_model()

    def build_model(self):
        C1 = self.class_num + 1
        inp = Input(shape=(300, 300, 3))

        def conv(x, ch, k=3, pad=1, **kw):
            return zl.Conv2D(ch, k, k, activation="relu",
                             border_mode=pad, **kw)(x)

        h = conv(conv(inp, 64), 64)
        h = zl.MaxPooling2D((2, 2), strides=(2, 2))(h)          # 150
        h = conv(conv(h, 128), 128)
        h = zl.MaxPooling2D((2, 2), strides=(2, 2))(h)          # 75
        h = conv(conv(conv(h, 256), 256), 256)
        # pool3 is ceil-mode (75 -> 38): one more cell on the high side;
        # the input is post-ReLU, so the pad never wins the max
        h = zl.MaxPooling2D((2, 2), strides=(2, 2),
                            border_mode=((0, 1), (0, 1)))(h)    # 38
        h = conv(conv(conv(h, 512), 512), 512)
        src43 = h                                               # conv4_3
        h = zl.MaxPooling2D((2, 2), strides=(2, 2))(h)          # 19
        h = conv(conv(conv(h, 512), 512), 512)
        h = zl.MaxPooling2D((3, 3), strides=(1, 1),
                            border_mode=1)(h)                   # pool5, 19
        h = zl.AtrousConvolution2D(1024, 3, 3, atrous_rate=(6, 6),
                                   activation="relu",
                                   border_mode=6)(h)            # conv6
        h = conv(h, 1024, k=1, pad=0)                           # conv7
        src7 = h

        e = conv(h, 256, k=1, pad=0)
        src8 = conv(e, 512, subsample=(2, 2))                   # 10
        e = conv(src8, 128, k=1, pad=0)
        src9 = conv(e, 256, subsample=(2, 2))                   # 5
        e = conv(src9, 128, k=1, pad=0)
        src10 = conv(e, 256, pad=0)                             # 3
        e = conv(src10, 128, k=1, pad=0)
        src11 = conv(e, 256, pad=0)                             # 1

        norm43 = _l2norm_layer(512)(src43)
        sources = (norm43, src7, src8, src9, src10, src11)
        out = self._build_heads(sources, C1)
        return Model(input=inp, output=out)

    def _config(self):
        return dict(class_num=self.class_num)


class ObjectDetector:
    """Load/predict surface (ref ``ObjectDetector.scala``): the device
    forward of a detection ZooModel, then the host's decode and NMS; per
    image a ``[n_det, 6]`` array of (label, score, xmin, ymin, xmax,
    ymax) in normalized coordinates. ``device`` is where an uncompiled
    model predicts (default ``cuda``); a compiled one predicts on its
    compiled device."""

    def __init__(self, model: _SSDBase, conf_threshold: float = 0.3,
                 nms_threshold: float = 0.45, keep_top_k: int = 100,
                 device=None):
        self.model = model
        self.conf_threshold = conf_threshold
        self.nms_threshold = nms_threshold
        self.keep_top_k = keep_top_k
        self.device = device

    def forward(self, images: np.ndarray, batch_size: int = 16
                ) -> np.ndarray:
        """The raw head outputs ``[b, A, 4 + C + 1]`` (the device part)."""
        kw = {} if self.device is None else {"device": self.device}
        return np.asarray(self.model.predict(images, batch_size=batch_size,
                                             **kw))

    def post_process(self, raw: np.ndarray) -> List[np.ndarray]:
        """Decode and NMS of each image's raw output (the host part)."""
        out = []
        for pred in raw:
            loc, conf = pred[:, :4], pred[:, 4:]
            out.append(bbox_util.detect_post_process(
                loc, conf, self.model.anchors, self.model.class_num,
                self.conf_threshold, self.nms_threshold, self.keep_top_k))
        return out

    def predict(self, images: np.ndarray, batch_size: int = 16
                ) -> List[np.ndarray]:
        return self.post_process(self.forward(images, batch_size))

    def predict_image_set(self, image_set, batch_size: int = 16):
        images = np.stack(image_set.get_image()).astype(np.float32)
        return self.predict(images, batch_size=batch_size)

    @staticmethod
    def load_model(path: str, **kwargs) -> "ObjectDetector":
        model = ZooModel.load_model(path)
        return ObjectDetector(model, **kwargs)
