"""ImageClassifier — named CNN architectures on the port's keras engine.

Counterpart of ``analytics_zoo_tpu/models/image/imageclassification/
image_classifier.py`` (ref ``pyzoo/zoo/models/image/imageclassification/
image_classifier.py`` and Scala ``ImageClassificationConfig``): the same
surface builds the same graphs, layer for layer, so the parameter and
``batch_stats`` trees carry the JAX package's names (``conv2d_1``,
``batchnormalization_1``, ...) and ``convert.py`` maps one onto the other.
Inputs are JAX's channels-last ``[batch, h, w, channels]``.

All thirteen of JAX's architectures: the compact ``lenet``, ``vgg-lite``,
``mobilenet`` (``SeparableConv2D``) and ``resnet-lite``, and the
reference set's ``alexnet``, ``vgg-16``, ``vgg-19``, ``resnet-50``
(torchvision's v1.5 layout, explicit symmetric padding, bias-free
convolutions, BN eps 1e-5 and momentum 0.9), ``inception-v1`` (with
``LRN2D``), ``squeezenet`` (1.1), ``densenet-121`` / ``densenet-161``
and ``mobilenet-v2`` (its depthwise convolutions a grouped
``flax_compat.Conv`` through ``KerasLayerWrapper``; relu6, dropout 0.2).

``pretrained=`` (a torchvision-layout state dict, a module or a
``torch.save`` path) imports through ``models/migration_image.py``;
``predict_image_set`` predicts an ``ImageSet`` (``feature/image``);
``preprocessor(model_name, source)`` gives a model's preprocessing chain
and ``LabelOutput`` turns predictions into sorted class names and
probabilities.

``dtype="mixed_bfloat16"`` builds every layer under that policy
(keras/policy.py): the convolutions, Denses and batch norms compute in
bf16 while the parameters and the batch norms' statistics stay fp32.
"""

from __future__ import annotations

import numpy as np

from analytics_zoo_tpu_torch.keras import Input, Model
from analytics_zoo_tpu_torch.keras import layers as zl
from analytics_zoo_tpu_torch.models.common import ZooModel, registry


def _lenet(inp, class_num):
    h = zl.Conv2D(20, 5, 5, activation="relu", border_mode="same")(inp)
    h = zl.MaxPooling2D((2, 2))(h)
    h = zl.Conv2D(50, 5, 5, activation="relu", border_mode="same")(h)
    h = zl.MaxPooling2D((2, 2))(h)
    h = zl.Flatten()(h)
    h = zl.Dense(500, activation="relu")(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _vgg_lite(inp, class_num):
    h = inp
    for filters in (32, 64, 128):
        h = zl.Conv2D(filters, 3, 3, activation="relu",
                      border_mode="same")(h)
        h = zl.Conv2D(filters, 3, 3, activation="relu",
                      border_mode="same")(h)
        h = zl.MaxPooling2D((2, 2))(h)
    h = zl.GlobalAveragePooling2D()(h)
    h = zl.Dense(256, activation="relu")(h)
    h = zl.Dropout(0.5)(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _mobilenet(inp, class_num):
    h = zl.Conv2D(32, 3, 3, subsample=(2, 2), activation="relu",
                  border_mode="same")(inp)
    for filters, stride in ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1)):
        h = zl.SeparableConv2D(filters, 3, 3, subsample=(stride, stride),
                               activation="relu", border_mode="same")(h)
    h = zl.GlobalAveragePooling2D()(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _resnet_lite(inp, class_num):
    def block(x, filters, stride):
        y = zl.Conv2D(filters, 3, 3, subsample=(stride, stride),
                      border_mode="same")(x)
        y = zl.BatchNormalization()(y)
        y = zl.Activation("relu")(y)
        y = zl.Conv2D(filters, 3, 3, border_mode="same")(y)
        y = zl.BatchNormalization()(y)
        shortcut = x
        if stride != 1:
            shortcut = zl.Conv2D(filters, 1, 1, subsample=(stride, stride),
                                 border_mode="same")(x)
        out = zl.merge([y, shortcut], mode="sum")
        return zl.Activation("relu")(out)

    h = zl.Conv2D(32, 3, 3, activation="relu", border_mode="same")(inp)
    for filters, stride in ((32, 1), (64, 2), (128, 2)):
        h = block(h, filters, stride)
    h = zl.GlobalAveragePooling2D()(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _alexnet(inp, class_num):
    # torchvision AlexNet: explicit symmetric padding, no LRN
    h = zl.Conv2D(64, 11, 11, subsample=(4, 4), activation="relu",
                  border_mode=2)(inp)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = zl.Conv2D(192, 5, 5, activation="relu", border_mode=2)(h)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = zl.Conv2D(384, 3, 3, activation="relu", border_mode=1)(h)
    h = zl.Conv2D(256, 3, 3, activation="relu", border_mode=1)(h)
    h = zl.Conv2D(256, 3, 3, activation="relu", border_mode=1)(h)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = zl.Flatten()(h)
    h = zl.Dropout(0.5)(h)
    h = zl.Dense(4096, activation="relu")(h)
    h = zl.Dropout(0.5)(h)
    h = zl.Dense(4096, activation="relu")(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _vgg(depth):
    cfg = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}[depth]

    def build(inp, class_num):
        h = inp
        for n_convs, filters in zip(cfg, (64, 128, 256, 512, 512)):
            for _ in range(n_convs):
                h = zl.Conv2D(filters, 3, 3, activation="relu",
                              border_mode="same")(h)
            h = zl.MaxPooling2D((2, 2))(h)
        h = zl.Flatten()(h)
        h = zl.Dense(4096, activation="relu")(h)
        h = zl.Dropout(0.5)(h)
        h = zl.Dense(4096, activation="relu")(h)
        h = zl.Dropout(0.5)(h)
        return zl.Dense(class_num, activation="softmax")(h)
    return build


def _resnet50(inp, class_num):
    # torchvision ResNet-50 v1.5: the stride-2 sits on the 3x3 conv2
    def bottleneck(x, filters, stride, project):
        y = zl.Conv2D(filters, 1, 1, bias=False)(x)
        y = zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(y)
        y = zl.Activation("relu")(y)
        y = zl.Conv2D(filters, 3, 3, subsample=(stride, stride),
                      border_mode=1, bias=False)(y)
        y = zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(y)
        y = zl.Activation("relu")(y)
        y = zl.Conv2D(filters * 4, 1, 1, bias=False)(y)
        y = zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(y)
        shortcut = x
        if project:
            shortcut = zl.Conv2D(filters * 4, 1, 1,
                                 subsample=(stride, stride),
                                 bias=False)(x)
            shortcut = zl.BatchNormalization(epsilon=1e-5,
                                             momentum=0.9)(shortcut)
        return zl.Activation("relu")(zl.merge([y, shortcut], mode="sum"))

    h = zl.Conv2D(64, 7, 7, subsample=(2, 2), border_mode=3,
                  bias=False)(inp)
    h = zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(h)
    h = zl.Activation("relu")(h)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode=1)(h)
    for stage, (filters, blocks) in enumerate(
            zip((64, 128, 256, 512), (3, 4, 6, 3))):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            h = bottleneck(h, filters, stride, project=(i == 0))
    h = zl.GlobalAveragePooling2D()(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _inception_v1(inp, class_num):
    def module(x, f1, f3r, f3, f5r, f5, pp):
        b1 = zl.Conv2D(f1, 1, 1, activation="relu", border_mode="same")(x)
        b3 = zl.Conv2D(f3r, 1, 1, activation="relu", border_mode="same")(x)
        b3 = zl.Conv2D(f3, 3, 3, activation="relu", border_mode="same")(b3)
        b5 = zl.Conv2D(f5r, 1, 1, activation="relu", border_mode="same")(x)
        b5 = zl.Conv2D(f5, 5, 5, activation="relu", border_mode="same")(b5)
        bp = zl.MaxPooling2D((3, 3), strides=(1, 1),
                             border_mode="same")(x)
        bp = zl.Conv2D(pp, 1, 1, activation="relu", border_mode="same")(bp)
        return zl.merge([b1, b3, b5, bp], mode="concat", concat_axis=-1)

    h = zl.Conv2D(64, 7, 7, subsample=(2, 2), activation="relu",
                  border_mode="same")(inp)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(h)
    h = zl.LRN2D()(h)
    h = zl.Conv2D(64, 1, 1, activation="relu", border_mode="same")(h)
    h = zl.Conv2D(192, 3, 3, activation="relu", border_mode="same")(h)
    h = zl.LRN2D()(h)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(h)
    h = module(h, 64, 96, 128, 16, 32, 32)        # 3a
    h = module(h, 128, 128, 192, 32, 96, 64)      # 3b
    h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(h)
    h = module(h, 192, 96, 208, 16, 48, 64)       # 4a
    h = module(h, 160, 112, 224, 24, 64, 64)      # 4b
    h = module(h, 128, 128, 256, 24, 64, 64)      # 4c
    h = module(h, 112, 144, 288, 32, 64, 64)      # 4d
    h = module(h, 256, 160, 320, 32, 128, 128)    # 4e
    h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(h)
    h = module(h, 256, 160, 320, 32, 128, 128)    # 5a
    h = module(h, 384, 192, 384, 48, 128, 128)    # 5b
    h = zl.GlobalAveragePooling2D()(h)
    h = zl.Dropout(0.4)(h)
    return zl.Dense(class_num, activation="softmax")(h)


def _squeezenet(inp, class_num):
    # torchvision SqueezeNet 1.1
    def fire(x, squeeze, expand):
        s = zl.Conv2D(squeeze, 1, 1, activation="relu")(x)
        e1 = zl.Conv2D(expand, 1, 1, activation="relu")(s)
        e3 = zl.Conv2D(expand, 3, 3, activation="relu",
                       border_mode=1)(s)
        return zl.merge([e1, e3], mode="concat", concat_axis=-1)

    h = zl.Conv2D(64, 3, 3, subsample=(2, 2), activation="relu")(inp)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = fire(h, 16, 64)
    h = fire(h, 16, 64)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = fire(h, 32, 128)
    h = fire(h, 32, 128)
    h = zl.MaxPooling2D((3, 3), strides=(2, 2))(h)
    h = fire(h, 48, 192)
    h = fire(h, 48, 192)
    h = fire(h, 64, 256)
    h = fire(h, 64, 256)
    h = zl.Dropout(0.5)(h)
    h = zl.Conv2D(class_num, 1, 1, activation="relu")(h)
    h = zl.GlobalAveragePooling2D()(h)
    return zl.Activation("softmax")(h)


def _densenet(depth):
    growth = 48 if depth == 161 else 32
    blocks = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24)}[depth]
    init_f = 2 * growth

    def build(inp, class_num):
        # torchvision DenseNet: BN eps 1e-5, bias-free convolutions
        def bn(x):
            return zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(x)

        def dense_layer(x):
            y = bn(x)
            y = zl.Activation("relu")(y)
            y = zl.Conv2D(4 * growth, 1, 1, bias=False)(y)
            y = bn(y)
            y = zl.Activation("relu")(y)
            y = zl.Conv2D(growth, 3, 3, border_mode=1, bias=False)(y)
            return zl.merge([x, y], mode="concat", concat_axis=-1)

        h = zl.Conv2D(init_f, 7, 7, subsample=(2, 2), border_mode=3,
                      bias=False)(inp)
        h = bn(h)
        h = zl.Activation("relu")(h)
        h = zl.MaxPooling2D((3, 3), strides=(2, 2), border_mode=1)(h)
        ch = init_f
        for bi, n_layers in enumerate(blocks):
            for _ in range(n_layers):
                h = dense_layer(h)
                ch += growth
            if bi < len(blocks) - 1:               # transition, 0.5x
                ch = ch // 2
                h = bn(h)
                h = zl.Activation("relu")(h)
                h = zl.Conv2D(ch, 1, 1, bias=False)(h)
                h = zl.AveragePooling2D((2, 2))(h)
        h = bn(h)
        h = zl.Activation("relu")(h)
        h = zl.GlobalAveragePooling2D()(h)
        return zl.Dense(class_num, activation="softmax")(h)
    return build


def _depthwise(ch, stride):
    """A depthwise 3x3 (no pointwise): a grouped ``flax_compat.Conv``
    wrapped as a keras layer (SeparableConv2D would fuse a pointwise with
    no norm or activation between, which is not the MobileNetV2 block).
    Explicit pad 1, not "same", for torchvision parity at stride 2. As
    JAX's wrapped ``nn.Conv`` it has no dtype of its own: under
    ``mixed_bfloat16`` a bf16 input meets its fp32 kernel in fp32."""
    from analytics_zoo_tpu_torch.common.flax_compat import Conv
    return zl.KerasLayerWrapper(Conv(
        ch, ch, (3, 3), bias=False, strides=(stride, stride),
        padding=((1, 1), (1, 1)), feature_group_count=ch))


def _mobilenet_v2(inp, class_num):
    # torchvision MobileNetV2: bias-free convolutions and BN eps 1e-5,
    # explicit pad 1 on the spatial convolutions, a dropout-0.2 head
    def bn(x):
        return zl.BatchNormalization(epsilon=1e-5, momentum=0.9)(x)

    def inverted(x, in_ch, out_ch, stride, expand):
        hid = in_ch * expand
        y = x
        if expand != 1:
            y = zl.Conv2D(hid, 1, 1, bias=False)(y)
            y = bn(y)
            y = zl.Activation("relu6")(y)
        # depthwise, norm, relu6, then the linear 1x1 projection
        y = _depthwise(hid, stride)(y)
        y = bn(y)
        y = zl.Activation("relu6")(y)
        y = zl.Conv2D(out_ch, 1, 1, bias=False)(y)
        y = bn(y)
        if stride == 1 and in_ch == out_ch:
            return zl.merge([x, y], mode="sum")
        return y

    h = zl.Conv2D(32, 3, 3, subsample=(2, 2), border_mode=1,
                  bias=False)(inp)
    h = bn(h)
    h = zl.Activation("relu6")(h)
    ch = 32
    for out_ch, n, stride, expand in ((16, 1, 1, 1), (24, 2, 2, 6),
                                      (32, 3, 2, 6), (64, 4, 2, 6),
                                      (96, 3, 1, 6), (160, 3, 2, 6),
                                      (320, 1, 1, 6)):
        for i in range(n):
            h = inverted(h, ch, out_ch, stride if i == 0 else 1, expand)
            ch = out_ch
    h = zl.Conv2D(1280, 1, 1, bias=False)(h)
    h = bn(h)
    h = zl.Activation("relu6")(h)
    h = zl.GlobalAveragePooling2D()(h)
    h = zl.Dropout(0.2)(h)
    return zl.Dense(class_num, activation="softmax")(h)


_ARCHS = {
    # compact architectures for small inputs
    "lenet": _lenet, "vgg-lite": _vgg_lite, "mobilenet": _mobilenet,
    "resnet-lite": _resnet_lite,
    # the reference model set (ImageClassificationConfig.scala:33-51)
    "alexnet": _alexnet, "vgg-16": _vgg(16), "vgg-19": _vgg(19),
    "resnet-50": _resnet50, "inception-v1": _inception_v1,
    "squeezenet": _squeezenet, "densenet-121": _densenet(121),
    "densenet-161": _densenet(161), "mobilenet-v2": _mobilenet_v2,
}


@registry.register
class ImageClassifier(ZooModel):
    """(ref image_classifier.py ImageClassifier(model_name); predict over
    ``[batch, h, w, channels]`` arrays or an ImageSet)"""

    def __init__(self, class_num: int, model_name: str = "resnet-lite",
                 image_size: int = 224, channels: int = 3,
                 pretrained=None, dtype: str = "float32"):
        super().__init__()
        if model_name not in _ARCHS:
            raise ValueError(
                f"unknown model_name {model_name!r}; one of {list(_ARCHS)}")
        self.class_num = int(class_num)
        self.model_name = model_name
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.dtype = dtype
        from analytics_zoo_tpu_torch.keras import policy as _policy
        with _policy.policy_scope(dtype):
            self.model = self.build_model()
        if pretrained is not None:
            # a torchvision-layout state dict, module or torch.save path
            from analytics_zoo_tpu_torch.models.migration_image import (
                import_image_classifier_from_torch,
            )
            import_image_classifier_from_torch(self, pretrained)

    def build_model(self):
        inp = Input(shape=(self.image_size, self.image_size, self.channels))
        out = _ARCHS[self.model_name](inp, self.class_num)
        return Model(input=inp, output=out)

    def predict_image_set(self, image_set, batch_size: int = 32,
                          device=None):
        """Class probabilities for every image of an ImageSet (its images
        already ``image_size`` square, as a preprocessing chain leaves
        them)."""
        images = np.stack(image_set.get_image()).astype(np.float32)
        return self.predict(images, batch_size=batch_size, device=device)

    def predict_classes(self, x, batch_size: int = 32, device=None):
        probs = np.asarray(self.predict(x, batch_size=batch_size,
                                        device=device))
        return np.argmax(probs, axis=-1)

    def _config(self):
        return dict(class_num=self.class_num, model_name=self.model_name,
                    image_size=self.image_size, channels=self.channels,
                    dtype=self.dtype)


# ---- per-model preprocessing presets and the labelled output ----------
# (ref ImageClassificationConfig.scala ImagenetConfig:62-160: each model
# name maps to resize -> crop -> channel-normalize constants;
# LabelOutput.scala turns predictions into sorted (class, probability))

#: (resize, crop, mean RGB, scale) per model: the reference's imagenet
#: presets
PREPROCESS_CONFIGS = {
    "alexnet": (256, 227, (123.0, 117.0, 104.0), 1.0),
    "inception-v1": (256, 224, (123.0, 117.0, 104.0), 1.0),
    "inception-v3": (320, 299, (128.0, 128.0, 128.0), 1.0 / 128.0),
    "resnet-50": (256, 224, (123.0, 117.0, 104.0), 1.0),
    "vgg-16": (256, 224, (123.0, 117.0, 104.0), 1.0),
    "vgg-19": (256, 224, (123.0, 117.0, 104.0), 1.0),
    "densenet-121": (256, 224, (123.0, 117.0, 104.0), 0.017),
    "densenet-161": (256, 224, (123.0, 117.0, 104.0), 0.017),
    "squeezenet": (256, 227, (123.0, 117.0, 104.0), 1.0),
    "mobilenet": (256, 224, (123.68, 116.78, 103.94), 0.017),
    "mobilenet-v2": (256, 224, (123.68, 116.78, 103.94), 0.017),
}


def preprocessor(model_name: str, source: str = "imagenet"):
    """The reference's per-model imagenet chain
    (ImagenetConfig.commonPreprocessor): resize, center crop, channel
    mean subtracted and scaled, as a ChainedPreprocessing over
    ImageFeature dicts.

    ``source="torchvision"``: the normalization trained into torchvision
    checkpoints (the short edge to 256 keeping the aspect, a center crop
    of 224, then ``(x / 255 - mean) / std`` with mean (0.485, 0.456,
    0.406) and std (0.229, 0.224, 0.225)), for
    ``ImageClassifier(pretrained=...)`` weights."""
    from analytics_zoo_tpu_torch.feature.image import (
        ChainedPreprocessing, ImageAspectScale, ImageCenterCrop,
        ImageChannelNormalize, ImageChannelScaledNormalizer,
        ImageMatToTensor, ImageResize,
    )
    if source not in ("imagenet", "torchvision"):
        raise ValueError(f"unknown preprocessing source {source!r}; "
                         f"use 'imagenet' or 'torchvision'")
    if model_name not in PREPROCESS_CONFIGS:
        raise ValueError(f"no preprocessing preset for {model_name!r}; "
                         f"have {sorted(PREPROCESS_CONFIGS)}")
    if source == "torchvision":
        crop = 224
        # (x - 255 m) / (255 s) is normalize(x / 255)
        norm = ImageChannelNormalize(
            255 * 0.485, 255 * 0.456, 255 * 0.406,
            255 * 0.229, 255 * 0.224, 255 * 0.225)
        return ChainedPreprocessing([
            ImageAspectScale(256, max_size=10_000),
            ImageCenterCrop(crop, crop),
            norm, ImageMatToTensor(),
        ])
    resize, crop, mean, scale = PREPROCESS_CONFIGS[model_name]
    return ChainedPreprocessing([
        ImageResize(resize, resize),
        ImageCenterCrop(crop, crop),
        # (x - mean) * scale, the reference's commonPreprocessor
        ImageChannelScaledNormalizer(*mean, scale),
        ImageMatToTensor(),
    ])


class LabelOutput:
    """Predictions as class names and probabilities, sorted descending
    (ref LabelOutput.scala: the label map, the ``clses`` / ``probs``
    keys, a softmax first when the output is not already a
    distribution)."""

    def __init__(self, label_map, clses: str = "classes",
                 probs: str = "probs", prob_as_output: bool = True):
        self.label_map = dict(label_map)
        self.clses, self.probs = clses, probs
        self.prob_as_output = bool(prob_as_output)

    def __call__(self, predictions: np.ndarray, top_k: int = None):
        """``[b, C]`` predictions as a list of ``{clses: [names...],
        probs: [values...]}`` dicts, by probability descending."""
        preds = np.asarray(predictions)
        if preds.ndim == 1:
            preds = preds[None]
        if not self.prob_as_output:
            e = np.exp(preds - preds.max(axis=-1, keepdims=True))
            preds = e / e.sum(axis=-1, keepdims=True)
        out = []
        for row in preds:
            order = np.argsort(-row)
            if top_k:
                order = order[:top_k]
            out.append({
                self.clses: [self.label_map.get(int(i), str(int(i)))
                             for i in order],
                self.probs: row[order].astype(np.float32),
            })
        return out
