"""ImageClassifier — named CNN architectures on the port's keras engine.

Counterpart of ``analytics_zoo_tpu/models/image/imageclassification/
image_classifier.py`` (ref ``pyzoo/zoo/models/image/imageclassification/
image_classifier.py`` and Scala ``ImageClassificationConfig``): the same
surface builds the same graphs, layer for layer, so the parameter and
``batch_stats`` trees carry the JAX package's names (``conv2d_1``,
``batchnormalization_1``, ...) and ``convert.py`` maps one onto the other.
Inputs are JAX's channels-last ``[batch, h, w, channels]``.

Ported architectures: the compact ``lenet``, ``vgg-lite``,
``resnet-lite`` and the reference set's ``alexnet``, ``vgg-16``,
``vgg-19``, ``resnet-50`` (torchvision's v1.5 layout, explicit symmetric
padding, bias-free convolutions, BN eps 1e-5 and momentum 0.9),
``squeezenet`` (1.1) and ``densenet-121`` / ``densenet-161``. The rest
need layers the port does not have yet and raise naming ROADMAP A11:
``mobilenet`` (``SeparableConv2D``), ``inception-v1`` (``LRN2D``) and
``mobilenet-v2`` (a grouped ``nn.Conv`` through ``KerasLayerWrapper``).
``pretrained=`` (torchvision state dicts, JAX ``models/migration_image.py``)
and ``predict_image_set`` (an ``ImageSet``, JAX ``feature/image``) raise
naming their ROADMAP items.

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


_ARCHS = {
    "lenet": _lenet, "vgg-lite": _vgg_lite, "resnet-lite": _resnet_lite,
    "alexnet": _alexnet, "vgg-16": _vgg(16), "vgg-19": _vgg(19),
    "resnet-50": _resnet50, "squeezenet": _squeezenet,
    "densenet-121": _densenet(121), "densenet-161": _densenet(161),
}

#: the JAX package's other architectures and the layer each waits for
_NOT_PORTED = {
    "mobilenet": "SeparableConv2D",
    "inception-v1": "LRN2D",
    "mobilenet-v2": "a grouped nn.Conv (KerasLayerWrapper)",
}


@registry.register
class ImageClassifier(ZooModel):
    """(ref image_classifier.py ImageClassifier(model_name); predict over
    ``[batch, h, w, channels]`` arrays)"""

    def __init__(self, class_num: int, model_name: str = "resnet-lite",
                 image_size: int = 224, channels: int = 3,
                 pretrained=None, dtype: str = "float32"):
        super().__init__()
        if model_name in _NOT_PORTED:
            raise ValueError(
                f"model_name {model_name!r} needs "
                f"{_NOT_PORTED[model_name]}, which the port does not have "
                f"yet (ROADMAP A11); ported: {list(_ARCHS)}")
        if model_name not in _ARCHS:
            raise ValueError(
                f"unknown model_name {model_name!r}; one of "
                f"{list(_ARCHS) + list(_NOT_PORTED)}")
        if pretrained is not None:
            raise NotImplementedError(
                "pretrained= (torchvision state dicts, "
                "models/migration_image.py) is not ported yet: ROADMAP "
                "A15's remainder, migration_image")
        self.class_num = int(class_num)
        self.model_name = model_name
        self.image_size = int(image_size)
        self.channels = int(channels)
        self.dtype = dtype
        from analytics_zoo_tpu_torch.keras import policy as _policy
        with _policy.policy_scope(dtype):
            self.model = self.build_model()

    def build_model(self):
        inp = Input(shape=(self.image_size, self.image_size, self.channels))
        out = _ARCHS[self.model_name](inp, self.class_num)
        return Model(input=inp, output=out)

    def predict_image_set(self, image_set, batch_size: int = 32):
        raise NotImplementedError(
            "predict_image_set needs the ImageSet of feature/image, which "
            "the port does not have yet (ROADMAP A11); pass the images as "
            "an array to predict")

    def predict_classes(self, x, batch_size: int = 32, device=None):
        probs = np.asarray(self.predict(x, batch_size=batch_size,
                                        device=device))
        return np.argmax(probs, axis=-1)

    def _config(self):
        return dict(class_num=self.class_num, model_name=self.model_name,
                    image_size=self.image_size, channels=self.channels,
                    dtype=self.dtype)
