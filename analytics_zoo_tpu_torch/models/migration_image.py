"""Pretrained-weight import for the image model zoo, the port's copy.

Counterpart of ``analytics_zoo_tpu/models/migration_image.py`` (ref
``Net.scala:446`` loadModel and the per-model pretrained configs of
``ImageClassifier.scala``): the living public source of trained weights
for these architectures is torchvision, and ``ImageClassifier``'s
full-size architectures are built in torchvision's layout, so a
torchvision state dict imports exactly:

    clf = ImageClassifier(1000, "resnet-50", pretrained="resnet50.pt")
    # or pretrained=torch_model.state_dict(), or the module itself

Each supported architecture has a torch twin (``make_torch_*``, plain
``torch.nn`` modules) whose ``state_dict`` keys are torchvision's; the
tests hold each import to its twin. Supported: alexnet, vgg-16, vgg-19,
resnet-50, squeezenet (1.1), densenet-121, densenet-161, mobilenet-v2.
inception-v1 is refused: torchvision's googlenet is the BatchNorm
variant, another architecture than the reference's LRN v1.

Layouts (all into the flax tree, then ``convert.py`` into the module):
a convolution ``[out, in, kh, kw]`` to ``[kh, kw, in, out]`` (a depthwise
one ``[ch, 1, kh, kw]`` to ``[kh, kw, 1, ch]``), a linear ``[out, in]``
to ``[in, out]``, the first linear after a flatten with its input
permuted from torch's CHW order to the HWC order the port flattens in,
and a BatchNorm's weight and bias to ``scale`` / ``bias`` and its running
mean and variance into ``batch_stats``.

SSD300-VGG (``import_ssd300_from_torch``) takes ssd.pytorch's public
layout (``vgg.{i}``, ``L2Norm.weight``, ``extras.{i}``, ``loc.{i}``,
``conf.{i}``); ``make_torch_ssd300`` is its twin, with ssd.pytorch's
L2Norm (``x / (sqrt(sum x^2) + 1e-10) * w``; the model adds the 1e-10
under the root, as JAX's does).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from analytics_zoo_tpu_torch.models.migration import (
    _linear, _np, _state_dict, assign_layer_params,
)


def _conv(sd, prefix):
    out = {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _bn(sd, prefix):
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _linear_chw(sd, prefix, chw: Tuple[int, int, int]):
    """First linear after a flatten: torch flattened [C,H,W], this
    framework flattens [H,W,C] — permute the input dim to match."""
    c, h, w = chw
    wt = _np(sd[f"{prefix}.weight"])                   # [out, c*h*w]
    wt = wt.reshape(wt.shape[0], c, h, w).transpose(0, 2, 3, 1)
    out = {"kernel": wt.reshape(wt.shape[0], -1).T}    # [h*w*c, out]
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


# ------------------------------------------------ layer enumeration ----

def _param_layers(model) -> List:
    """The parameterized layers of a functional Model in topological
    (build) order, the order the specs below are written in."""
    from analytics_zoo_tpu_torch.keras.engine import topo_sort
    from analytics_zoo_tpu_torch.keras.layers import (
        AtrousConvolution2D, BatchNormalization, Conv2D, Dense,
        KerasLayerWrapper,
    )
    kinds = (Conv2D, AtrousConvolution2D, Dense, BatchNormalization,
             KerasLayerWrapper)
    _, outputs = model._graph()
    seen, out = set(), []
    for node in topo_sort(list(outputs)):
        layer = node.layer
        if layer is not None and id(layer) not in seen \
                and isinstance(layer, kinds):
            seen.add(id(layer))
            out.append(layer)
    return out


_KIND_CLASSES = {
    "conv": "Conv2D",
    "dwconv": "KerasLayerWrapper",   # depthwise grouped conv wrapper
    "bn": "BatchNormalization",
    "linear": "Dense",
    "linear_chw": "Dense",
    "conv_head": "Conv2D",           # conv classifier (squeezenet)
}


# ------------------------------------------------- per-arch specs ------
# Each spec lists (kind, torch_prefix[, extra]) for every parameterized
# layer in OUR build order; torch prefixes are torchvision's keys.

def _spec_alexnet():
    return [("conv", "features.0"), ("conv", "features.3"),
            ("conv", "features.6"), ("conv", "features.8"),
            ("conv", "features.10"),
            ("linear_chw", "classifier.1", (256, 6, 6)),
            ("linear", "classifier.4"), ("linear", "classifier.6")]


_VGG_CONV_IDX = {
    16: (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28),
    19: (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34),
}


def _spec_vgg(depth):
    spec = [("conv", f"features.{i}") for i in _VGG_CONV_IDX[depth]]
    spec += [("linear_chw", "classifier.0", (512, 7, 7)),
             ("linear", "classifier.3"), ("linear", "classifier.6")]
    return spec


def _spec_resnet50():
    spec = [("conv", "conv1"), ("bn", "bn1")]
    for li, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            p = f"layer{li}.{b}"
            spec += [("conv", f"{p}.conv1"), ("bn", f"{p}.bn1"),
                     ("conv", f"{p}.conv2"), ("bn", f"{p}.bn2"),
                     ("conv", f"{p}.conv3"), ("bn", f"{p}.bn3")]
            if b == 0:
                spec += [("conv", f"{p}.downsample.0"),
                         ("bn", f"{p}.downsample.1")]
    spec.append(("linear", "fc"))
    return spec


def _spec_squeezenet():
    spec = [("conv", "features.0")]
    for i in (3, 4, 6, 7, 9, 10, 11, 12):        # torchvision 1.1 fires
        spec += [("conv", f"features.{i}.squeeze"),
                 ("conv", f"features.{i}.expand1x1"),
                 ("conv", f"features.{i}.expand3x3")]
    spec.append(("conv_head", "classifier.1"))
    return spec


def _spec_densenet(depth):
    blocks = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24)}[depth]
    spec = [("conv", "features.conv0"), ("bn", "features.norm0")]
    for bi, n_layers in enumerate(blocks, start=1):
        for li in range(1, n_layers + 1):
            p = f"features.denseblock{bi}.denselayer{li}"
            spec += [("bn", f"{p}.norm1"), ("conv", f"{p}.conv1"),
                     ("bn", f"{p}.norm2"), ("conv", f"{p}.conv2")]
        if bi < len(blocks):
            t = f"features.transition{bi}"
            spec += [("bn", f"{t}.norm"), ("conv", f"{t}.conv")]
    spec += [("bn", "features.norm5"), ("linear", "classifier")]
    return spec


def _spec_mobilenet_v2():
    spec = [("conv", "features.0.0"), ("bn", "features.0.1")]
    # (out_ch, n, stride, expand) — the canonical width table
    settings = ((16, 1, 1, 1), (24, 2, 2, 6), (32, 3, 2, 6),
                (64, 4, 2, 6), (96, 3, 1, 6), (160, 3, 2, 6),
                (320, 1, 1, 6))
    fi = 1
    for _, n, _, expand in settings:
        for _ in range(n):
            p = f"features.{fi}.conv"
            if expand == 1:                      # no expansion stage
                spec += [("dwconv", f"{p}.0.0"), ("bn", f"{p}.0.1"),
                         ("conv", f"{p}.1"), ("bn", f"{p}.2")]
            else:
                spec += [("conv", f"{p}.0.0"), ("bn", f"{p}.0.1"),
                         ("dwconv", f"{p}.1.0"), ("bn", f"{p}.1.1"),
                         ("conv", f"{p}.2"), ("bn", f"{p}.3")]
            fi += 1
    spec += [("conv", "features.18.0"), ("bn", "features.18.1"),
             ("linear", "classifier.1")]
    return spec


_SPECS = {
    "alexnet": _spec_alexnet,
    "vgg-16": lambda: _spec_vgg(16),
    "vgg-19": lambda: _spec_vgg(19),
    "resnet-50": _spec_resnet50,
    "squeezenet": _spec_squeezenet,
    "densenet-121": lambda: _spec_densenet(121),
    "densenet-161": lambda: _spec_densenet(161),
    "mobilenet-v2": _spec_mobilenet_v2,
}


def import_image_classifier_from_torch(clf, torch_model_or_state):
    """Load a torchvision-layout state dict into an ``ImageClassifier``
    in place (ref Net.scala:446 loadModel: the same model name takes the
    same weights). Takes a torch module, a state dict, or the path of a
    ``torch.save`` file (read with ``weights_only=True``)."""
    if isinstance(torch_model_or_state, str):
        import torch
        torch_model_or_state = torch.load(
            torch_model_or_state, map_location="cpu", weights_only=True)
    sd = _state_dict(torch_model_or_state)
    name = clf.model_name
    if name not in _SPECS:
        raise ValueError(
            f"no pretrained import mapping for {name!r}; supported: "
            f"{sorted(_SPECS)} (inception-v1 excluded: torchvision's "
            f"googlenet is the BN variant, a different architecture)")
    spec = _SPECS[name]()
    # building the module canonicalizes the layer names: enumerate after
    clf.model.module
    layers = _param_layers(clf.model)
    if len(layers) != len(spec):
        raise RuntimeError(
            f"{name}: model has {len(layers)} parameterized layers but "
            f"spec lists {len(spec)} — architecture drift")
    params: Dict[str, Dict[str, np.ndarray]] = {}
    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, entry in zip(layers, spec):
        kind, prefix = entry[0], entry[1]
        expect = _KIND_CLASSES[kind]
        if type(layer).__name__ != expect:
            raise RuntimeError(
                f"{name}: spec expects {expect} for {prefix}, model has "
                f"{type(layer).__name__} ({layer.name}) — order drift")
        if kind in ("conv", "dwconv", "conv_head"):
            params[layer.name] = _conv(sd, prefix)
        elif kind == "bn":
            p, s = _bn(sd, prefix)
            params[layer.name] = p
            stats[layer.name] = s
        elif kind == "linear":
            params[layer.name] = _linear(sd, prefix)
        elif kind == "linear_chw":
            params[layer.name] = _linear_chw(sd, prefix, entry[2])
    assign_layer_params(clf.model, params, state_updates=stats)
    return clf


# ------------------------------------------------------ torch twins ----
# state_dict-contract twins (keys identical to torchvision's models), plain
# torch.nn modules; their weights are whatever state dict the caller loads
# into them, or torch's default init.

def _torch():
    import torch
    import torch.nn as nn
    return torch, nn


def make_torch_alexnet(class_num: int = 1000):
    torch, nn = _torch()

    class TorchAlexNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.features = nn.Sequential(
                nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(inplace=True),
                nn.MaxPool2d(3, 2),
                nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(inplace=True),
                nn.MaxPool2d(3, 2),
                nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(inplace=True),
                nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(inplace=True),
                nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(inplace=True),
                nn.MaxPool2d(3, 2))
            self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
            self.classifier = nn.Sequential(
                nn.Dropout(), nn.Linear(256 * 36, 4096),
                nn.ReLU(inplace=True),
                nn.Dropout(), nn.Linear(4096, 4096),
                nn.ReLU(inplace=True), nn.Linear(4096, class_num))

        def forward(self, x):
            x = self.avgpool(self.features(x))
            return self.classifier(torch.flatten(x, 1))

    return TorchAlexNet()


def make_torch_vgg(depth: int, class_num: int = 1000):
    torch, nn = _torch()
    cfg = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}[depth]

    class TorchVGG(nn.Module):
        def __init__(self):
            super().__init__()
            layers, in_ch = [], 3
            for n_convs, ch in zip(cfg, (64, 128, 256, 512, 512)):
                for _ in range(n_convs):
                    layers += [nn.Conv2d(in_ch, ch, 3, 1, 1),
                               nn.ReLU(inplace=True)]
                    in_ch = ch
                layers.append(nn.MaxPool2d(2, 2))
            self.features = nn.Sequential(*layers)
            self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
            self.classifier = nn.Sequential(
                nn.Linear(512 * 49, 4096), nn.ReLU(inplace=True),
                nn.Dropout(),
                nn.Linear(4096, 4096), nn.ReLU(inplace=True), nn.Dropout(),
                nn.Linear(4096, class_num))

        def forward(self, x):
            x = self.avgpool(self.features(x))
            return self.classifier(torch.flatten(x, 1))

    return TorchVGG()


def make_torch_resnet50(class_num: int = 1000):
    torch, nn = _torch()

    class Bottleneck(nn.Module):
        def __init__(self, in_ch, planes, stride, project):
            super().__init__()
            self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(planes)
            self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1,
                                   bias=False)
            self.bn2 = nn.BatchNorm2d(planes)
            self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(planes * 4)
            self.relu = nn.ReLU(inplace=True)
            self.downsample = None
            if project:
                self.downsample = nn.Sequential(
                    nn.Conv2d(in_ch, planes * 4, 1, stride, bias=False),
                    nn.BatchNorm2d(planes * 4))

        def forward(self, x):
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            s = x if self.downsample is None else self.downsample(x)
            return self.relu(y + s)

    class TorchResNet50(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            in_ch = 64
            for li, (planes, blocks) in enumerate(
                    zip((64, 128, 256, 512), (3, 4, 6, 3)), start=1):
                stage = []
                for b in range(blocks):
                    stride = 2 if (b == 0 and li > 1) else 1
                    stage.append(Bottleneck(in_ch, planes, stride,
                                            project=(b == 0)))
                    in_ch = planes * 4
                setattr(self, f"layer{li}", nn.Sequential(*stage))
            self.avgpool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(2048, class_num)

        def forward(self, x):
            x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
            for li in range(1, 5):
                x = getattr(self, f"layer{li}")(x)
            return self.fc(torch.flatten(self.avgpool(x), 1))

    return TorchResNet50()


def make_torch_squeezenet(class_num: int = 1000):
    torch, nn = _torch()

    class Fire(nn.Module):
        def __init__(self, in_ch, sq, ex):
            super().__init__()
            self.squeeze = nn.Conv2d(in_ch, sq, 1)
            self.squeeze_activation = nn.ReLU(inplace=True)
            self.expand1x1 = nn.Conv2d(sq, ex, 1)
            self.expand1x1_activation = nn.ReLU(inplace=True)
            self.expand3x3 = nn.Conv2d(sq, ex, 3, padding=1)
            self.expand3x3_activation = nn.ReLU(inplace=True)

        def forward(self, x):
            x = self.squeeze_activation(self.squeeze(x))
            return torch.cat([
                self.expand1x1_activation(self.expand1x1(x)),
                self.expand3x3_activation(self.expand3x3(x))], 1)

    class TorchSqueezeNet(nn.Module):       # torchvision 1.1 layout
        def __init__(self):
            super().__init__()
            self.features = nn.Sequential(
                nn.Conv2d(3, 64, 3, 2), nn.ReLU(inplace=True),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(64, 16, 64), Fire(128, 16, 64),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(128, 32, 128), Fire(256, 32, 128),
                nn.MaxPool2d(3, 2, ceil_mode=True),
                Fire(256, 48, 192), Fire(384, 48, 192),
                Fire(384, 64, 256), Fire(512, 64, 256))
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Conv2d(512, class_num, 1),
                nn.ReLU(inplace=True), nn.AdaptiveAvgPool2d(1))

        def forward(self, x):
            return torch.flatten(self.classifier(self.features(x)), 1)

    return TorchSqueezeNet()


def make_torch_densenet(depth: int, class_num: int = 1000):
    torch, nn = _torch()
    growth = 48 if depth == 161 else 32
    blocks = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24)}[depth]
    init_f = 2 * growth

    class DenseLayer(nn.Module):
        def __init__(self, in_ch):
            super().__init__()
            self.norm1 = nn.BatchNorm2d(in_ch)
            self.relu1 = nn.ReLU(inplace=True)
            self.conv1 = nn.Conv2d(in_ch, 4 * growth, 1, bias=False)
            self.norm2 = nn.BatchNorm2d(4 * growth)
            self.relu2 = nn.ReLU(inplace=True)
            self.conv2 = nn.Conv2d(4 * growth, growth, 3, padding=1,
                                   bias=False)

        def forward(self, x):
            y = self.conv1(self.relu1(self.norm1(x)))
            y = self.conv2(self.relu2(self.norm2(y)))
            return torch.cat([x, y], 1)

    class TorchDenseNet(nn.Module):
        def __init__(self):
            super().__init__()
            f = nn.Sequential()
            f.add_module("conv0", nn.Conv2d(3, init_f, 7, 2, 3,
                                            bias=False))
            f.add_module("norm0", nn.BatchNorm2d(init_f))
            f.add_module("relu0", nn.ReLU(inplace=True))
            f.add_module("pool0", nn.MaxPool2d(3, 2, 1))
            ch = init_f
            for bi, n_layers in enumerate(blocks, start=1):
                block = nn.Sequential()
                for li in range(1, n_layers + 1):
                    block.add_module(f"denselayer{li}", DenseLayer(ch))
                    ch += growth
                f.add_module(f"denseblock{bi}", block)
                if bi < len(blocks):
                    t = nn.Sequential()
                    t.add_module("norm", nn.BatchNorm2d(ch))
                    t.add_module("relu", nn.ReLU(inplace=True))
                    t.add_module("conv", nn.Conv2d(ch, ch // 2, 1,
                                                   bias=False))
                    t.add_module("pool", nn.AvgPool2d(2, 2))
                    f.add_module(f"transition{bi}", t)
                    ch //= 2
            f.add_module("norm5", nn.BatchNorm2d(ch))
            self.features = f
            self.classifier = nn.Linear(ch, class_num)

        def forward(self, x):
            x = torch.relu(self.features(x))
            x = torch.flatten(
                torch.nn.functional.adaptive_avg_pool2d(x, 1), 1)
            return self.classifier(x)

    return TorchDenseNet()


def make_torch_mobilenet_v2(class_num: int = 1000):
    torch, nn = _torch()

    def conv_bn_relu(in_ch, out_ch, k, stride, groups=1):
        return nn.Sequential(
            nn.Conv2d(in_ch, out_ch, k, stride, (k - 1) // 2,
                      groups=groups, bias=False),
            nn.BatchNorm2d(out_ch), nn.ReLU6(inplace=True))

    class InvertedResidual(nn.Module):
        def __init__(self, in_ch, out_ch, stride, expand):
            super().__init__()
            hid = in_ch * expand
            self.use_res = stride == 1 and in_ch == out_ch
            layers = []
            if expand != 1:
                layers.append(conv_bn_relu(in_ch, hid, 1, 1))
            layers += [conv_bn_relu(hid, hid, 3, stride, groups=hid),
                       nn.Conv2d(hid, out_ch, 1, bias=False),
                       nn.BatchNorm2d(out_ch)]
            self.conv = nn.Sequential(*layers)

        def forward(self, x):
            y = self.conv(x)
            return x + y if self.use_res else y

    class TorchMobileNetV2(nn.Module):
        def __init__(self):
            super().__init__()
            settings = ((16, 1, 1, 1), (24, 2, 2, 6), (32, 3, 2, 6),
                        (64, 4, 2, 6), (96, 3, 1, 6), (160, 3, 2, 6),
                        (320, 1, 1, 6))
            feats = [conv_bn_relu(3, 32, 3, 2)]
            ch = 32
            for out_ch, n, stride, expand in settings:
                for i in range(n):
                    feats.append(InvertedResidual(
                        ch, out_ch, stride if i == 0 else 1, expand))
                    ch = out_ch
            feats.append(conv_bn_relu(ch, 1280, 1, 1))
            self.features = nn.Sequential(*feats)
            self.classifier = nn.Sequential(nn.Dropout(0.2),
                                            nn.Linear(1280, class_num))

        def forward(self, x):
            x = self.features(x).mean([2, 3])
            return self.classifier(x)

    return TorchMobileNetV2()


MAKE_TWINS = {
    "alexnet": make_torch_alexnet,
    "vgg-16": lambda n=1000: make_torch_vgg(16, n),
    "vgg-19": lambda n=1000: make_torch_vgg(19, n),
    "resnet-50": make_torch_resnet50,
    "squeezenet": make_torch_squeezenet,
    "densenet-121": lambda n=1000: make_torch_densenet(121, n),
    "densenet-161": lambda n=1000: make_torch_densenet(161, n),
    "mobilenet-v2": make_torch_mobilenet_v2,
}


# ------------------------------------------------------ SSD300-VGG -----
# state_dict contract = ssd.pytorch's public layout (vgg.{i}.*,
# L2Norm.weight, extras.{i}.*, loc.{i}.*, conf.{i}.*).

_SSD_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28,
                     31, 33)   # convs in the vgg sequential (incl. 6/7)


def make_torch_ssd300(class_num: int = 20):
    """Torch twin of ``SSD300VGG`` with ssd.pytorch's module and key
    layout; forward takes ``[b, 3, 300, 300]`` and returns ``[b, 8732, 4 +
    class_num + 1]`` in the zoo model's anchor order (heads permuted to
    NHWC, then flattened)."""
    torch, nn = _torch()
    import torch.nn.functional as F

    class L2Norm(nn.Module):
        def __init__(self, ch=512, scale=20.0):
            super().__init__()
            self.weight = nn.Parameter(torch.full((ch,), float(scale)))

        def forward(self, x):
            norm = x.pow(2).sum(dim=1, keepdim=True).sqrt() + 1e-10
            return x / norm * self.weight[None, :, None, None]

    class TorchSSD300(nn.Module):
        def __init__(self):
            super().__init__()
            layers = []
            in_ch = 3
            for v in (64, 64, "M", 128, 128, "M", 256, 256, 256, "C",
                      512, 512, 512, "M", 512, 512, 512):
                if v == "M":
                    layers.append(nn.MaxPool2d(2, 2))
                elif v == "C":
                    layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
                else:
                    layers += [nn.Conv2d(in_ch, v, 3, padding=1),
                               nn.ReLU(inplace=True)]
                    in_ch = v
            layers += [nn.MaxPool2d(3, 1, 1),
                       nn.Conv2d(512, 1024, 3, padding=6, dilation=6),
                       nn.ReLU(inplace=True),
                       nn.Conv2d(1024, 1024, 1),
                       nn.ReLU(inplace=True)]
            self.vgg = nn.ModuleList(layers)
            self.L2Norm = L2Norm(512, 20)
            self.extras = nn.ModuleList([
                nn.Conv2d(1024, 256, 1), nn.Conv2d(256, 512, 3, 2, 1),
                nn.Conv2d(512, 128, 1), nn.Conv2d(128, 256, 3, 2, 1),
                nn.Conv2d(256, 128, 1), nn.Conv2d(128, 256, 3),
                nn.Conv2d(256, 128, 1), nn.Conv2d(128, 256, 3)])
            mbox = (4, 6, 6, 6, 4, 4)
            src_ch = (512, 1024, 512, 256, 256, 256)
            C1 = class_num + 1
            self.loc = nn.ModuleList([
                nn.Conv2d(c, a * 4, 3, padding=1)
                for c, a in zip(src_ch, mbox)])
            self.conf = nn.ModuleList([
                nn.Conv2d(c, a * C1, 3, padding=1)
                for c, a in zip(src_ch, mbox)])
            self.C1 = C1

        def forward(self, x):
            sources = []
            for i in range(23):
                x = self.vgg[i](x)
            sources.append(self.L2Norm(x))      # conv4_3
            for i in range(23, len(self.vgg)):
                x = self.vgg[i](x)
            sources.append(x)                   # conv7
            for i, ext in enumerate(self.extras):
                x = F.relu(ext(x), inplace=True)
                if i % 2 == 1:
                    sources.append(x)
            outs = []
            for src, l, c in zip(sources, self.loc, self.conf):
                loc = l(src).permute(0, 2, 3, 1).reshape(
                    src.shape[0], -1, 4)
                conf = c(src).permute(0, 2, 3, 1).reshape(
                    src.shape[0], -1, self.C1)
                outs.append(torch.cat([loc, conf], dim=-1))
            return torch.cat(outs, dim=1)

    return TorchSSD300()


def _spec_ssd300():
    """ssd.pytorch keys in the model's topological (depth-first from the
    output) order: conv4_3 -> L2Norm -> head 0 before the deeper
    backbone, and each extras pair right before its head."""
    spec = [("conv", f"vgg.{i}") for i in _SSD_VGG_CONV_IDX[:10]]
    spec += [("l2norm", "L2Norm"),
             ("conv", "loc.0"), ("conv", "conf.0")]
    spec += [("conv", f"vgg.{i}") for i in _SSD_VGG_CONV_IDX[10:]]
    spec += [("conv", "loc.1"), ("conv", "conf.1")]
    for k in range(4):
        spec += [("conv", f"extras.{2 * k}"),
                 ("conv", f"extras.{2 * k + 1}"),
                 ("conv", f"loc.{k + 2}"), ("conv", f"conf.{k + 2}")]
    return spec


def import_ssd300_from_torch(ssd, torch_model_or_state):
    """Load an ssd.pytorch-format state dict (or module, or ``torch.save``
    path) into ``SSD300VGG`` (ref ``ObjectDetector.scala`` pretrained
    VGG-SSD entries)."""
    if isinstance(torch_model_or_state, str):
        import torch
        torch_model_or_state = torch.load(
            torch_model_or_state, map_location="cpu", weights_only=True)
    sd = _state_dict(torch_model_or_state)
    # building the module canonicalizes the layer names: enumerate after
    ssd.model.module
    layers = _param_layers(ssd.model)
    spec = _spec_ssd300()
    if len(layers) != len(spec):
        raise RuntimeError(
            f"SSD300VGG has {len(layers)} parameterized layers but spec "
            f"lists {len(spec)} — architecture drift")
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for layer, (kind, prefix) in zip(layers, spec):
        if kind == "l2norm":
            if type(layer).__name__ != "KerasLayerWrapper":
                raise RuntimeError(f"expected L2Norm wrapper, got "
                                   f"{type(layer).__name__}")
            params[layer.name] = {"scale": _np(sd[f"{prefix}.weight"])}
        else:
            if type(layer).__name__ not in ("Conv2D", "AtrousConvolution2D"):
                raise RuntimeError(
                    f"spec expects a conv for {prefix}, model has "
                    f"{type(layer).__name__} ({layer.name})")
            params[layer.name] = _conv(sd, prefix)
    assign_layer_params(ssd.model, params)
    return ssd
