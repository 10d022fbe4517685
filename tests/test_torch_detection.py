"""Object detection in the port against the JAX package's, on the CPU.

- ``bbox_util`` and ``evaluation`` are host numpy copies: their outputs
  equal JAX's bit for bit on the same inputs (anchors, the ssd.pytorch
  priors, IoU, encoding, decoding, NMS, the detection rows, AP and mAP,
  the Visualizer's pixels).
- ``MultiBoxLoss``: loss and gradient (torch autograd against
  ``jax.value_and_grad``) within 1e-6 relative (measured: 9.1e-8 on the
  loss, 8.2e-8 of the largest gradient); with tied cross-entropies (a
  head at zero) the mined negatives are JAX's, which an unstable sort
  does not give (measured: loss 1.0e-7, gradient 0).
- ``SSDLite`` at 64 px (class_num 2): the eval forward within 1e-5 of
  JAX's from JAX's weights and ``batch_stats``, and three SGD ``fit``
  steps' losses within 1e-5 relative (measured: at most 1.9e-6 absolute,
  7.8e-7 relative, over both).
- ``SSD300VGG``: the parameter tree's names and shapes equal JAX's
  (``jax.eval_shape`` of its init, nothing computed); the model against
  the port's own twin of ssd.pytorch (torch only, one 300 x 300 image,
  conv kernels at std 0.02 as JAX's test tames them) within JAX's 1e-3
  relative limit (measured 0: the twin's 1e-10 after the root, not under
  it, is below fp32's resolution here); the L2Norm, the rate-6
  ``AtrousConvolution2D`` and the ceil-mode pool3 against JAX's layers
  within 1e-5 (measured 1.9e-6 on the L2Norm's outputs of about 20,
  4.8e-7, 0); the whole forward against JAX's at 300 px (``slow``, as
  JAX marks its own; within 1e-5 relative).
- ``ObjectDetector``: the rows (label, score, box) of the same weights
  equal JAX's (labels and counts exactly, scores and boxes within 1e-5;
  measured 1.5e-7); the registry's ``save_model`` / ``load_model``
  across the packages.

JAX is imported by fixtures only.
"""

import json
import os

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.convert import (flatten, flax_layout,
                                             flax_to_state_dict)
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    bbox_util as tbu,
)
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    evaluation as tev,
)

LOSS_RTOL = 1e-6
FWD_ATOL = 1e-5
FIT_RTOL = 1e-5
TWIN_RTOL = 1e-3                   # JAX tests/test_migration_image.py:157
ROW_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.learn import estimator
    monkeypatch.setattr(estimator, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.models.image.objectdetection import (
        bbox_util, evaluation, multibox_loss, object_detector,
    )
    return dict(jax=jax, bu=bbox_util, ev=evaluation, mb=multibox_loss,
                od=object_detector)


def _boxes(rng, n):
    c = rng.uniform(0.15, 0.85, (n, 2))
    wh = rng.uniform(0.05, 0.5, (n, 2))
    return np.clip(np.concatenate([c - wh / 2, c + wh / 2], 1), 0,
                   1).astype(np.float32)


# ------------------------------------------------------------ bbox_util

def _bbox_cases():
    rng = np.random.default_rng(0)
    anchors = tbu.generate_anchors([8, 4, 2], [0.15, 0.35, 0.6, 0.85])
    gt, lab = _boxes(rng, 3), rng.integers(1, 4, 3)
    loc = rng.normal(size=(len(anchors), 4)).astype(np.float32)
    conf = rng.normal(size=(len(anchors), 4)).astype(np.float32) * 3
    nb, ns = _boxes(rng, 40), rng.uniform(0, 1, 40).astype(np.float32)
    return {
        "generate_anchors": ("generate_anchors", ([8, 4, 2],
                             [0.15, 0.35, 0.6, 0.85])),
        "generate_anchors_per_layer": ("generate_anchors", (
            [5, 3], [0.2, 0.5, 0.9], [(1.0, 2.0), (1.0, 3.0, 1 / 3)])),
        "ssd300_vgg": ("anchors_from_config", ("ssd300_vgg",)),
        "ssd512_vgg": ("anchors_from_config", ("ssd512_vgg",)),
        "mobilenet_300": ("anchors_from_config", ("mobilenet_300",)),
        "ssd_pytorch_priors": ("ssd_pytorch_priors", ()),
        "iou_matrix": ("iou_matrix", (nb[:20], nb[20:])),
        "encode_targets": ("encode_targets", (gt, lab, anchors)),
        "encode_no_gt": ("encode_targets", (np.zeros((0, 4)),
                                             np.zeros(0), anchors)),
        "decode_boxes": ("decode_boxes", (loc, anchors)),
        "nms": ("nms", (nb, ns, 0.45)),
        "nms_top_k": ("nms", (nb, ns, 0.3, 5)),
        "detect_post_process": ("detect_post_process",
                                (loc, conf, anchors, 3, 0.2)),
    }


BBOX_CASES = _bbox_cases()


@pytest.mark.parametrize("case", sorted(BBOX_CASES))
def test_bbox_util_is_jax_bitwise(jx, case):
    fn, args = BBOX_CASES[case]
    got = getattr(tbu, fn)(*args)
    want = getattr(jx["bu"], fn)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _detections(rng, n_img, n_classes):
    dets, gtb, gtl = [], [], []
    for _ in range(n_img):
        g = int(rng.integers(1, 4))
        gtb.append(_boxes(rng, g))
        gtl.append(rng.integers(1, n_classes + 1, g))
        k = int(rng.integers(0, 6))
        rows = np.concatenate([
            rng.integers(1, n_classes + 1, (k, 1)).astype(np.float32),
            rng.uniform(0, 1, (k, 1)).astype(np.float32), _boxes(rng, k)],
            1)
        # a detection on a ground-truth box, nudged
        hit = np.concatenate([[gtl[-1][0], 0.9], gtb[-1][0] + 0.01])
        dets.append(np.concatenate([rows, hit[None].astype(np.float32)]))
    return dets, gtb, gtl


@pytest.mark.parametrize("use_07", [False, True])
def test_evaluation_is_jax_bitwise(jx, use_07):
    rng = np.random.default_rng(1)
    dets, gtb, gtl = _detections(rng, 6, 3)
    got = tev.mean_average_precision(dets, gtb, gtl, 3, 0.5, use_07)
    want = jx["ev"].mean_average_precision(dets, gtb, gtl, 3, 0.5, use_07)
    assert got == want and 0 < got["mAP"] < 1
    r = np.sort(rng.uniform(0, 1, 9))
    p = rng.uniform(0, 1, 9)
    assert tev.average_precision(r, p, use_07) == \
        jx["ev"].average_precision(r, p, use_07)


def test_visualizer_draws_jax_pixels(jx):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (40, 50, 3)).astype(np.uint8)
    dets, _, _ = _detections(rng, 1, 3)
    got = tev.Visualizer({1: "cat"}, 0.2).draw(img, dets[0])
    want = jx["ev"].Visualizer({1: "cat"}, 0.2).draw(img, dets[0])
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


# ---------------------------------------------------------- MultiBoxLoss

def _loss_inputs(seed, n_classes=3, batch=2, zero_conf=False):
    rng = np.random.default_rng(seed)
    anchors = tbu.ssd_pytorch_priors()
    yt = np.stack([tbu.encode_targets(_boxes(rng, g), rng.integers(
        1, n_classes + 1, g), anchors) for g in (1, 4)[:batch]])
    yp = rng.normal(size=(batch, len(anchors), 4 + n_classes + 1))
    if zero_conf:
        yp[..., 4:] = 0.0
    return yt.astype(np.float32), yp.astype(np.float32)


def _port_loss(yt, yp, n_classes=3):
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        MultiBoxLoss,
    )
    p = torch.tensor(yp, requires_grad=True)
    loss = MultiBoxLoss(n_classes)(torch.tensor(yt), p)
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def _jax_loss(jx, yt, yp, n_classes=3):
    jl = jx["mb"].MultiBoxLoss(n_classes)
    loss, grad = jx["jax"].value_and_grad(lambda p: jl(yt, p))(yp)
    return float(loss), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_loss_matches_jax(jx, seed):
    yt, yp = _loss_inputs(seed)
    got, ggot = _port_loss(yt, yp)
    want, gwant = _jax_loss(jx, yt, yp)
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    assert float(np.abs(ggot - gwant).max()) <= \
        LOSS_RTOL * float(np.abs(gwant).max())


def test_mining_with_tied_ce_keeps_jax_negatives(jx):
    """A head at zero gives every anchor the same cross-entropy, log(C +
    1): JAX's stable argsort keeps the first ``3 * n_pos`` background
    anchors in index order, and so must the port (torch's default sort
    is not stable). The conf gradient is nonzero exactly on the positives
    and the mined negatives."""
    from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
        import mining_ranks
    yt, yp = _loss_inputs(3, zero_conf=True)
    got, ggot = _port_loss(yt, yp)
    want, gwant = _jax_loss(jx, yt, yp)
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_array_equal(np.abs(ggot[..., 4:]).sum(-1) > 0,
                                  np.abs(gwant[..., 4:]).sum(-1) > 0)
    assert float(np.abs(ggot - gwant).max()) <= \
        LOSS_RTOL * float(np.abs(gwant).max())
    pos = torch.tensor(yt[..., 4] > 0)
    ranks = mining_ranks(torch.zeros(pos.shape), pos)
    for b in range(len(yt)):
        negs = torch.nonzero(~pos[b])[:, 0]
        np.testing.assert_array_equal(ranks[b][negs].numpy(),
                                      np.arange(len(negs)))


# ------------------------------------------------------------- SSDLite

def _jax_variables(jx, jssd, optimizer="sgd"):
    jssd.compile(optimizer=optimizer, loss=jssd.loss())
    adapter = jssd.model._ensure_estimator().adapter
    return (jx["jax"].device_get(adapter.params),
            jx["jax"].device_get(adapter.model_state))


def _port_from(model, params, state):
    sd = flax_to_state_dict(params)
    sd.update(flax_to_state_dict(state.get("batch_stats", {})))
    model.model.module.load_state_dict(sd, strict=True)
    return model


def _lite_data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)
    boxes = [_boxes(rng, int(rng.integers(1, 3))) for _ in range(n)]
    labels = [rng.integers(1, 3, len(b)) for b in boxes]
    return x, boxes, labels


def test_ssdlite_forward_and_fit_match_jax(jx):
    from analytics_zoo_tpu_torch.learn.optimizers import SGD
    from analytics_zoo_tpu_torch.models import SSDLite
    from analytics_zoo_tpu.learn.optimizers import SGD as JSGD
    jssd = jx["od"].SSDLite(class_num=2, image_size=64)
    params, state = _jax_variables(jx, jssd)
    ssd = _port_from(SSDLite(class_num=2, image_size=64), params, state)
    np.testing.assert_array_equal(ssd.anchors, jssd.anchors)
    x, boxes, labels = _lite_data()
    got = ssd.predict(x, batch_size=8, device="cpu")
    want = np.asarray(jssd.predict(x, batch_size=8))
    assert got.shape == want.shape == (8, ssd.n_anchors, 4 + 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    y = ssd.encode_ground_truth(boxes, labels)
    np.testing.assert_array_equal(y, jssd.encode_ground_truth(boxes,
                                                              labels))
    jssd.compile(optimizer=JSGD(learningrate=0.01, momentum=0.9),
                 loss=jssd.loss())
    ssd.compile(optimizer=SGD(learningrate=0.01, momentum=0.9),
                loss=ssd.loss(), device="cpu")
    hw = jssd.fit(x, y, batch_size=8, nb_epoch=3, shuffle=False)
    hg = ssd.fit(x, y, batch_size=8, nb_epoch=3, shuffle=False)
    assert len(hg["loss"]) == 3
    np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=FIT_RTOL)


def test_object_detector_rows_match_jax(jx):
    from analytics_zoo_tpu_torch.models import ObjectDetector, SSDLite
    jssd = jx["od"].SSDLite(class_num=2, image_size=64)
    params, state = _jax_variables(jx, jssd)
    ssd = _port_from(SSDLite(class_num=2, image_size=64), params, state)
    x, _, _ = _lite_data(seed=4)
    got = ObjectDetector(ssd, conf_threshold=0.2, device="cpu").predict(
        x, batch_size=8)
    want = jx["od"].ObjectDetector(jssd, conf_threshold=0.2).predict(
        x, batch_size=8)
    assert sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=0,
                                   atol=ROW_ATOL)


def test_registry_save_load_round_trip(jx, tmp_path):
    """A JAX SSDLite saved by ``save_model`` loads in the port with its
    weights, and the port's saves load back in both packages (an
    SSD300VGG by the registry's name)."""
    from analytics_zoo_tpu_torch.models import SSD300VGG, ZooModel
    from analytics_zoo_tpu.models.common import ZooModel as JZooModel
    jssd = jx["od"].SSDLite(class_num=2, image_size=64)
    # an uncompiled loader reads against adam's state in both packages
    params, _ = _jax_variables(jx, jssd, "adam")
    jssd.save_model(str(tmp_path / "jax"))
    lite = ZooModel.load_model(str(tmp_path / "jax"))
    assert type(lite).__name__ == "SSDLite" and lite.image_size == 64
    got = flatten(flax_to_state_dict(params))
    for k, v in lite.model.module.state_dict().items():
        if k in got:
            np.testing.assert_array_equal(v.numpy(), got[k].numpy())
    lite.save_model(str(tmp_path / "port"))
    back = JZooModel.load_model(str(tmp_path / "port"))
    assert type(back).__name__ == "SSDLite"
    big = SSD300VGG(class_num=2)
    big.save_model(str(tmp_path / "ssd300"))
    with open(tmp_path / "ssd300" / "config.json") as fh:
        assert json.load(fh) == {"class": "SSD300VGG", "class_num": 2}
    again = ZooModel.load_model(str(tmp_path / "ssd300"))
    assert type(again).__name__ == "SSD300VGG" and again.n_anchors == 8732
    for k, v in big.model.module.state_dict().items():
        np.testing.assert_array_equal(
            again.model.module.state_dict()[k].numpy(), v.numpy())


def test_predict_image_set_is_predict():
    from analytics_zoo_tpu_torch.feature.image import ImageSet
    from analytics_zoo_tpu_torch.models import ObjectDetector, SSDLite
    torch.manual_seed(3)
    det = ObjectDetector(SSDLite(class_num=2, image_size=64),
                         conf_threshold=0.2, device="cpu")
    x, _, _ = _lite_data(4, seed=6)
    got = det.predict_image_set(ImageSet.from_arrays(list(x)), batch_size=4)
    want = det.predict(x, batch_size=4)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_predict_without_cuda_raises():
    from analytics_zoo_tpu_torch.models import ObjectDetector, SSDLite
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    det = ObjectDetector(SSDLite(class_num=1, image_size=32))
    with pytest.raises(Exception):
        det.predict(np.zeros((1, 32, 32, 3), np.float32))


# ----------------------------------------------------------- SSD300VGG

def test_ssd300_tree_is_jax(jx):
    """Names and shapes of every parameter, from ``jax.eval_shape`` of
    JAX's init (nothing computed) against the port's flax layout."""
    jax = jx["jax"]
    from analytics_zoo_tpu_torch.models import SSD300VGG
    jssd = jx["od"].SSD300VGG(class_num=20)
    module = jssd.model.to_flax()
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), np.zeros((1, 300, 300, 3), np.float32)))
    want = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    ssd = SSD300VGG(class_num=20)
    got = {k: tuple(v.shape) for k, v in
           flatten(flax_layout(ssd.model.module)).items()}
    assert got == want
    assert sorted(shapes) == ["params"]
    n = sum(int(np.prod(s)) for s in got.values())
    assert 26_000_000 < n < 26_500_000
    np.testing.assert_array_equal(ssd.anchors, jssd.anchors)
    assert ssd.n_anchors == 8732


def _tamed_twin(class_num, seed=0):
    from analytics_zoo_tpu_torch.models.migration_image import (
        make_torch_ssd300,
    )
    torch.manual_seed(seed)
    twin = make_torch_ssd300(class_num=class_num).eval()
    for p in twin.parameters():          # tame the random deep VGG
        if p.dim() == 4:
            torch.nn.init.normal_(p, std=0.02)
    return twin


def test_ssd300_matches_twin():
    from analytics_zoo_tpu_torch.models import SSD300VGG
    from analytics_zoo_tpu_torch.models.migration_image import (
        import_ssd300_from_torch,
    )
    twin = _tamed_twin(3)
    ssd = import_ssd300_from_torch(SSD300VGG(class_num=3), twin)
    x = np.random.RandomState(0).rand(1, 300, 300, 3).astype(np.float32)
    with torch.no_grad():
        want = twin(torch.tensor(x.transpose(0, 3, 1, 2))).numpy()
    got = ssd.predict(x, device="cpu")
    assert got.shape == want.shape == (1, 8732, 8)
    rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert rel < TWIN_RTOL, rel
    with pytest.raises(KeyError):
        import_ssd300_from_torch(SSD300VGG(class_num=3),
                                 {k: v for k, v in twin.state_dict().items()
                                  if not k.startswith("extras.0")})


def _run_jax_layer(jx, layer, x):
    import flax.linen as fnn
    jax = jx["jax"]

    class W(fnn.Module):
        @fnn.compact
        def __call__(self, a):
            return layer.apply(layer.make_module(), [a], False)

    variables = W().init(jax.random.PRNGKey(0), x)
    return np.asarray(W().apply(variables, x)), jax.device_get(variables)


def _layer_cases(jx):
    from analytics_zoo_tpu.keras import layers as jl
    from analytics_zoo_tpu.models.image.objectdetection.object_detector \
        import _l2norm_layer as jl2
    from analytics_zoo_tpu_torch.keras import layers as tl
    from analytics_zoo_tpu_torch.models.image.objectdetection \
        .object_detector import _l2norm_layer as tl2
    return {
        "l2norm": (jl2(16), tl2(16), (2, 9, 9, 16)),
        "atrous_rate6_pad6": (
            jl.AtrousConvolution2D(8, 3, 3, atrous_rate=(6, 6),
                                   activation="relu", border_mode=6,
                                   name="a"),
            tl.AtrousConvolution2D(8, 3, 3, atrous_rate=(6, 6),
                                   activation="relu", border_mode=6,
                                   name="a"), (2, 19, 19, 4)),
        "pool3_ceil": (
            jl.MaxPooling2D((2, 2), strides=(2, 2),
                            border_mode=((0, 1), (0, 1))),
            tl.MaxPooling2D((2, 2), strides=(2, 2),
                            border_mode=((0, 1), (0, 1))), (2, 75, 75, 3)),
    }


@pytest.mark.parametrize("case", ["l2norm", "atrous_rate6_pad6",
                                  "pool3_ceil"])
def test_ssd300_layers_match_jax(jx, case):
    jlayer, tlayer, shape = _layer_cases(jx)[case]
    x = np.abs(np.random.default_rng(5).normal(size=shape)).astype(
        np.float32)
    want, variables = _run_jax_layer(jx, jlayer, x)
    params = variables.get("params", {})
    if params:
        (inner,) = params.values()
        tlayer.name = next(iter(params))
        params = {tlayer.name: inner}
    mods = torch.nn.ModuleDict(tlayer.make_modules(
        [shape[1:]], torch.Generator().manual_seed(0)))
    mods.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tlayer.apply(dict(mods), [torch.tensor(x)], False).numpy()
    assert got.shape == want.shape
    assert tuple(got.shape[1:]) == tlayer._infer_shape([shape[1:]])
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    if case == "pool3_ceil":
        assert got.shape[1:3] == (38, 38)


@pytest.mark.slow  # ~6 min on one core, as JAX's own SSD300 parity test
def test_ssd300_forward_matches_jax(jx):
    from analytics_zoo_tpu_torch.models import SSD300VGG
    from analytics_zoo_tpu_torch.models.migration_image import (
        import_ssd300_from_torch,
    )
    from analytics_zoo_tpu.models.migration_image import (
        import_ssd300_from_torch as jimport,
    )
    twin = _tamed_twin(3)
    jssd = jx["od"].SSD300VGG(class_num=3)
    jimport(jssd, twin)
    ssd = import_ssd300_from_torch(SSD300VGG(class_num=3), twin)
    x = np.random.RandomState(0).rand(1, 300, 300, 3).astype(np.float32)
    want = np.asarray(jssd.predict(x, distributed=False))
    got = ssd.predict(x, device="cpu")
    rel = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert rel < 1e-5, rel


def test_fixtures_encode_every_image():
    """The overfit fixture (chip_smoke.py phase 21(c)): every image's
    ground truth matches anchors of SSDLite(1, 64)."""
    from analytics_zoo_tpu_torch.models import SSDLite
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "detection")
    with open(os.path.join(fix, "ground_truth.json")) as fh:
        gt = json.load(fh)
    names = sorted(gt)
    gtb = [np.array([g["box"] for g in gt[n]], np.float32) for n in names]
    gtl = [np.array([g["label"] for g in gt[n]]) for n in names]
    y = SSDLite(class_num=1, image_size=64).encode_ground_truth(gtb, gtl)
    assert (y[..., 4] > 0).sum(axis=1).min() >= 1
