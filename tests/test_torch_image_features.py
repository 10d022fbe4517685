"""The port's image pipeline (``feature/image``), its preprocessing
presets and ``LabelOutput`` against the JAX package's, on the CPU.

Both packages run host-side numpy, so every case is held bitwise: the
same input through the port's and JAX's transform of the same class and
arguments gives the same array (values, dtype and shape). The random
transforms draw from Python's ``random`` in both, so each runs under the
same ``random.seed``. Covered:

- every transform class JAX exports, each with the arguments JAX's own
  tests give it (tests/test_feature.py:22-101,257-320), and the chains,
  ``>`` composition and ``ImageRandomPreprocessing``;
- ``ImageSet.from_arrays`` through a chain into ``to_dataset``, and
  ``ImageSet.read(with_label=True)`` on PNG files written here;
- ``preprocessor`` for every preset under both sources, on a non-square
  uint8 image (tests/test_model_zoo.py:553);
- ``LabelOutput`` with and without ``prob_as_output`` and ``top_k``
  (tests/test_model_zoo.py:580);
- PIL hidden (``sys.modules["PIL"] = None``): decoding raises
  ``ImportError`` naming PIL, and everything else still runs.

JAX is imported by fixtures only.
"""

import io
import random
import sys

import numpy as np
import pytest

from analytics_zoo_tpu_torch.feature import image as timg
from analytics_zoo_tpu_torch.models.image.imageclassification import (
    image_classifier as tic,
)


@pytest.fixture(scope="module")
def jx():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from analytics_zoo_tpu.feature import image as jimg
    from analytics_zoo_tpu.models.image.imageclassification import (
        image_classifier as jic,
    )
    return dict(img=jimg, ic=jic)


def _imgs(n=6, h=24, w=32, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _png(arr) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        return
    assert got == want


#: (class name, args, kwargs, seeded); each applied to a uint8 image and
#: to a float32 one
TRANSFORMS = [
    ("ImageResize", (16, 16), {}, False),
    ("ImageResize", (40, 50), {}, False),
    ("ImageAspectScale", (20,), {"max_size": 1000}, False),
    ("ImageAspectScale", (20,), {"max_size": 30}, False),
    ("ImageAspectScale", (20,), {"scale_multiple_of": 8}, False),
    ("ImageRandomAspectScale", ([12, 18, 30],), {}, True),
    ("ImageCenterCrop", (8, 10), {}, False),
    ("ImageRandomCrop", (10, 12), {}, True),
    ("ImageFixedCrop", (0.1, 0.2, 0.8, 0.9), {}, False),
    ("ImageFixedCrop", (2, 3, 20, 15), {"normalized": False}, False),
    ("ImageHFlip", (), {}, False),
    ("ImageRandomFlip", (), {"p": 0.5}, True),
    ("ImageChannelNormalize", (123, 117, 104, 58, 57, 57), {}, False),
    ("ImagePixelNormalizer", (np.full((24, 32, 3), 100.5, np.float32),),
     {}, False),
    ("ImageChannelScaledNormalizer", (123.68, 116.78, 103.94, 0.017), {},
     False),
    ("ImageBrightness", (), {}, True),
    ("ImageContrast", (), {}, True),
    ("ImageSaturation", (), {}, True),
    ("ImageHue", (), {}, True),
    ("ImageColorJitter", (), {}, True),
    ("ImageColorJitter", (), {"brightness_prob": 1.0, "hue_prob": 1.0},
     True),
    ("ImageExpand", (), {}, True),
    ("ImageExpand", (), {"min_expand_ratio": 2.0, "max_expand_ratio": 2.0},
     True),
    ("ImageFiller", (0.1, 0.2, 0.5, 0.6), {"value": 7}, False),
    ("ImageMirror", (), {}, False),
    ("ImageChannelOrder", (), {}, False),
    ("PerImageNormalize", (), {}, False),
    ("PerImageNormalize", (0.5, 1.0), {}, False),
    ("ImageMatToTensor", (), {}, False),
    ("ImageMatToTensor", (), {"to_chw": True}, False),
    ("ImagePixelNormalize", (np.arange(24 * 32 * 3, dtype=np.float32),), {},
     False),
]


def _run(mod, name, args, kwargs, feature, seeded, seed=7):
    t = getattr(mod, name)(*args, **kwargs)
    if seeded:
        random.seed(seed)
    out = t.transform(dict(feature))
    if seeded:
        # a second image drawn after the first: the stream stays in step
        out = (out, t.transform(dict(feature)))
    return out


@pytest.mark.parametrize("name,args,kwargs,seeded", TRANSFORMS,
                         ids=[f"{t[0]}-{i}" for i, t in
                              enumerate(TRANSFORMS)])
def test_every_transform_is_jax_bit_for_bit(jx, name, args, kwargs, seeded):
    img = _imgs(1)[0]
    for image in (img, img.astype(np.float32) * 0.75 - 3.0):
        feature = {"image": image, "label": 3}
        want = _run(jx["img"], name, args, kwargs, feature, seeded)
        got = _run(timg, name, args, kwargs, feature, seeded)
        _same(got, want)


def test_flat_per_image_normalize_and_brightness_match_jax(jx):
    flat = np.full((4, 4, 3), 7, np.uint8)
    _same(timg.PerImageNormalize(0.5, 1.0).apply_image(flat),
          jx["img"].PerImageNormalize(0.5, 1.0).apply_image(flat))
    zeros = np.zeros((4, 4, 3), np.float32)
    _same(timg.ImageBrightness(10, 10).apply_image(zeros),
          jx["img"].ImageBrightness(10, 10).apply_image(zeros))


@pytest.mark.parametrize("prob", [0.0, 0.5, 1.0])
def test_random_preprocessing_and_chains_match_jax(jx, prob):
    img = _imgs(1)[0]

    def chain(mod):
        return mod.ChainedPreprocessing([
            mod.ImageRandomPreprocessing(mod.ImageResize(4, 4), prob=prob),
            mod.ImageRandomCrop(4, 4),
            mod.ImageColorJitter(),
            mod.ImageRandomFlip() > mod.ImageMatToTensor(),
            mod.ImageSetToSample(),
        ])

    outs = []
    for mod in (jx["img"], timg):
        random.seed(11)
        outs.append([chain(mod).transform({"image": img, "label": 1})
                     for _ in range(4)])
    _same(outs[1], outs[0])


def test_the_byte_and_row_transforms_match_jax(jx):
    img = _imgs(1, 8, 6)[0]
    raw = np.arange(2 * 3 * 3, dtype=np.uint8)
    png = _png(img)
    for make, feature in (
            (lambda m: m.ImagePixelBytesToMat(shape=(2, 3, 3)),
             {"bytes": raw.tobytes()}),
            (lambda m: m.ImagePixelBytesToMat(),
             {"bytes": raw.tobytes(), "shape": (2, 3, 3)}),
            (lambda m: m.ImageBytesToArray(), {"bytes": png}),
            (lambda m: m.ImageBytesToMat(), {"bytes": png}),
            (lambda m: m.ImageFeatureToTensor(), {"image": img}),
            (lambda m: m.ImageFeatureToSample(),
             {"image": img, "label": 2})):
        _same(make(timg).transform(dict(feature)),
              make(jx["img"]).transform(dict(feature)))
    row = {"image": png, "uri": "a.png", "label": 1}

    def pipe(m):
        return m.ChainedPreprocessing([
            m.RowToImageFeature(), m.ImageBytesToMat(), m.ImageResize(4, 4),
            m.ImageFeatureToSample()])
    _same(pipe(timg).transform(row), pipe(jx["img"]).transform(row))
    with pytest.raises(ValueError, match="shape"):
        timg.ImagePixelBytesToMat().transform({"bytes": raw.tobytes()})
    with pytest.raises(KeyError, match="no 'image' column"):
        timg.RowToImageFeature().transform({"uri": "a"})


def test_every_exported_name_is_there(jx):
    assert {n for n in dir(jx["img"]) if not n.startswith("_")} \
        <= {n for n in dir(timg) if not n.startswith("_")}
    for name in jx["img"].transforms.__all__:
        assert name in timg.transforms.__all__


def test_image_set_from_arrays_matches_jax(jx):
    imgs, labels = _imgs(), list(range(6))

    def run(mod):
        iset = mod.ImageSet.from_arrays(imgs, labels=labels, num_shards=2)
        pipe = mod.ChainedPreprocessing([
            mod.ImageResize(16, 16), mod.ImageCenterCrop(8, 8),
            mod.ImageChannelNormalize(123, 117, 104, 58, 57, 57),
            mod.ImageMatToTensor(), mod.ImageSetToSample()])
        out = iset.transform(pipe)
        return (out.get_image(), out.get_label(),
                [b for b in out.to_dataset().collect()],
                (iset | mod.ImageHFlip()).get_image())
    got, want = run(timg), run(jx["img"])
    _same(got, want)
    assert got[2][0]["x"].shape[1:] == (8, 8, 3) and "y" in got[2][0]


def test_image_set_read_with_label_matches_jax(jx, tmp_path):
    from PIL import Image
    for i, cls in enumerate(("cat", "dog")):
        d = tmp_path / cls
        d.mkdir()
        for j in range(2):
            Image.fromarray(_imgs(1, 12 + j, 10 + i, seed=i * 2 + j)[0]).save(
                d / f"{j}.png")
    Image.fromarray(_imgs(1, 9, 9, seed=9)[0]).save(tmp_path / "loose.png")
    for with_label in (True, False):
        got = timg.ImageSet.read(str(tmp_path), with_label=with_label)
        want = jx["img"].ImageSet.read(str(tmp_path), with_label=with_label)
        _same(got.get_image(), want.get_image())
        _same(got.get_label(), want.get_label())
        _same([f["uri"] for f in got._features()],
              [f["uri"] for f in want._features()])
    assert sorted(timg.ImageSet.read(str(tmp_path), with_label=True)
                  .get_label()) == [0, 0, 1, 1]
    one = timg.ImageSet.read(str(tmp_path / "loose.png"))
    assert one.get_image()[0].shape == (9, 9, 3)


@pytest.mark.parametrize("source", ["imagenet", "torchvision"])
@pytest.mark.parametrize("model", sorted(tic.PREPROCESS_CONFIGS))
def test_every_preset_is_jax_bit_for_bit(jx, model, source):
    img = (np.random.RandomState(0).rand(300, 280, 3) * 255).astype(
        np.uint8)
    got = tic.preprocessor(model, source).transform({"image": img})
    want = jx["ic"].preprocessor(model, source).transform({"image": img})
    _same(got, want)
    crop = 224 if source == "torchvision" else \
        tic.PREPROCESS_CONFIGS[model][1]
    assert got["image"].shape == (crop, crop, 3)


def test_preset_errors_match_jax(jx):
    assert tic.PREPROCESS_CONFIGS == jx["ic"].PREPROCESS_CONFIGS
    with pytest.raises(ValueError, match="no preprocessing preset"):
        tic.preprocessor("lenet")
    with pytest.raises(ValueError, match="unknown preprocessing source"):
        tic.preprocessor("resnet-50", source="caffe")


@pytest.mark.parametrize("prob_as_output,top_k", [(True, None),
                                                  (False, 2), (False, None),
                                                  (True, 1)])
def test_label_output_is_jax_bit_for_bit(jx, prob_as_output, top_k):
    label_map = {0: "cat", 1: "dog", 2: "fish"}
    preds = np.array([[0.2, 0.7, 0.1], [1.0, 3.0, 0.0], [0.1, 0.2, 5.0]],
                     np.float32)
    got = tic.LabelOutput(label_map, prob_as_output=prob_as_output)(
        preds, top_k=top_k)
    want = jx["ic"].LabelOutput(label_map, prob_as_output=prob_as_output)(
        preds, top_k=top_k)
    _same(got, want)
    one = tic.LabelOutput(label_map, clses="c", probs="p")(preds[0])
    assert one[0]["c"] == ["dog", "cat", "fish"]
    # an index outside the map is named by its number
    assert tic.LabelOutput({0: "cat"})(preds[:1])[0]["classes"] == \
        ["1", "cat", "2"]


def test_without_pil_decoding_raises_naming_pil(monkeypatch, tmp_path):
    png = _png(_imgs(1, 4, 4)[0])
    (tmp_path / "a.png").write_bytes(png)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="PIL"):
        timg.ImageBytesToArray().transform({"bytes": png})
    with pytest.raises(ImportError, match="PIL"):
        timg.ImageSet.read(str(tmp_path))
    img = _imgs(1)[0]
    out = tic.preprocessor("resnet-50", "torchvision").transform(
        {"image": img})["image"]
    assert out.shape == (224, 224, 3)
