"""Image records through the port's Cluster Serving, on the CPU.

An image record carries raw encoded bytes (``InputQueue.enqueue_image``
or ``enqueue(uri, image=bytes)``); the engine decodes it on the host and
runs its ``image_preprocess`` chain (a preset through ``image_pipeline``
or config.yaml's ``preprocessing:`` section) before batching. Held:

- PNG records (lossless, so the decode is exact) through a
  ``preprocessing:`` section and through a preset into an
  ``ImageClassifier``: each answer bitwise equal to ``predict`` of the
  decoded, preprocessed arrays at the batch it rode (the serve loop is
  driven turn by turn on the calling thread, one batch a turn);
- across packages: JAX's client into the port's engine and the port's
  client into JAX's engine, each answer equal to the same model on the
  preprocessed array, and the two directions equal;
- an undecodable image, and PIL hidden (``sys.modules["PIL"] = None``),
  each end as a typed error result naming the cause, and the next tensor
  record is answered; nothing falls back anywhere;
- ``ServingConfig``'s ``preprocessing:`` chains (explicit and preset)
  equal JAX's on an image (JAX tests/test_serving.py:655,664).

JAX is imported inside tests only.
"""

import io
import sys

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.models import ImageClassifier
from analytics_zoo_tpu_torch.serving import (Broker, ClusterServing,
                                             InputQueue, OutputQueue,
                                             schema)
from analytics_zoo_tpu_torch.serving.config import ServingConfig
from analytics_zoo_tpu_torch.serving.engine import image_pipeline

SECTION = ("model:\n  path: m\npreprocessing:\n  resize: 36\n  crop: 32\n"
           "  mean: 128.0,128.0,128.0\n  scale: 0.0078125\n")
PRESET = ("model:\n  path: m\npreprocessing:\n  preset: resnet-50\n"
          "  source: torchvision\n")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pngs(n, seed=0):
    """``n`` lossless PNGs of dogs-vs-cats-like aspect, and their arrays."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    raws, blobs = [], []
    for i in range(n):
        h, w = (48, 40) if i % 2 else (40, 52)
        raw = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(raw).save(buf, format="PNG")
        raws.append(raw)
        blobs.append(buf.getvalue())
    return raws, blobs


def _drive(eng, client, turns):
    """``turns`` serve-loop turns on the calling thread, then the drain."""
    pipe = eng._make_pipe()
    for _ in range(turns):
        eng._serve_once(client, pipe)
    for comp in pipe.drain():
        eng._finish(client, comp)


def _results(client, uris):
    return {u: schema.decode_result(raw) for u, raw in zip(
        uris, client.pipeline(("HGET", "result", u) for u in uris))}


def _cfg(tmp_path, text):
    p = tmp_path / "config.yaml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("how", ["section", "preset"])
def test_png_records_equal_predict_at_their_batch(tmp_path, how):
    """Two batches of 4: half the records by ``enqueue_image`` (bytes and
    a file path), half by ``enqueue(uri, image=bytes)``."""
    cfg = ServingConfig.load(_cfg(tmp_path, SECTION if how == "section"
                                  else PRESET))
    chain = cfg.build_image_preprocess()
    size = 32 if how == "section" else 224
    clf = ImageClassifier(3, "resnet-lite" if how == "section"
                          else "mobilenet", image_size=size)
    im = InferenceModel(device="cpu").load_zoo(clf)
    raws, blobs = _pngs(8)
    path = tmp_path / "img.png"
    path.write_bytes(blobs[0])
    batch = 4
    with Broker.launch(backend="python") as b:
        iq = InputQueue(port=b.port)
        uris = [iq.enqueue_image("r0", str(path))]
        uris += [iq.enqueue_image(f"r{i}", blobs[i]) for i in (1, 2, 3)]
        uris += [iq.enqueue(f"r{i}", image=blobs[i]) for i in range(4, 8)]
        eng = ClusterServing(im, b.port, batch_size=batch,
                             max_batch_size=batch, warmup=False, block_ms=0,
                             reclaim_interval_s=1e9, image_preprocess=chain)
        c = b.client()
        _drive(eng, c, 2)
        got = _results(c, uris)
        iq.close()
    x = np.stack([chain(np.asarray(r, np.float32)) for r in raws])
    assert x.shape == (8, size, size, 3)
    for lo in (0, batch):
        want = im.predict(x[lo:lo + batch], batch_size=batch)
        for i in range(lo, lo + batch):
            np.testing.assert_array_equal(got[f"r{i}"], want[i - lo])
    assert eng.metrics()["records_failed"] == 0


class _Mean:
    """A duck-typed model for both engines: each image's channel means
    and its corner pixel, in float64 (exact for the comparison)."""

    def predict(self, x):
        x = np.asarray(x, np.float64)
        return np.concatenate([x.mean(axis=(1, 2)), x[:, 0, 0]], axis=1)


def _cross(sender, engine_pkg, blobs):
    """Records from ``sender``'s client served by ``engine_pkg``'s engine
    with its own resnet-50 torchvision preset; the answers by uri."""
    if engine_pkg == "jax":
        from analytics_zoo_tpu.serving import broker as pkg_broker
        from analytics_zoo_tpu.serving import engine as pkg_engine
    else:
        from analytics_zoo_tpu_torch.serving import broker as pkg_broker
        from analytics_zoo_tpu_torch.serving import engine as pkg_engine
    if sender == "jax":
        from analytics_zoo_tpu.serving.client import InputQueue as IQ
    else:
        IQ = InputQueue
    b = pkg_broker.Broker.launch(backend="python")
    try:
        iq = IQ(port=b.port)
        uris = [iq.enqueue_image(f"c{i}", blob) for i, blob in
                enumerate(blobs)]
        eng = pkg_engine.ClusterServing(
            _Mean(), b.port, batch_size=2, max_batch_size=2, warmup=False,
            block_ms=0, reclaim_interval_s=1e9,
            image_preprocess=pkg_engine.image_pipeline(
                "resnet-50", source="torchvision"))
        c = b.client()
        _drive(eng, c, len(blobs) // 2)
        out = _results(c, uris)
        iq.close()
        return out
    finally:
        b.stop()


def test_clients_and_engines_cross_between_packages():
    raws, blobs = _pngs(4, seed=1)
    chain = image_pipeline("resnet-50", source="torchvision")
    want = _Mean().predict(np.stack([chain(np.asarray(r, np.float32))
                                     for r in raws]))
    jax_to_port = _cross("jax", "port", blobs)
    port_to_jax = _cross("port", "jax", blobs)
    for i in range(4):
        np.testing.assert_array_equal(jax_to_port[f"c{i}"], want[i])
        np.testing.assert_array_equal(port_to_jax[f"c{i}"], want[i])


class _Double:
    def predict(self, x):
        return np.asarray(x) * 2.0


@pytest.mark.parametrize("cause", ["undecodable", "no_pil"])
def test_bad_images_get_typed_errors_and_serving_goes_on(monkeypatch,
                                                         cause):
    _, blobs = _pngs(1)
    with Broker.launch(backend="python") as b:
        iq, oq = InputQueue(port=b.port), OutputQueue(port=b.port)
        if cause == "undecodable":
            bad = iq.enqueue("bad", image=b"not an image at all")
            pattern = "image decode failed"
        else:
            monkeypatch.setitem(sys.modules, "PIL", None)
            monkeypatch.setitem(sys.modules, "PIL.Image", None)
            bad = iq.enqueue_image("bad", blobs[0])
            pattern = "image decode failed.*PIL"
        ok = iq.enqueue("ok", x=np.arange(3, dtype=np.float32))
        eng = ClusterServing(_Double(), b.port, batch_size=2,
                             max_batch_size=2, warmup=False, block_ms=0,
                             reclaim_interval_s=1e9,
                             image_preprocess=image_pipeline("resnet-50"))
        c = b.client()
        _drive(eng, c, 2)
        with pytest.raises(schema.ServingError, match=pattern):
            oq.query(bad, timeout=5.0)
        np.testing.assert_array_equal(oq.query(ok, timeout=5.0),
                                      np.arange(3, dtype=np.float32) * 2)
        assert eng.metrics()["records_failed"] == 1
        assert c.xpending("serving_stream", "serving") == 0
        iq.close()
        oq.close()


@pytest.mark.parametrize("text", [SECTION, PRESET], ids=["section",
                                                          "preset"])
def test_config_chains_equal_jax(tmp_path, text):
    from analytics_zoo_tpu.serving.config import \
        ServingConfig as JServingConfig
    path = _cfg(tmp_path, text)
    img = np.full((300, 280, 3), 192.0, np.float32)
    img[::7] = 3.0
    got = ServingConfig.load(path).build_image_preprocess()(img)
    want = JServingConfig.load(path).build_image_preprocess()(img)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if text == SECTION:
        flat = ServingConfig.load(path).build_image_preprocess()(
            np.full((48, 40, 3), 192.0, np.float32))
        np.testing.assert_allclose(flat, (192 - 128) / 128, rtol=1e-5)
